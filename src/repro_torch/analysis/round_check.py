"""Round-contract checks on one executed round.

Port of ``src/repro/analysis/jaxpr_check.py``.  The reference walks a
``jax.make_jaxpr`` trace of the fused round; the port has no trace, so it
runs one round and records it:

* :class:`OpLog`, a ``TorchDispatchMode``, records every aten op of the
  round (its name, its tensors' shapes, dtypes and devices), and for an op
  that reads a device value on the host, the frames of the port that
  called it;
* :class:`~repro_torch.analysis.collectives.CommRecorder` records the
  collectives of a sharded round;
* :class:`RoundWatch` counts the calls of ``grads_fn``, the optimizer's
  updates (``local_step``/``local_step_mat``) and the kernel layout's
  ``KernelPlan.flatten``/``unflatten``/``leaf_table`` (the last the
  momentum launch's read of the gradient's leaves where they lie, in
  place of its flatten), so each op, collective and flatten
  knows the local step it ran in.

Each check of the reference has a counterpart that returns violation
strings (empty: the contract holds); :func:`require` raises them.  A round
is checked after one warm round from the same optimizer (the first builds
the device copies of the row counts and the receive buffers once per plan
geometry, as the reference's compile does): the checks hold the steady
state.  On a card the checked round also runs under
``torch.cuda.set_sync_debug_mode("error")``; the gloo-staged wire's
deliberate sync (``WorkerMesh._sync``) is the one site exempt.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Callable, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["ContractViolation", "OpLog", "RoundRecord", "RoundWatch",
           "check_dense_no_collectives", "check_gossip_boundary",
           "check_kernel_flatten_once", "check_membership_mask",
           "check_no_f64", "check_no_host_sync", "check_overlap_boundary",
           "check_round_contract", "check_round_steps",
           "check_schedule_switch", "kernel_launches", "require",
           "toy_batches", "toy_grads_fn", "toy_params", "trace_round",
           "traced_mixing_matrix"]

# ops that read a device value on the host: a round that holds one cannot
# run ahead of the card
HOST_SYNC_OPS = frozenset({"aten::_local_scalar_dense", "aten::nonzero"})
# ops that copy a tensor between devices (one that lands on the CPU from a
# device is a host sync)
COPY_OPS = frozenset({"aten::_to_copy", "aten::copy_"})
# the host reads that are allowed, by the innermost frame of the port that
# makes them (its file, and its function or None for any), and why
ALLOWED_SYNC_SITES = {
    ("repro_torch/kernels/ref.py", None): (
        "the plain versions run only on a CPU tensor (and shape-only on "
        "meta); row_scatter_ref's distinct-index check (ref.py:244) reads "
        "its indices on the host there, and on the card the kernel runs "
        "instead"),
    ("repro_torch/core/wire.py", "wire_key"): (
        "rand-k's coordinates are drawn by a host generator from the "
        "(leaf, round) key (RandKCodec.derive_idx), so on the dense backend, "
        "whose round index is a device tensor, the key reads it once a leaf "
        "a round; the sharded runtime passes the host round and reads "
        "nothing.  Removing it changes the coordinates (ROADMAP C.14)"),
}


def allowed_sync(site: str) -> str:
    """The reason a host read at ``site`` (innermost frame first) is
    allowed, or ""."""
    inner = site.split(" <- ")[0]
    path, _, rest = inner.partition(":")
    func = rest[rest.find("(") + 1:rest.rfind(")")] if "(" in rest else ""
    for (where, fn), why in ALLOWED_SYNC_SITES.items():
        if path == where and fn in (None, func):
            return why
    return ""


class ContractViolation(AssertionError):
    """One or more round-contract checks failed."""

    def __init__(self, violations: List[str]):
        self.violations = list(violations)
        super().__init__("\n".join(self.violations))


def require(violations: List[str]) -> None:
    """Raise :class:`ContractViolation` unless ``violations`` is empty."""
    if violations:
        raise ContractViolation(violations)


# ------------------------------------------------------------------ recording
@dataclasses.dataclass
class RoundWatch:
    """Where the round is: gradients begun, updates done, inside a
    gradient or not; and the kernel layout's flattens in order, each
    ``(kind, key, grads, updates)``: the key is the tree's id for a
    flatten and for a leaf table (kind ``"leaves"``: the tree handed to
    the momentum launch as it lies), and for an unflatten the matrix's id
    and whether it copies."""
    grads: int = 0
    updates: int = 0
    in_grad: bool = False
    flattens: list = dataclasses.field(default_factory=list)
    recorder: object = None

    def _sync(self):
        if self.recorder is not None:
            self.recorder.step = self.updates
            self.recorder.in_grad = self.in_grad

    def grads_fn(self, fn: Callable) -> Callable:
        """``fn`` counted: each call is one local step's gradient."""
        def counted(params, batch):
            self.grads += 1
            self.in_grad = True
            self._sync()
            try:
                return fn(params, batch)
            finally:
                self.in_grad = False
                self._sync()
        return counted

    @contextlib.contextmanager
    def watching(self, opt):
        """Count ``opt``'s updates and the plans' flattens inside the
        block (instance and class attributes restored on exit)."""
        from repro_torch.kernels.ops import KernelPlan
        saved = {}

        def updates(name):
            inner = getattr(opt, name)
            own = opt.__dict__.get(name)

            def wrapped(*a, **k):
                out = inner(*a, **k)
                self.updates += 1
                self._sync()
                return out
            saved[name] = own
            setattr(opt, name, wrapped)

        for name in ("local_step", "local_step_mat"):
            updates(name)
        flat, unflat = KernelPlan.flatten, KernelPlan.unflatten
        table = KernelPlan.leaf_table

        def flatten(plan, tree):
            self.flattens.append(("flatten", id(tree), self.grads,
                                  self.updates))
            return flat(plan, tree)

        def leaf_table(plan, tree):
            self.flattens.append(("leaves", id(tree), self.grads,
                                  self.updates))
            return table(plan, tree)

        def unflatten(plan, mat, dtype=None):
            # whether it copies: an unflatten into f32 is views of the
            # matrix (the overlapped round's next payload is the landed
            # matrix itself, read back as the params and as the payload)
            copies = any((dtype or s.dtype) != torch.float32
                         for s in plan.slots)
            self.flattens.append(("unflatten", (id(mat), copies),
                                  self.grads, self.updates))
            return unflat(plan, mat, dtype)

        KernelPlan.flatten, KernelPlan.unflatten = flatten, unflatten
        KernelPlan.leaf_table = leaf_table
        try:
            yield self
        finally:
            KernelPlan.flatten, KernelPlan.unflatten = flat, unflat
            KernelPlan.leaf_table = table
            for name, own in saved.items():
                if own is None:
                    delattr(opt, name)
                else:           # an instance's own override stays
                    setattr(opt, name, own)


def _port_frames() -> str:
    """The port's frames on the stack (innermost last), past this
    module."""
    out = []
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        if "repro_torch/" in path and "repro_torch/analysis/" not in path:
            out.append(f"{path[path.index('repro_torch/'):]}:{f.f_lineno}"
                       f" ({f.f_code.co_name})")
        f = f.f_back
    return " <- ".join(out[:4]) or "<outside the port>"


@dataclasses.dataclass(frozen=True)
class OpRecord:
    name: str
    ins: tuple          # ((shape, dtype, device type), ...) of tensor args
    outs: tuple
    grads: int
    updates: int
    in_grad: bool
    site: str = ""      # the port's frames, for a host read


def _sig(x) -> tuple:
    out = []
    for a in (x if isinstance(x, (list, tuple)) else (x,)):
        if isinstance(a, torch.Tensor):
            out.append((tuple(a.shape), str(a.dtype).removeprefix("torch."),
                        a.device.type))
        elif isinstance(a, (list, tuple)):
            out.extend(_sig(a))
    return tuple(out)


class OpLog(TorchDispatchMode):
    """Every aten op dispatched inside the block, in order, with the
    round's place from ``watch`` (a :class:`RoundWatch`, or None)."""

    def __init__(self, watch: Optional[RoundWatch] = None):
        super().__init__()
        self.watch = watch or RoundWatch()
        self.ops: List[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.name()
        ins = _sig(list(args) + list(kwargs.values()))
        outs = _sig(out)
        site = ""
        if name in HOST_SYNC_OPS or (
                name in COPY_OPS and _to_host(ins, outs)):
            site = _port_frames()
        w = self.watch
        self.ops.append(OpRecord(name, ins, outs, w.grads, w.updates,
                                 w.in_grad, site))
        return out

    def program(self) -> tuple:
        """The block's op program: each op's name and its tensors' shapes
        and dtypes, in order (:mod:`repro_torch.analysis.retrace`)."""
        return tuple((o.name, tuple(s[:2] for s in o.ins),
                      tuple(s[:2] for s in o.outs)) for o in self.ops)


def _to_host(ins, outs) -> bool:
    """A copy from a card (or meta) tensor that lands on the CPU."""
    src = {d for (_s, _t, d) in ins}
    dst = {d for (_s, _t, d) in outs}
    return bool(src - {"cpu"}) and "cpu" in dst


@dataclasses.dataclass
class RoundRecord:
    """One executed round: its ops, its collectives, its flattens, its
    gradient and update counts, any error the sync debug mode raised, and
    its outputs."""
    ops: List[OpRecord]
    calls: list
    watch: RoundWatch
    params_id: int
    sync_error: str = ""
    out: tuple = ()


# -------------------------------------------------------------------- checks
def check_no_host_sync(rec: RoundRecord) -> List[str]:
    """Zero host reads of a device value in the round (the counterpart of
    ``check_no_host_callbacks``): ``aten::_local_scalar_dense``
    (``.item()``), ``aten::nonzero``, and any copy of a device tensor to
    the CPU; on a card also whatever ``set_sync_debug_mode("error")``
    raised.  A read at a site of :data:`ALLOWED_SYNC_SITES` passes."""
    out = []
    for o in rec.ops:
        if not o.site:
            continue
        if allowed_sync(o.site):
            continue
        what = ("copy to the host" if o.name in COPY_OPS
                else f"host read `{o.name}`")
        out.append(f"{what} in the round (step {o.updates}, "
                   f"{'inside' if o.in_grad else 'outside'} the gradient) "
                   f"at {o.site}")
    if rec.sync_error:
        out.append(f"host sync under set_sync_debug_mode('error'): "
                   f"{rec.sync_error}")
    return out


def check_no_f64(rec: RoundRecord) -> List[str]:
    """Zero float64 inputs or outputs in the round's ops (the host-side
    spectral math of ``core/topology.py`` runs outside the round)."""
    out = []
    for o in rec.ops:
        for (shape, dtype, _dev) in o.ins + o.outs:
            if dtype == "float64":
                out.append(f"float64 operand {list(shape)} in `{o.name}` "
                           f"(step {o.updates})")
                break
    return out


def check_round_steps(rec: RoundRecord, p: int) -> List[str]:
    """Exactly p calls of ``grads_fn`` and p updates in the round (the
    counterpart of ``check_round_scan``)."""
    w = rec.watch
    if w.grads != p or w.updates != p:
        return [f"expected p={p} local steps in the round, found "
                f"{w.grads} gradient call(s) and {w.updates} update(s)"]
    return []


def _gossip_calls(rec: RoundRecord) -> list:
    return [c for c in rec.calls if not c.in_grad]


# the kinds of collective a round's exchange posts
GOSSIP_OPS = ("collective-permute", "all-reduce")


def check_gossip_boundary(rec: RoundRecord, p: int, *,
                          expected: Optional[int] = None) -> List[str]:
    """Every collective outside the gradient comes after the p-th step's
    update (the paper's one exchange a round, at its boundary), and only
    :data:`GOSSIP_OPS` kinds appear; ``expected`` pins the number of
    ``collective-permute`` sends (degree × arrays a round)."""
    out = []
    calls = _gossip_calls(rec)
    for c in calls:
        if c.step != p:
            out.append(f"collective `{c.op}` after step {c.step} of p={p} "
                       f"at {c.site}: gossip must happen once at the round "
                       "boundary")
        if c.op not in GOSSIP_OPS:
            out.append(f"unexpected collective `{c.op}` at {c.site} "
                       f"(allowed: {list(GOSSIP_OPS)})")
    if expected is not None:
        n = sum(1 for c in calls if c.op == "collective-permute")
        if n != expected:
            out.append(f"expected {expected} collective-permute send(s) a "
                       f"round, found {n}")
    return out


def check_overlap_boundary(rec: RoundRecord, p: int, *,
                           expected: Optional[int] = None) -> List[str]:
    """The overlapped round: every collective outside the gradient is
    posted before the first step (its payload does not depend on the
    round's steps), only :data:`GOSSIP_OPS` kinds appear, and
    ``expected`` pins the sends as in the synchronous round."""
    out = []
    calls = _gossip_calls(rec)
    for c in calls:
        if c.step != 0 or c.in_grad:
            out.append(f"collective `{c.op}` after step {c.step} of p={p} "
                       f"at {c.site}: an overlapped round posts every "
                       "exchange before its first step")
        if c.op not in GOSSIP_OPS:
            out.append(f"unexpected collective `{c.op}` at {c.site} "
                       f"(allowed: {list(GOSSIP_OPS)})")
    if expected is not None:
        n = sum(1 for c in calls if c.op == "collective-permute")
        if n != expected:
            out.append(f"expected {expected} collective-permute send(s) an "
                       f"overlapped round, found {n}")
    return out


def check_dense_no_collectives(rec: RoundRecord) -> List[str]:
    """A ``DenseComm`` round posts no collective: its gossip is a matmul
    or the gossip kernel over the stacked worker dim."""
    out = [f"collective `{o.name}` in a DenseComm round (step {o.updates})"
           for o in rec.ops if o.name.startswith("c10d")]
    out += [f"collective `{c.op}` in a DenseComm round at {c.site}"
            for c in rec.calls]
    return out


def check_kernel_flatten_once(rec: RoundRecord, p: int) -> List[str]:
    """The kernel layout flattens once: the params and each per-element
    state tree once at the round boundary, the gradient handed to the
    layout once a step (flattened, or read as leaves by PD's in-place
    momentum launch: a ``"leaves"`` event), and no matrix is
    copied out of the layout twice at the end (an unflatten into f32 is
    views; each step unflattens once, the views its gradient reads)."""
    out = []
    ev = rec.watch.flattens
    start = [i for (k, i, g, u) in ev if k == "flatten" and g == 0]
    if rec.params_id not in start:
        out.append("kernel round: the params are not flattened at the round "
                   "boundary (the round does not run on the kernel layout)")
    dup = sorted({i for i in start if start.count(i) > 1})
    if dup:
        out.append(f"kernel round: {len(dup)} tree(s) flattened more than "
                   "once at the round boundary"
                   + (" (the params among them)" if rec.params_id in dup
                      else ""))
    for s in range(1, p + 1):
        n = sum(1 for (k, _i, g, u) in ev
                if k in ("flatten", "leaves") and g == s and u == s - 1)
        if n != 1:
            out.append(f"kernel round: step {s} hands {n} tree(s) to the "
                       "layout (flattened or read as leaves), expected its "
                       "gradient once")
        v = sum(1 for (k, _i, g, u) in ev
                if k == "unflatten" and g == s - 1 and u == s - 1)
        if v > 1:
            out.append(f"kernel round: step {s} unflattens {v} times, "
                       "expected the one view its gradient reads")
    late = [i for (k, i, g, u) in ev
            if k in ("flatten", "leaves") and u == p]
    if set(late) & set(start) or len(set(late)) != len(late):
        out.append("kernel round: a tree flattened again after the steps")
    ends = [i for (k, i, g, u) in ev
            if k == "unflatten" and u == p and i[1]]
    if len(set(ends)) != len(ends):
        out.append("kernel round: a matrix copied out of the layout more "
                   "than once at the round's end")
    return out


# --------------------------------------------------------- dense mixing checks
def traced_mixing_matrix(comm, r: int) -> np.ndarray:
    """The (K, K) matrix the dense round-``r`` gossip applies, read by
    pushing identity probe leaves through the executed ``comm.mix`` (the
    computation, not the backend's weight tables), with ``r`` a 0-d device
    tensor as the round hands it (no host sync)."""
    K = comm.topology_at(r).n_workers
    probe = {"e": torch.eye(K, dtype=torch.float32, device=comm.device)}
    r = torch.tensor(int(r), device=comm.device)
    return comm.mix(probe, r=r)["e"].cpu().numpy()


def check_membership_mask(comm, rounds=None) -> List[str]:
    """Elastic membership on the executed dense mix, every round of the
    cycle (or ``rounds``): row-stochastic, a masked-out worker's row is
    e_k, and no active worker reads a masked-out worker's column."""
    ms = comm.membership
    if ms is None:
        return []
    out = []
    for r in (range(comm.round_cycle) if rounds is None else rounds):
        W = traced_mixing_matrix(comm, r)
        act = np.array(comm.active_at(r), dtype=bool)
        K = W.shape[0]
        for k in np.flatnonzero(np.abs(W.sum(axis=1) - 1.0) > 1e-5):
            out.append(f"round {r}: row {k} of the applied mixing matrix "
                       f"sums to {W[k].sum():.6f}, not 1 (renormalization "
                       "over live peers broken)")
        for k in np.flatnonzero(~act):
            if np.abs(W[k] - np.eye(K)[k]).max() > 1e-6:
                out.append(f"round {r}: masked-out worker {k} still "
                           "gossips (row != e_k)")
        dead = W[np.ix_(act, ~act)]
        if dead.size and np.abs(dead).max() > 1e-6:
            i, j = np.unravel_index(np.abs(dead).argmax(), dead.shape)
            out.append(f"round {r}: active worker {np.flatnonzero(act)[i]} "
                       f"reads weight {dead[i, j]:.6f} from masked-out "
                       f"worker {np.flatnonzero(~act)[j]} (dead column must "
                       "be zero)")
    return out


def check_schedule_switch(comm, period: int) -> List[str]:
    """Under a topology schedule the dense round applies ``period``
    distinct matrices over one period, each chosen on the device by
    ``r mod T`` (no host read in the selection)."""
    with OpLog() as log:
        mats = [traced_mixing_matrix(comm, r) for r in range(period)]
    reads = [o for o in log.ops if o.site and o.name in HOST_SYNC_OPS]
    out = []
    if reads:
        out.append(f"schedule selection reads the round on the host: "
                   f"{reads[0].name} at {reads[0].site}")
    distinct = []
    for W in mats:
        if not any(np.allclose(W, D, atol=1e-7) for D in distinct):
            distinct.append(W)
    if len(distinct) != period:
        out.append(f"schedule of period {period} applies {len(distinct)} "
                   "distinct matrices over one period")
    return out


# ----------------------------------------------------------------- the round
def toy_params(n_workers: int, sizes=(1500, 96), device="cpu") -> dict:
    """A tiny worker-stacked param dict (f32 zeros)."""
    return {f"w{i}": torch.zeros((n_workers, s), dtype=torch.float32,
                                 device=device)
            for i, s in enumerate(sizes)}


def toy_batches(p: int, n_workers: int, device="cpu") -> dict:
    return {"x": torch.zeros((p, n_workers, 4), dtype=torch.float32,
                             device=device)}


def toy_grads_fn(params, batch):
    """loss and grads of something cheap and f32-pure."""
    loss = sum((l * l).sum() for l in params.values())
    grads = {k: l + batch["x"].mean() for k, l in params.items()}
    return loss.to(torch.float32), grads


def kernel_launches() -> dict:
    """Each kernel wrapper's launch counter, by name."""
    from repro_torch.kernels import gossip_mix, momentum
    from repro_torch.kernels import qsgd_quant as qq
    from repro_torch.kernels import row_gather as rg
    from repro_torch.kernels import sign_compress as sc
    from repro_torch.kernels import topk_select as tk
    fns = (momentum.momentum_update, gossip_mix.gossip_mix, sc.sign_pack,
           sc.sign_unpack, qq.qsgd_quant, qq.qsgd_dequant, tk.topk_select,
           tk.topk_scatter, rg.row_gather, rg.row_scatter)
    return {f.__name__: f.launches for f in fns}


@contextlib.contextmanager
def _sync_debug(on: bool):
    if not on:
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def trace_round(opt, params, state, batches, *, round_fn=None,
                grads_fn: Callable = toy_grads_fn, mesh=None,
                loopback: bool = False,
                sync_debug: bool = False) -> RoundRecord:
    """Run one round of ``opt`` from ``params``/``state`` and record it.
    ``round_fn(params, state, grads_fn, batches)`` is the round
    (``opt.round`` by default; the sharded runtime's ``train_round``
    through :func:`repro_torch.launch.runtime.make_steps`); ``mesh``: the
    worker mesh whose collectives to record (``loopback``: completed
    locally, :class:`~repro_torch.analysis.collectives.CommRecorder`);
    ``sync_debug``: run under
    ``set_sync_debug_mode("error")`` (a card)."""
    from repro_torch.analysis.collectives import CommRecorder
    if round_fn is None:
        def round_fn(pr, st, gf, b):
            return opt.round(st, pr, gf, b)
    watch = RoundWatch()
    rec_cm = CommRecorder(mesh, loopback) if mesh is not None else \
        contextlib.nullcontext()
    err = ""
    with rec_cm as rec, watch.watching(opt):
        watch.recorder = rec
        with OpLog(watch) as log:
            try:
                with _sync_debug(sync_debug):
                    out = round_fn(params, state, watch.grads_fn(grads_fn),
                                   batches)
            except RuntimeError as e:
                if "synchroniz" not in str(e):
                    raise
                err, out = str(e).splitlines()[0], ()
    calls = list(rec.calls) if rec is not None else []
    return RoundRecord(log.ops, calls, watch, id(params), err, out)


def check_round_contract(opt, params, *, kernel: bool = False,
                         schedule_period: Optional[int] = None,
                         sync_debug: bool = False) -> List[str]:
    """Every check that applies to one ``DenseComm`` round of ``opt`` from
    ``params`` (worker-stacked), after a warm round: the steps, no host
    sync, no f64, no collective (an overlapped round's too: stricter than
    the sharded boundary); on the kernel layout the flatten-once checks;
    under a schedule the switch; under membership the mask."""
    p = opt.config.p
    K = next(iter(params.values())).shape[0]
    dev = next(iter(params.values())).device
    batches = toy_batches(p, K, dev)
    state = opt.init(params)
    params, state, _ = opt.round(state, params, toy_grads_fn, batches)
    rec = trace_round(opt, params, state, batches, sync_debug=sync_debug)
    out = []
    out += check_no_host_sync(rec)
    out += check_round_steps(rec, p)
    out += check_no_f64(rec)
    out += check_dense_no_collectives(rec)
    if kernel:
        out += check_kernel_flatten_once(rec, p)
    if schedule_period is not None:
        out += check_schedule_switch(opt.comm, schedule_period)
    if opt.comm.membership is not None:
        out += check_membership_mask(opt.comm)
    return out
