"""The sharded runtime: ``build_comm``, ``build_train``/``TrainPack`` and
``build_serve``/``ServePack``.

Port of ``src/repro/launch/runtime.py:112-518`` (serving at the end of
this docstring).  Where the reference shard_maps the optimizer over the
worker axes of a device mesh, the port runs one rank per device: each rank builds its worker with a leading worker dim of 1
(the ``(1, rows, 1024)`` shard the reference's ``shard_map`` sees), and
where a worker spans several ranks (:func:`repro_torch.launch.mesh.
make_layout`) only its shards of the worker's leaves
(:mod:`repro_torch.launch.sharding`: TP over ``"model"``, profile B's
FSDP over ``"data"``), on which it runs its own kernel plan and its own
gossip with the ranks at its inner place in the neighbour workers.  A
rank's gradient is plain autograd over its one worker
(:func:`worker_grad_fn`): the worker dim squeezed, its slice of the
worker's batch taken where an axis splits the batch (FSDP's, or profile
A's ``inner="dp"`` axis; dim 1 when that axis divides it, else the whole
batch on every rank, as ``batch_spec_tree`` does), ``model.loss`` with
``run.parallel.remat`` (the rank's share of the worker's loss), then
``torch.autograd.grad``, the gradient of every leaf the rank holds whole
summed over the batch axis in f32 (FSDP's split leaves are summed in
their gather's backward), the loss summed likewise, the dim restored; the
TP and FSDP collectives and ``remat``'s recomputation run there, and none
runs under ``torch.func``.  Every rank draws x₀ from the same seed (the
paper's identical x₀); each draws its own worker's batches.

``TrainPack.train_round(params, state, batches, t)`` is p local steps and
one gossip round: the kernel round or the tree round, as
``optim.use_kernel`` says.  ``train_step(params, state, batch, t)`` is one
step, for a tail shorter than a round and for a resume off a round
boundary, with its gossip where step t ends a round: on the kernel layout
a one-step kernel round (so a tail launches what ``SimTrainer``'s does),
else (and with overlapped rounds, whose per-step form forms the stale
correction at every step) ``opt.step``.  Both take the host step ``t``:
the sharded comm picks round r's exchanges on the host, and the trainer
knows t.  The reference's ``make_shd`` hints change no value and have no
counterpart (``launch/sharding.py``).

``build_serve(run, mesh, shape)`` is a rank's serving pack on the serving
layout (``make_layout(..., serving=True)``: no axis gossips, TP over
``"model"``, FSDP over ``"data"`` under profile B, the batch over
``"pod"`` and ``"data"``).  The rank builds its model with its TP and
FSDP groups and its own shards of the params, and its ``prefill_step`` /
``decode_step`` run its rows of the batch (all of them where the batch
axes do not divide the batch) at ``max_len = shape.seq_len``, the MoE's
capacity the whole batch's; ``ServePack.gather`` puts the ranks' rows back
together and ``ServePack.generate`` runs the serving loop with every rank
sampling the whole batch's logits.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelCfg, RunCfg
from repro_torch.configs.shapes import InputShape, _batch_struct
from repro_torch.core import make_compressor, make_optimizer
from repro_torch.core.gossip import DenseComm, HierarchicalComm, ShardedComm
from repro_torch.core.topology import (disconnected, hierarchical,
                                       make_schedule, make_topology, torus)
from repro_torch.launch.mesh import Layout, make_layout
from repro_torch.launch.sharding import CachePlan, cache_spec_tree
from repro_torch.models import make_model
from repro_torch.models.layers import TPGroup
from repro_torch.tree import tree_map

__all__ = ["STATE_KEYS", "ServePack", "TrainPack", "axis_group", "build_comm",
           "build_serve", "build_train", "check_state_keys", "make_steps",
           "worker_grad_fn"]

# every optimizer state entry the checkpoint knows: True where the entry is
# worker-stacked (mirrors params), False where it is one scalar for all
# workers; "mix" is the overlapped rounds' DelayedMixState
STATE_KEYS = {"step": False, "m": True, "xhat": True, "c": True,
              "g_prev": True, "xprev": True, "xhat_nbrs": True}
MIX_KEYS = {"buf": True, "buf_c": True, "phase": False}


def check_state_keys(state) -> dict:
    """``{key: worker-stacked?}`` for every entry of an optimizer state
    (``mix`` as a dict of its own); a key the checkpoint does not know
    raises ``KeyError``, so an optimizer that grows a state entry fails
    here and not in a resume."""
    out = {}
    for k, v in state.items():
        if k == "mix":
            out[k] = {}
            for kk in v:
                if kk not in MIX_KEYS:
                    raise KeyError(f"mix/{kk}")
                out[k][kk] = MIX_KEYS[kk]
        elif k in STATE_KEYS:
            out[k] = STATE_KEYS[k]
        else:
            raise KeyError(k)
    return out


# --------------------------------------------------------------------- comm
def build_comm(run: RunCfg, layout: Layout, membership=None):
    """The topology (or schedule) and sharded comm of the worker layout.
    ``parallel.node_size > 0`` selects two-level gossip
    (:class:`HierarchicalComm`, the inner axis is the node on a two-axis
    layout); ``parallel.topology_schedule`` a time-varying graph."""
    waxes = layout.worker_axes
    sizes = layout.worker_sizes
    wd = run.optim.wire_dtype
    mesh = layout.mesh
    if not waxes:
        # profile B without a pod axis: the mesh is one worker
        return DenseComm(disconnected(1), device=mesh.device,
                         membership=membership, wire_dtype=wd)
    sched_name = run.parallel.topology_schedule
    node_size = int(run.parallel.node_size or 0)
    if node_size:
        K = int(layout.n_workers)
        if len(waxes) == 2:
            if node_size != sizes[1]:
                raise ValueError(
                    f"node_size {node_size} must equal the inner worker "
                    f"axis size {sizes[1]} on a two-axis layout {waxes}: "
                    "the node boundary is the mesh axis")
        elif K % node_size != 0:
            raise ValueError(f"node_size {node_size} does not divide the "
                             f"worker count {K}")
        n_nodes = K // node_size
        if sched_name in ("hier_one_peer", "hierarchical_one_peer"):
            first = make_schedule("hier_one_peer", (n_nodes, node_size))
        elif sched_name == "static":
            first = hierarchical(n_nodes, node_size,
                                 inter=run.parallel.topology)
        else:
            raise ValueError(
                f"topology_schedule {sched_name!r} does not compose with "
                "node_size (hierarchical rounds support 'static' and "
                "'hier_one_peer')")
        return HierarchicalComm(first, axis_names=waxes, mesh=mesh,
                                membership=membership, wire_dtype=wd,
                                inter_codec=_make_inter_codec(run))
    if sched_name != "static":
        sched = make_schedule(
            sched_name, sizes, base_topology=run.parallel.topology,
            rounds=run.parallel.schedule_rounds,
            seed=run.parallel.schedule_seed)
        return ShardedComm(sched, axis_names=waxes, mesh=mesh,
                           membership=membership, wire_dtype=wd)
    topo = (make_topology(run.parallel.topology, sizes) if len(waxes) == 1
            else torus(sizes))
    return ShardedComm(topo, axis_names=waxes, mesh=mesh,
                       membership=membership, wire_dtype=wd)


def _make_inter_codec(run: RunCfg):
    """The keyless codec of the hierarchical inter wire, from
    ``parallel.inter_codec`` (shape knobs shared with the compressor)."""
    from repro_torch.core.wire import make_codec
    name = str(run.parallel.inter_codec).lower()
    if name in ("none", ""):
        return None
    o = dataclasses.replace(run.optim, compressor=name)
    return make_codec(make_compressor(name, **_compressor_kwargs(o)))


def _compressor_kwargs(o) -> dict:
    """OptimCfg knobs → the named compressor's constructor args."""
    name = o.compressor.lower()
    if name == "sign":
        return {"block": o.compressor_block}
    if name == "topk":
        return {"fraction": o.compressor_fraction,
                "block": o.compressor_block}
    if name == "randk":
        return {"fraction": o.compressor_fraction}
    if name == "qsgd":
        return {"levels": o.compressor_levels, "block": o.compressor_block}
    if name in ("sparse", "sparse_rows") or name.startswith("sparse+"):
        return {"max_rows": o.compressor_rows, "levels": o.compressor_levels,
                "block": o.compressor_block}
    return {}


def _make_optimizer(run: RunCfg, comm):
    o = run.optim
    # CPD/CHOCO always ship a codec payload; MT ships its correction
    # through one only when asked (track_compressed)
    wants = (o.name.startswith(("cpd", "choco"))
             or (o.name.startswith("mt") and o.track_compressed))
    comp = make_compressor(o.compressor, **_compressor_kwargs(o)) \
        if wants else None
    return make_optimizer(o.name, comm, eta=o.eta, mu=o.mu, p=o.p,
                          gamma=o.gamma, weight_decay=o.weight_decay,
                          compressor=comp, use_kernel=o.use_kernel,
                          overlap=o.overlap)


# -------------------------------------------------------------------- train
@dataclasses.dataclass
class TrainPack:
    model: object
    opt: object
    layout: Layout
    device: torch.device
    params_struct: dict        # this rank's worker, (1, ...), meta tensors
    state_struct: dict
    state_keys: dict           # check_state_keys(state_struct)
    init_fn: Callable          # (seed) -> (params, opt_state)
    train_step: Callable       # (params, state, batch, t) -> (.., loss)
    train_round: Callable      # (params, state, batches[p], t) -> (.., losses)
    plan: object = None        # the shard plan (None: the rank holds
                               # its worker's leaves whole)
    worker_struct: dict = None  # the whole worker's params, (1, ...), meta
    worker_state_struct: dict = None
    grad_fn: Callable = None   # (params, batch) -> (loss, grads): the rank's

    def __post_init__(self):
        # a rank that holds its whole worker: the structs are the rank's
        if self.worker_struct is None:
            self.worker_struct = self.params_struct
            self.worker_state_struct = self.state_struct

    def worker_batch(self, batch: dict) -> dict:
        """This rank's worker of a batch drawn for all K workers (leading
        dim K): the dense stream's batches, worker by worker.  Every rank
        of a worker takes the worker's whole batch; the gradient takes
        the rank's slice of it (:func:`worker_grad_fn`)."""
        w = self.layout.worker_index
        return {k: v[w:w + 1] for k, v in batch.items()}


def build_train(run: RunCfg, mesh, model_cfg: Optional[ModelCfg] = None,
                membership=None) -> TrainPack:
    """The rank's training pack over the worker ``mesh``."""
    mcfg = model_cfg or run.model
    layout = make_layout(run.parallel, mesh)
    device = mesh.device
    model = make_model(mcfg, tp=axis_group(layout, layout.tp_axis),
                       fsdp=axis_group(layout, layout.fsdp_axis))
    comm = build_comm(run, layout, membership=membership)
    opt = _make_optimizer(run, comm)
    gfn = worker_grad_fn(model, run.parallel.remat,
                         batch=axis_group(layout, layout.batch_axis))

    def init_fn(seed: int):
        gen = torch.Generator(device=device).manual_seed(int(seed))
        params = {k: v.unsqueeze(0) for k, v in
                  model.init(gen, device=device).items()}
        return params, opt.init(params)

    def struct(whole: bool) -> dict:
        return {k: torch.empty((1,) + tuple(s), dtype=model.leaf_dtype(k),
                               device="meta")
                for k, s in model.param_shapes(whole=whole).items()}

    train_step, train_round = make_steps(opt, gfn)
    params_struct, worker_struct = struct(False), struct(True)
    state_struct = opt.init(params_struct)
    return TrainPack(model=model, opt=opt, layout=layout, device=device,
                     params_struct=params_struct, state_struct=state_struct,
                     state_keys=check_state_keys(state_struct),
                     init_fn=init_fn, train_step=train_step,
                     train_round=train_round, plan=model.plan,
                     worker_struct=worker_struct,
                     worker_state_struct=opt.init(worker_struct),
                     grad_fn=gfn)


def axis_group(layout: Layout, axis) -> Optional[TPGroup]:
    """The ``TPGroup`` of this rank's line over mesh ``axis`` (a name, or
    a tuple of names: the serving batch's axes); None without the axis,
    or where it holds one rank."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis or ())
    mesh = layout.mesh
    if not axes or mesh.size(axes) == 1:
        return None
    group = mesh.group(axes)
    return TPGroup(mesh.size(axes), mesh.index(axes),
                   lambda t, op: mesh.all_reduce(t, group, op),
                   lambda t, dim: mesh.all_gather(t, group, dim),
                   lambda t, dim: mesh.reduce_scatter(t, group, dim))


def _reduce_grads(grads: list, group: TPGroup) -> list:
    """``grads`` summed over ``group`` in f32: one ``all_reduce`` of their
    concatenation, cast back to each one's dtype."""
    if not grads:
        return grads
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    flat = group.all_reduce(flat, torch.distributed.ReduceOp.SUM)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
        at += g.numel()
    return out


def worker_grad_fn(model, remat: str = "none", batch=None):
    """The gradient of one worker with a leading worker dim of 1, in plain
    autograd: ``gfn(params, batch) -> (loss, grads)`` with the dim
    squeezed for ``model.loss`` (``remat`` passed on) and restored on the
    grads; a leaf the loss does not reach gets zeros, as
    ``torch.func.grad`` gives it.  ``batch``: the ``TPGroup`` of ranks
    that split the worker's batch (dim 1, where its size divides it): the
    rank takes its slice, its loss is its share of the worker's, and the
    gradients of the leaves it holds whole (every leaf but those the
    model gathers over FSDP, which sum in the gather) and the loss are
    summed over the group; the worker's loss and gradient are then a
    single rank's on the whole batch."""
    # the leaves the model gathers over FSDP: summed in the gather
    fsdp = ({n for n, d in model.plan.fsdp.items() if d is not None}
            if model.fsdp is not None else set())

    def gfn(params, batch_):
        b = {k: v[0] for k, v in batch_.items()}
        n = next(iter(b.values())).shape[0]
        split = batch is not None and n % batch.size == 0
        if split:
            m = n // batch.size
            b = {k: v[batch.index * m:(batch.index + 1) * m]
                 for k, v in b.items()}
        p = {k: v[0].detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            loss = model.loss(p, b, remat=remat,
                              inner=batch if split else None)[0]
            grads = list(torch.autograd.grad(loss, list(p.values()),
                                             materialize_grads=True))
        loss = loss.detach()
        if split:
            whole = [i for i, k in enumerate(p) if k not in fsdp]
            for i, g in zip(whole, _reduce_grads([grads[i] for i in whole],
                                                 batch)):
                grads[i] = g
            loss = batch.all_reduce(loss.to(torch.float32).clone(),
                                    torch.distributed.ReduceOp.SUM)
        return loss, {k: g.unsqueeze(0) for k, g in zip(p, grads)}
    return gfn


def make_steps(opt, gfn):
    """``(train_step, train_round)`` of ``opt`` with the gradient function
    ``gfn(params, batch) -> (loss, grads)``; each hands ``opt`` the host
    step first."""
    cfg = opt.config

    def train_step(params, state, batch, t: int):
        opt.host_step = int(t)
        if cfg.use_kernel and not cfg.overlap:
            params, state, losses = opt.round(
                state, params, gfn, {k: v[None] for k, v in batch.items()},
                gossip=(int(t) + 1) % cfg.p == 0)
            return params, state, losses[0]
        loss, grads = gfn(params, batch)
        params, state = opt.step(state, params, grads)
        return params, state, loss

    def train_round(params, state, batches, t: int):
        opt.host_step = int(t)
        return opt.round(state, params, gfn, batches)

    return train_step, train_round


def per_worker(struct) -> dict:
    """One worker's tree (the worker dim stripped), as meta tensors: what
    the optimizer's byte model reads."""
    return tree_map(lambda s: torch.empty(tuple(s.shape[1:]), dtype=s.dtype,
                                          device="meta"), struct)


# -------------------------------------------------------------------- serve
@dataclasses.dataclass
class ServePack:
    """A rank's serving pack (reference ``ServePack``).  ``params_struct``
    and ``cache_struct`` are this rank's params and cache as meta tensors,
    ``pre_struct`` the whole prompt batch's; ``cache_plan`` says which
    rows of the batch (``rows``) and which heads of the cache the rank
    holds.  ``prefill_step(params, batch)`` and ``decode_step(params,
    cache, tokens, pos)`` take and return the rank's rows; the logits are
    whole over the vocab."""
    model: object
    layout: Layout
    device: torch.device
    params_struct: dict
    cache_struct: dict
    pre_struct: dict
    cache_plan: CachePlan
    init_fn: Callable          # (seed) -> this rank's params
    prefill_step: Callable     # (params, batch) -> (logits, cache)
    decode_step: Callable      # (params, cache, tokens, pos) -> (.., cache)
    batch: int
    max_len: int
    batch_group: Optional[TPGroup] = None   # the ranks that split the batch

    @property
    def rows(self) -> slice:
        return self.cache_plan.rows(self.batch)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-batch tensor."""
        return t[self.rows]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole batch's ``t`` from every rank's rows (dim 0), on
        every rank; ``t`` itself where each rank holds the whole batch."""
        if self.batch_group is None:
            return t
        return self.batch_group.all_gather(t.contiguous(), 0)

    def generate(self, params: dict, prompt_tokens: torch.Tensor,
                 max_new: int, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        """The serving loop over this rank's rows of ``prompt_tokens`` (the
        whole batch, (b, s)), every rank sampling from the whole batch's
        logits: (b, s + max_new) int32 on every rank."""
        from repro_torch.serve.serving import decode_loop
        if prompt_tokens.shape[1] + max_new > self.max_len:
            raise ValueError(f"{prompt_tokens.shape[1]} + {max_new} "
                             f"positions past max_len {self.max_len}")
        return decode_loop(
            lambda: self.prefill_step(params,
                                      {"tokens": self.local(prompt_tokens)}),
            lambda cache, tok, pos: self.decode_step(params, cache, tok, pos),
            prompt_tokens, max_new, temperature, generator,
            whole=self.gather, local=self.local)


def build_serve(run: RunCfg, mesh, shape: InputShape,
                model_cfg: Optional[ModelCfg] = None) -> ServePack:
    """The rank's serving pack over ``mesh`` at ``shape``'s global batch
    and ``max_len = shape.seq_len``."""
    mcfg = model_cfg or run.model
    layout = make_layout(run.parallel, mesh, serving=True)
    device = mesh.device
    model = make_model(mcfg, tp=axis_group(layout, layout.tp_axis),
                       fsdp=axis_group(layout, layout.fsdp_axis))
    b, s = shape.global_batch, shape.seq_len
    plan = cache_spec_tree(mcfg, layout, b)
    group = (axis_group(layout, layout.batch_axes) if plan.batch_split
             else None)
    rows = plan.rows(b)

    def init_fn(seed: int) -> dict:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        return model.init(gen, device=device)

    def prefill_step(params, batch):
        return model.prefill_fast(params, batch, max_len=s, inner=group)

    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos,
                                 max_positions=s, inner=group)

    params_struct = {k: torch.empty(shape_, dtype=model.leaf_dtype(k),
                                    device="meta")
                     for k, shape_ in model.param_shapes().items()}
    return ServePack(
        model=model, layout=layout, device=device,
        params_struct=params_struct,
        cache_struct=model.init_cache(rows.stop - rows.start, s,
                                      device="meta"),
        pre_struct=_batch_struct(mcfg, b, s, with_labels=False),
        cache_plan=plan, init_fn=init_fn, prefill_step=prefill_step,
        decode_step=decode_step, batch=b, max_len=s, batch_group=group)
