"""Rank-side scenarios of ``tests/test_torch_sharded.py`` and
``tests/test_torch_checkpoint.py``: each function runs in every gloo rank
on the CPU (spawned by ``repro_torch.launch.spawn.spawn_ranks``), drives
the port's sharded backend on numpy inputs handed over by the test, and
returns numpy results for the test process to hold against the
reference.  Imports nothing of JAX, so a rank starts in seconds."""
import contextlib
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelCfg, OptimCfg, ParallelCfg, RunCfg
from repro_torch.core import (CPDSGDM, CPDSGDMConfig, QSGDCompressor,
                              RandKCompressor, SignCompressor, make_compressor,
                              make_optimizer, make_schedule, make_topology,
                              membership_from_events, ring, torus)
from repro_torch.core.gossip import HierarchicalComm, ShardedComm
from repro_torch.core.topology import hierarchical
from repro_torch.core.wire import IdentityCodec, make_codec
from repro_torch.launch.mesh import INNER_TAG, make_mesh
from repro_torch.launch.runtime import build_train
from repro_torch.train.trainer import ShardedTrainer

CHURN = ((0, "kill", 3), (1, "straggle", 6), (2, "revive", 3))
TINY = dict(name="tiny-lm", arch_type="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab=64)


@contextlib.contextmanager
def isend_bytes():
    """Count the bytes handed to ``isend`` through
    ``dist.batch_isend_irecv`` by the gossip while the block runs:
    ``box["n"]`` (the collectives inside a worker, under ``INNER_TAG``,
    are not the wire between workers)."""
    orig = dist.batch_isend_irecv
    box = {"n": 0}

    def counted(ops):
        for op in ops:
            if op.op is dist.isend and op.tag != INNER_TAG:
                box["n"] += op.tensor.numel() * op.tensor.element_size()
        return orig(ops)
    dist.batch_isend_irecv = counted
    try:
        yield box
    finally:
        dist.batch_isend_irecv = orig


def mine(tree, rank):
    """This rank's worker of K-stacked numpy leaves, as (1, ...) tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(v[rank:rank + 1]))
            for k, v in tree.items()}


def np_tree(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}



def np_state(state):
    """A nested state dict as numpy, structure kept."""
    if isinstance(state, dict):
        return {k: np_state(v) for k, v in state.items()}
    return state.detach().numpy().copy()


def payload_of(x, rank):
    """A codec-shaped payload of this rank's worker: u8 bits, i32
    indices, f32 scales."""
    return {"bits": (x["w"][..., :128] > 0).to(torch.uint8),
            "idx": torch.arange(4, dtype=torch.int32)[None] + 10 * rank,
            "scales": x["b"]}


def quad_loss(p, b):
    """The smooth model: a least-squares fit, ``0.5·mean((x·w + b − y)²)``."""
    r = b["x"] @ p["w"] + p["b"] - b["y"]
    return 0.5 * torch.mean(r * r)


def _grads_fn():
    grad = torch.func.vmap(torch.func.grad_and_value(quad_loss))

    def gfn(params, batch):
        g, losses = grad(params, batch)
        return losses.mean(), g
    return gfn


MESHES = {"ring": ((8,), ("w",)), "exp": ((8,), ("w",)),
          "torus": ((2, 4), ("a", "b")), "hier_flat": ((8,), ("w",)),
          "hier_2axis": ((2, 4), ("node", "member"))}


def _comm(kind, meshes, wire="float32", membership=None, codec=None):
    if kind == "ring":
        return ShardedComm(ring(8), axis_names=("w",), mesh=meshes["ring"],
                           wire_dtype=wire, membership=membership)
    if kind == "exp":
        return ShardedComm(make_topology("exponential", (8,)),
                           axis_names=("w",), mesh=meshes["ring"],
                           wire_dtype=wire)
    if kind == "torus":
        return ShardedComm(torus((2, 4)), axis_names=("a", "b"),
                           mesh=meshes["torus"], wire_dtype=wire)
    if kind == "onepeer":
        return ShardedComm(make_schedule("one_peer_exp", (8,)),
                           axis_names=("w",), mesh=meshes["ring"])
    if kind in ("hier_flat", "hier_2axis"):
        names = ("w",) if kind == "hier_flat" else ("node", "member")
        mesh = meshes["ring"] if kind == "hier_flat" else meshes["torus2"]
        return HierarchicalComm(hierarchical(2, 4), axis_names=names,
                                mesh=mesh, wire_dtype=wire,
                                inter_codec=codec)
    raise ValueError(kind)


def _codec(name):
    return {"none": None, "identity": IdentityCodec(),
            "sign": make_codec(SignCompressor(block=1024)),
            "qsgd": make_codec(QSGDCompressor(levels=7, block=1024))}[name]


def sharded_scenarios(mesh_rank, inp):
    """Every K = 8 scenario of ``test_torch_sharded.py`` in one set of
    ranks: the mixes (with their isend bytes), the kernel and tree rounds
    of each optimizer family, the refusals."""
    rank, world, dev = mesh_rank
    meshes = {"ring": make_mesh((8,), ("w",), device=dev),
              "torus": make_mesh((2, 4), ("a", "b"), device=dev),
              "torus2": make_mesh((2, 4), ("node", "member"), device=dev)}
    x = mine(inp["x"], rank)
    out = {"mix": {}, "bytes": {}, "reduced": {}, "rounds": {},
           "refused": {}}

    def record(label, comm, fn):
        comm.reduced_bytes = 0
        with isend_bytes() as box:
            y = fn()
        out["bytes"][label] = box["n"]
        out["reduced"][label] = comm.reduced_bytes
        out["mix"][label] = (np_tree(y) if isinstance(y, dict)
                             else y.numpy().copy())

    # the raw exchanges: a codec-shaped payload keeps its dtypes; the
    # committed one prunes the edges from sources that do not commit
    comm = _comm("ring", meshes)
    pay = payload_of(x, rank)
    with isend_bytes() as box:
        got = comm.receive_payload(pay, 0, 1)
    out["raw"] = {"payload": np_tree(got), "payload_bytes": box["n"],
                  "views": {sh: np_tree(v) for (_ax, sh), v in
                            comm.shift_views(x).items()}}
    with isend_bytes() as box:
        got = comm.receive_payload_committed(pay, 0, -1, inp["source_ok"])
    out["raw"]["committed"] = np_tree(got)
    out["raw"]["committed_bytes"] = box["n"]

    for kind in ("ring", "torus", "exp"):
        for wire in ("float32", "bfloat16"):
            comm = _comm(kind, meshes, wire)
            record(f"{kind}/{wire}", comm, lambda: comm.mix(x))
    comm = _comm("onepeer", meshes)
    for r in range(3):
        record(f"onepeer/r{r}", comm, lambda: comm.mix(x, r=r))
    memb = membership_from_events(8, 3, CHURN)
    comm = _comm("ring", meshes, membership=memb)
    for r in range(3):
        record(f"churn/r{r}", comm, lambda: comm.mix(x, r=r))
        record(f"churn_stale/r{r}", comm, lambda: comm.stale_mix(x, r=r))
    # the hierarchical graphs: the tree mix and the kernel layout's mix_mat
    mat = torch.from_numpy(np.ascontiguousarray(inp["mat"][rank:rank + 1]))
    plan = _Plan(inp["used"], mat.shape[-2])
    for kind in ("hier_flat", "hier_2axis"):
        for codec in ("none", "identity", "sign", "qsgd"):
            comm = _comm(kind, meshes, codec=_codec(codec))
            record(f"{kind}/{codec}", comm, lambda: comm.mix(x))
            record(f"{kind}/{codec}/mat", comm,
                   lambda: comm.mix_mat(mat, plan=plan))
        comm = _comm(kind, meshes, wire="bfloat16")
        record(f"{kind}/bf16", comm, lambda: comm.mix(x))

    # the optimizer families' rounds on the smooth model
    for label, (kind, name, kw) in inp["families"].items():
        kw = dict(kw)
        wire = kw.pop("wire", "float32")
        memb = membership_from_events(8, 3, CHURN) if kind == "churn" \
            else None
        comm = _comm("ring" if kind == "churn" else kind, meshes, wire,
                     membership=memb)
        opt = make_optimizer(name, comm, **kw)
        params = mine(inp["q_params"], rank)
        state = opt.init(params)
        gfn = _grads_fn()
        p = opt.config.p
        with isend_bytes() as box:
            for rnd in range(inp["rounds"]):
                t = rnd * p
                opt.host_step = t
                batches = {k: torch.from_numpy(np.ascontiguousarray(
                    v[t:t + p, rank:rank + 1])) for k, v in
                    inp["q_batches"].items()}
                params, state, _ = opt.round(state, params, gfn, batches)
        out["rounds"][label] = {"params": np_tree(params),
                                "bytes": box["n"]}

    # refusals: the reference's, for CPD-SGDM and MT's compressed tracking
    from repro_torch.core import MTDSGDMConfig, MTDSGDm, complete
    from repro_torch.launch.mesh import make_layout
    tp_mesh = make_mesh((4,), ("w",), device=dev, model_axis=2)

    def mt(comm):
        return MTDSGDm(MTDSGDMConfig(), comm, SignCompressor())
    checks = {
        "cpd_overlap": lambda: CPDSGDM(CPDSGDMConfig(overlap=True),
                                       _comm("ring", meshes)),
        "cpd_complete": lambda: CPDSGDM(CPDSGDMConfig(), ShardedComm(
            complete(8), axis_names=("w",), mesh=meshes["ring"])),
        "cpd_hier": lambda: CPDSGDM(CPDSGDMConfig(),
                                    _comm("hier_flat", meshes)),
        "cpd_schedule": lambda: CPDSGDM(CPDSGDMConfig(),
                                        _comm("onepeer", meshes)),
        "cpd_perm_membership": lambda: CPDSGDM(CPDSGDMConfig(), ShardedComm(
            make_schedule("random_matching", (8,)).at(0), axis_names=("w",),
            mesh=meshes["ring"],
            membership=membership_from_events(8, 3, CHURN))),
        "mt_hier": lambda: mt(_comm("hier_flat", meshes)),
        "mt_complete": lambda: mt(ShardedComm(
            complete(8), axis_names=("w",), mesh=meshes["ring"])),
        "mt_schedule": lambda: mt(_comm("onepeer", meshes)),
        "randk_inter": lambda: _comm(
            "hier_flat", meshes,
            codec=make_codec(RandKCompressor(fraction=0.1))),
        "membership_2axis": lambda: ShardedComm(
            torus((2, 4)), axis_names=("a", "b"), mesh=meshes["torus"],
            membership=membership_from_events(8, 3, CHURN)),
        "sharded_r_tensor": lambda: _comm("onepeer", meshes).mix(
            x, r=torch.tensor(1)),
    }
    for k, fn in checks.items():
        try:
            fn()
            out["refused"][k] = None
        except (ValueError, NotImplementedError, TypeError) as err:
            out["refused"][k] = f"{type(err).__name__}: {err}"
    # what a worker of several ranks takes: profile B (2 pods × FSDP 2 ×
    # TP 2) and inner="dp" on 4 workers × a model axis of 2, each built
    # and run for a step; a mesh axis profile B gives no role is refused
    b_mesh = make_mesh((2, 2), ("pod", "data"), device=dev, model_axis=2)
    accepted = {"model_axis": (ParallelCfg(profile="B"), b_mesh),
                "model_axis_inner_dp": (ParallelCfg(inner="dp"), tp_mesh)}
    out["accepted"] = {}
    for k, (par, mesh) in accepted.items():
        run = RunCfg(model=ModelCfg(**TINY), parallel=par,
                     optim=OptimCfg(name="pd_sgdm", p=2))
        pack = build_train(run, mesh)
        lay = pack.layout
        params, state = pack.init_fn(0)
        gen = torch.Generator().manual_seed(3)
        batch = {"tokens": torch.randint(0, 64, (1, 2, 8), generator=gen),
                 "labels": torch.randint(0, 64, (1, 2, 8), generator=gen)}
        _, _, loss = pack.train_step(params, state, batch, 0)
        out["accepted"][k] = ((lay.worker_axes, lay.tp_axis, lay.fsdp_axis,
                               lay.inner_axis), float(loss))
    try:
        make_layout(ParallelCfg(profile="B"), tp_mesh)
        out["refused"]["model_axis_no_role"] = None
    except ValueError as err:
        out["refused"]["model_axis_no_role"] = f"ValueError: {err}"
    return out


def codec_family_opt(kind, name, kw, meshes):
    """The optimizer of one codec family of ``test_torch_sharded_cpd.py``
    on its sharded comm: ``kw`` as ``make_optimizer`` takes it, with the
    compressor as ``(name, knobs)`` and ``packed_wire=False`` for CPD's
    full-precision q."""
    kw = dict(kw)
    spec = kw.pop("compressor", None)
    comp = make_compressor(spec[0], **spec[1]) if spec else None
    packed = kw.pop("packed_wire", True)
    memb = membership_from_events(8, 3, CHURN) if kind == "churn" else None
    comm = _comm("ring" if kind == "churn" else kind, meshes,
                 membership=memb)
    if not packed:
        return CPDSGDM(CPDSGDMConfig(packed_wire=False, **kw), comm, comp)
    return make_optimizer(name, comm, compressor=comp, **kw)


def codec_scenarios(mesh_rank, inp):
    """Every family of ``test_torch_sharded_cpd.py`` in one set of eight
    ranks: each round's params and state (x̂ and the copies) and the bytes
    handed to ``isend`` over the rounds."""
    rank, world, dev = mesh_rank
    meshes = {"ring": make_mesh((8,), ("w",), device=dev)}
    out = {}
    gfn = _grads_fn()
    for label, (kind, name, kw) in inp["families"].items():
        opt = codec_family_opt(kind, name, kw, meshes)
        params = mine(inp["params"], rank)
        state = opt.init(params)
        p = opt.config.p
        per_round = []
        with isend_bytes() as box:
            for rnd in range(inp["rounds"]):
                t = rnd * p
                opt.host_step = t
                batches = {k: torch.from_numpy(np.ascontiguousarray(
                    v[t:t + p, rank:rank + 1])) for k, v in
                    inp["batches"].items()}
                params, state, _ = opt.round(state, params, gfn, batches)
                per_round.append((np_tree(params), np_state(state)))
        out[label] = {"rounds": per_round, "bytes": box["n"]}
    return out


class _Plan:
    """The two fields ``mix_mat`` reads of a ``KernelPlan``."""

    def __init__(self, used, rows):
        self.used_rows, self.rows = int(used), int(rows)

    def pad_wire(self, mat):
        return torch.nn.functional.pad(mat, (0, 0, 0,
                                             self.rows - mat.shape[-2]))


# ---------------------------------------------------------------- resume
def _run(opt_name, **kw):
    par = ParallelCfg(profile="A", remat="none",
                      topology_schedule=kw.pop("schedule", "static"))
    return RunCfg(model=ModelCfg(**TINY), parallel=par,
                  optim=OptimCfg(name=opt_name, eta=0.05, mu=0.9, p=2,
                                 weight_decay=1e-4, **kw))


def resume_scenarios(mesh_rank, cases):
    """For each case: an unbroken run, and runs checkpointed at the given
    steps and resumed in the same ranks, through ``ShardedTrainer``; the
    final params and state of each, as numpy."""
    from repro_torch.data.synthetic import LMStreamCfg, lm_batch
    rank, world, dev = mesh_rank
    mesh = make_mesh((world,), ("w",), device=dev)
    out = {}
    for label, (opt_name, kw, steps, stops) in cases.items():
        pack = build_train(_run(opt_name, **dict(kw)), mesh)
        data = LMStreamCfg(vocab=TINY["vocab"], seq_len=8, batch=2,
                           n_workers=world)

        def batch_fn(t):
            return pack.worker_batch(lm_batch(data, t, dev))

        a = ShardedTrainer(pack).train(0, batch_fn, steps, log_every=4,
                                       verbose=False)
        res = {"unbroken": (np_tree(a["params"]), np_state(a["state"]))}
        for stop in stops:
            d = tempfile.mkdtemp(prefix="ck_") if rank == 0 else None
            box = [d]
            dist.broadcast_object_list(box, src=0)
            d = box[0]
            ShardedTrainer(pack, ckpt_dir=d, ckpt_every=stop).train(
                0, batch_fn, stop, log_every=4, verbose=False)
            b = ShardedTrainer(pack, ckpt_dir=d).train(
                0, batch_fn, steps, log_every=4, verbose=False, resume=True)
            res[stop] = (np_tree(b["params"]), np_state(b["state"]),
                         b["steps_run"], b["history"].steps[:1])
        out[label] = res
    return out


def elastic_resume(mesh_rank, ckpt_dir, opt_name="pd_sgdm", kw=None):
    """Resume a K-worker checkpoint in these K′ ranks (a tiny LM of
    ``opt_name``) and return this rank's restored worker."""
    rank, world, dev = mesh_rank
    mesh = make_mesh((world,), ("w",), device=dev)
    pack = build_train(_run(opt_name, **dict(kw or {})), mesh)
    trainer = ShardedTrainer(pack, ckpt_dir=ckpt_dir)
    from repro_torch.checkpoint import latest_step
    params, state = trainer._restore(latest_step(ckpt_dir))
    return np_tree(params), np_state(state)


def write_checkpoint(mesh_rank, ckpt_dir, steps, opt_name="pd_sgdm",
                     kw=None):
    """A tiny-LM run of ``opt_name`` for ``steps`` steps that checkpoints
    at its end; returns this rank's final worker."""
    from repro_torch.data.synthetic import LMStreamCfg, lm_batch
    rank, world, dev = mesh_rank
    mesh = make_mesh((world,), ("w",), device=dev)
    pack = build_train(_run(opt_name, **dict(kw or {})), mesh)
    data = LMStreamCfg(vocab=TINY["vocab"], seq_len=8, batch=2,
                       n_workers=world)
    out = ShardedTrainer(pack, ckpt_dir=ckpt_dir, ckpt_every=steps).train(
        0, lambda t: pack.worker_batch(lm_batch(data, t, dev)), steps,
        log_every=4, verbose=False)
    return np_tree(out["params"]), np_state(out["state"])
