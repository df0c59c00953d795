"""Rank-side scenarios of ``tests/test_torch_fsdp.py``: each function runs
in every gloo rank on the CPU (spawned by
``repro_torch.launch.spawn.spawn_ranks``), drives the port's sharded
runtime with a worker split over several ranks (profile B's FSDP × TP, or
profile A's ``inner="dp"``) on numpy inputs handed over by the test, and
returns numpy results for the test process to hold against the reference
and against one rank per worker.  Imports nothing of JAX."""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelCfg, OptimCfg, ParallelCfg, RunCfg
from repro_torch.configs.registry import ARCHS, get_smoke_config
from repro_torch.configs.shapes import train_batch_arrays
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.runtime import build_train, per_worker
from repro_torch.models import moe as moe_lib
from repro_torch.train.trainer import ShardedTrainer

from torch_sharded_ranks import isend_bytes, np_state, np_tree
from torch_tp_ranks import _mine, _tmpdir, _torch, _watch, _whole

PODS, DATA, MODEL = 2, 2, 2


def profile_b_mesh(dev, pods=PODS, data=DATA, model=MODEL):
    """Profile B's mesh: ``pods`` workers, each ``data × model`` ranks."""
    return make_mesh((pods, data), ("pod", "data"), device=dev,
                     model_axis=model)


def own_run(arch, **model):
    """``arch``'s smoke config under its own parallel config (remat none)
    with PD-SGDM at p = 2 on the kernel layout; ``model`` overrides
    fields of the model config."""
    run = get_smoke_config(arch)
    return dataclasses.replace(
        run, model=dataclasses.replace(run.model, **model),
        parallel=dataclasses.replace(run.parallel, remat="none"),
        optim=OptimCfg(name="pd_sgdm", eta=0.05, mu=0.9, p=2,
                       weight_decay=1e-4, use_kernel=True))


def _batch_fn(pack, run, seed, batch, seq=8):
    K = pack.layout.n_workers

    def fn(t):
        gen = torch.Generator().manual_seed(seed + t)
        return pack.worker_batch(train_batch_arrays(
            run.model, K, batch, seq, gen, device=pack.device))
    return fn


def moe_calls(run) -> int:
    """The MoE dispatches of one step's forward."""
    m = run.model
    return sum("moe" in s.ffn for s in m.pattern) * m.n_repeats


def kept_table(meta, k: int, n_experts: int):
    """A dispatch's kept slots as a (tokens, E) bool table: True where a
    token's slot in expert e was kept.  ``meta`` is ``dispatch``'s or
    ``dispatch_rank``'s, each (G, n·k) in the sorted slot order."""
    sorted_e, _, tok, _, keep = (t.detach().numpy() for t in meta)
    G, L = keep.shape
    n = L // k
    table = np.zeros((G * n, n_experts), dtype=bool)
    rows = tok + np.arange(G)[:, None] * n
    table[rows[keep], sorted_e[keep]] = True
    return table


def _record_keeps(run):
    """Wrap the MoE dispatches (the worker's and a rank's share of a
    split batch): every call's kept slots as a ``kept_table`` and its
    expert buffer's (E, rows an expert), in order; returns
    ``{"keeps", "bufs"}`` and the restore."""
    box = {"keeps": [], "bufs": []}
    m = run.model
    orig = moe_lib.dispatch, moe_lib.dispatch_rank

    def recorded(fn):
        def wrapped(*a, **kw):
            buf, meta = fn(*a, **kw)
            box["keeps"].append(kept_table(meta, m.top_k, m.n_experts))
            # the worker's (G, E, C, d) buffer runs as (E, G·C, d)
            box["bufs"].append((buf.shape[-3], buf.shape[-2] * (
                buf.shape[0] if buf.dim() == 4 else 1)))
            return buf, meta
        return wrapped
    moe_lib.dispatch, moe_lib.dispatch_rank = map(recorded, orig)

    def restore():
        moe_lib.dispatch, moe_lib.dispatch_rank = orig
    return box, restore


def rounds_run(mesh, runs, batch):
    """Two kernel rounds of PD-SGDM through ``ShardedTrainer`` on each run
    of ``runs`` (label → (arch, model overrides)): each round's whole
    start and end, the bytes this rank handed to ``isend``, its byte
    model, its shard shapes and, for an MoE config, the dispatches' kept
    slots of the first step and the first step's batch."""
    out = {}
    for label, (arch, over) in runs.items():
        run = own_run(arch, **over)
        pack = build_train(run, mesh)
        rounds = []
        _watch(pack, rounds)
        box, restore = _record_keeps(run)
        fn = _batch_fn(pack, run, 1000, batch)
        try:
            ShardedTrainer(pack).train(0, fn, 2 * run.optim.p, log_every=2,
                                       verbose=False)
        finally:
            restore()
        trainer = ShardedTrainer(pack)
        out[label] = {
            "rounds": [{k: v for k, v in r.items() if k != "sent"}
                       for r in rounds],
            "sent": [r["sent"] for r in rounds],
            "rank_cycle": trainer.rank_bytes_per_round_cycle(),
            "worker_cycle": trainer.bytes_per_round_cycle(),
            "shard_shapes": {k: tuple(v.shape[1:]) for k, v in
                             pack.params_struct.items()},
            "keeps": box["keeps"][:moe_calls(run)],
            "bufs": box["bufs"][:moe_calls(run)],
            "coords": (pack.layout.worker_index,
                       pack.layout.axis_coord(pack.layout.batch_axis))}
    return out


def _ck_run(arch, over):
    run = own_run(arch, **over)
    return dataclasses.replace(run, parallel=dataclasses.replace(
        run.parallel, remat="full"))


def checkpoint_run(dev, runs, steps, stop):
    """Under profile B (2 pods × data 2 × model 2), for each run of
    ``runs``: a mid-round resume (checkpoint at ``stop``, off a round
    boundary) against the unbroken run; the checkpoint of ``stop``
    restored whole into other ``(data, model)`` splits of the pods (4 × 1
    and 1 × 4) and into one rank per worker (K′ = 8 on profile A's
    mesh)."""
    meshes = {"written": profile_b_mesh(dev),
              "data4": profile_b_mesh(dev, data=4, model=1),
              "model4": profile_b_mesh(dev, data=1, model=4),
              "one": make_mesh((8,), ("data",), device=dev)}
    out = {}
    for label, (arch, over) in runs.items():
        run = _ck_run(arch, over)
        pack = build_train(run, meshes["written"])
        fn = _batch_fn(pack, run, 2000, 2)
        a = ShardedTrainer(pack).train(0, fn, steps, log_every=2,
                                       verbose=False)
        d = _tmpdir()
        ShardedTrainer(pack, ckpt_dir=d, ckpt_every=stop).train(
            0, fn, stop, log_every=2, verbose=False)
        b = ShardedTrainer(pack, ckpt_dir=d).train(
            0, fn, steps, log_every=2, verbose=False, resume=True)
        res = {"resume": {"unbroken": (np_tree(a["params"]),
                                       np_state(a["state"])),
                          "resumed": (np_tree(b["params"]),
                                      np_state(b["state"])),
                          "steps_run": b["steps_run"]},
               "written": _whole(pack, ShardedTrainer(
                   pack, ckpt_dir=d)._restore(stop)[0])}
        for into in ("data4", "model4"):
            other = build_train(run, meshes[into])
            got, _ = ShardedTrainer(other, ckpt_dir=d)._restore(stop)
            res[into] = _whole(other, got)
        one = build_train(dataclasses.replace(run, parallel=ParallelCfg(
            profile="A", remat="none")), meshes["one"])
        got, _ = ShardedTrainer(one, ckpt_dir=d)._restore(stop)
        res["one"] = np_tree(got)
        out[label] = res
    return out


def reference_run(dev, inp):
    """The reference's ``tests/test_sharded.py`` check under profile B:
    the tiny config, 4 pods × an FSDP axis of 2, ``pack.train_step`` over
    the given batches from the given x₀, for PD-SGDM and CPD-SGDM (sign);
    the final whole params, K-stacked."""
    mesh = make_mesh((4, 2), ("pod", "data"), device=dev)
    out = {}
    for opt in ("pd_sgdm", "cpd_sgdm"):
        run = RunCfg(model=ModelCfg(**inp["cfg"]),
                     parallel=ParallelCfg(profile="B", remat="none"),
                     optim=OptimCfg(name=opt, eta=0.05, mu=0.9, p=2,
                                    weight_decay=1e-4))
        pack = build_train(run, mesh)
        params = _mine(pack, inp["x0"])
        state = pack.opt.init(params)
        for t, b in enumerate(inp["batches"]):
            params, state, _ = pack.train_step(params, state,
                                               pack.worker_batch(_torch(b)),
                                               t)
        out[opt] = _whole(pack, params)
    return out


def every_arch(dev):
    """Every LM arch's own smoke ``RunCfg``, unmodified, through one round
    of ``ShardedTrainer`` on a mesh that fits its profile: profile A's 4
    workers × a model axis of 2, profile B's 2 pods × data 2 × model 2;
    the layout's roles, the losses, and the byte model against what this
    rank handed to ``isend``."""
    meshes = {"A": make_mesh((4,), ("data",), device=dev, model_axis=2),
              "B": profile_b_mesh(dev)}
    out = {}
    for arch in ARCHS:
        run = get_smoke_config(arch)
        if run.model.arch_type == "cnn":
            continue
        pack = build_train(run, meshes[run.parallel.profile])
        lay = pack.layout
        fn = _batch_fn(pack, run, 3000, 4)
        with isend_bytes() as box:
            res = ShardedTrainer(pack).train(0, fn, run.optim.p,
                                             log_every=1, verbose=False)
        out[arch] = {"roles": (lay.worker_axes, lay.tp_axis, lay.fsdp_axis,
                               lay.inner_axis),
                     "losses": res["history"].loss, "sent": box["n"],
                     "cycle": pack.opt.bytes_per_round_cycle(
                         per_worker(pack.params_struct))}
    return out


def _counted_batches(box):
    """Wrap ``dist.batch_isend_irecv``: ``box["n"]`` counts its calls."""
    orig = dist.batch_isend_irecv

    def counted(ops):
        box["n"] += 1
        return orig(ops)
    dist.batch_isend_irecv = counted
    return orig


def collectives_run(dev):
    """The mesh's ``all_gather`` and ``reduce_scatter`` over each axis of
    profile B's mesh, along dims 0 and 1: gloo's point to point (the
    ``dist.batch_isend_irecv`` calls counted) and the branch that NCCL
    takes (``all_gather_into_tensor``/``reduce_scatter_tensor``, run here
    on gloo, which offers both on host tensors)."""
    mesh = profile_b_mesh(dev)
    native = dataclasses.replace(mesh, backend="nccl")
    t = (torch.arange(24, dtype=torch.float32).reshape(4, 6)
         + 100.0 * mesh.rank)
    out = {}
    for axis in ("pod", "data", "model"):
        group = mesh.group((axis,))
        for dim in (0, 1):
            for label, m in (("p2p", mesh), ("native", native)):
                box = {"n": 0}
                orig = _counted_batches(box)
                try:
                    g = m.all_gather(t, group, dim)
                    r = m.reduce_scatter(t, group, dim)
                finally:
                    dist.batch_isend_irecv = orig
                out[(axis, dim, label)] = {"gather": g.numpy(),
                                           "scatter": r.numpy(),
                                           "batches": box["n"]}
    out["lines"] = {a: mesh.line((a,)) for a in ("pod", "data", "model")}
    return out


def eight_rank_scenarios(mesh_rank, inp):
    """Profile B's rounds, resume and checkpoints, the reference's check
    and every arch's own config, in one set of 8 ranks."""
    rank, world, dev = mesh_rank
    return {"rounds": rounds_run(profile_b_mesh(dev), inp["runs"],
                                 inp["batch"]),
            "checkpoint": checkpoint_run(dev, inp["runs"], inp["steps"],
                                         inp["stop"]),
            "reference": reference_run(dev, inp),
            "archs": every_arch(dev),
            "collectives": collectives_run(dev)}


def dp_run(run):
    return dataclasses.replace(run, parallel=dataclasses.replace(
        run.parallel, profile="A", inner="dp"))


def inner_dp_scenarios(mesh_rank, inp):
    """``inner="dp"`` on 2 workers × a model axis of 2: two kernel rounds
    of each run of ``inp["runs"]`` at each per-worker batch of
    ``inp["batches"]`` (one the axis divides, one it does not), as
    :func:`rounds_run` records them, and each round's end on this rank
    (the two ranks of a worker hold the same bits)."""
    rank, world, dev = mesh_rank
    mesh = make_mesh((world // 2,), ("data",), device=dev, model_axis=2)
    out = {}
    for label, (arch, over) in inp["runs"].items():
        for batch in inp["batches"]:
            run = dp_run(own_run(arch, **over))
            pack = build_train(run, mesh)
            rounds = []
            _watch(pack, rounds)
            box, restore = _record_keeps(run)
            try:
                res = ShardedTrainer(pack).train(
                    0, _batch_fn(pack, run, 1000, batch), 2 * run.optim.p,
                    log_every=2, verbose=False)
            finally:
                restore()
            out[(label, batch)] = {
                "rounds": [{k: v for k, v in r.items() if k != "sent"}
                           for r in rounds],
                "sent": [r["sent"] for r in rounds],
                "rank_cycle": ShardedTrainer(pack).rank_bytes_per_round_cycle(),
                "params": np_tree(res["params"]),
                "losses": res["history"].loss,
                "keeps": box["keeps"][:moe_calls(run)],
                "bufs": box["bufs"][:moe_calls(run)]}
    return out
