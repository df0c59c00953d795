"""Rank-side scenarios of ``tests/test_torch_tensor_parallel.py``: each
function runs in every gloo rank on the CPU (spawned by
``repro_torch.launch.spawn.spawn_ranks``), drives the port's sharded
runtime with a model axis above 1 (tensor parallelism inside a worker) on
numpy inputs handed over by the test, and returns numpy results for the
test process to hold against the reference and against a model axis of
1.  Imports nothing of JAX."""
import dataclasses
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelCfg, OptimCfg, ParallelCfg, RunCfg
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.runtime import build_train
from repro_torch.train.trainer import ShardedTrainer, gather_workers

from torch_sharded_ranks import isend_bytes, np_state, np_tree

TP = 2


def _bcast(obj):
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _tmpdir():
    return _bcast(tempfile.mkdtemp(prefix="tp_ck_") if dist.get_rank() == 0
                  else None)


def _mine(pack, tree):
    """This rank's shards of a worker-stacked whole numpy tree."""
    w = pack.layout.worker_index
    out = {}
    for k, v in tree.items():
        t = torch.from_numpy(np.ascontiguousarray(v[w:w + 1]))
        if pack.plan is not None:
            t = pack.plan.shard(k, t)
        out[k] = t.contiguous().clone()
    return out


def _whole(pack, tree, keys=True):
    """The K-stacked whole tree, on every rank (through rank 0)."""
    got = gather_workers(tree, keys, pack.layout, pack.plan)
    return _bcast(np_state(got) if dist.get_rank() == 0 else None)


def reference_run(mesh_rank, inp):
    """The reference's ``tests/test_sharded.py`` run on the port: the tiny
    config, ``inp["workers"]`` workers × a model axis of 2, ``pack.
    train_step`` over the given batches from the given x₀, for PD-SGDM
    and CPD-SGDM (sign); the final whole params, K-stacked."""
    rank, world, dev = mesh_rank
    mesh = make_mesh((world // TP,), ("data",), device=dev, model_axis=TP)
    out = {}
    for opt in ("pd_sgdm", "cpd_sgdm"):
        run = RunCfg(model=ModelCfg(**inp["cfg"]),
                     parallel=ParallelCfg(profile="A", remat="none"),
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


def _torch(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


def _smoke_run(arch, opt="pd_sgdm", **optim):
    run = get_smoke_config(arch)
    return dataclasses.replace(
        run, parallel=ParallelCfg(profile="A", remat="none"),
        optim=OptimCfg(name=opt, eta=0.05, mu=0.9, p=2, weight_decay=1e-4,
                       **optim))


def _watch(pack, rounds):
    """Wrap ``pack.train_round``: each round's whole start (params, m,
    step) and end, and the bytes this rank handed to ``isend``."""
    inner = pack.train_round

    def train_round(params, state, batches, t):
        start = (_whole(pack, params), _whole(pack, state["m"]))
        with isend_bytes() as box:
            out = inner(params, state, batches, t)
        rounds.append({"t": t, "start": start, "end": _whole(pack, out[0]),
                       "sent": box["n"]})
        return out
    pack.train_round = train_round


def rounds_run(mesh_rank, inp):
    """Two kernel rounds of PD-SGDM through ``ShardedTrainer`` on each
    smoke config of ``inp["archs"]`` (K workers × a model axis of 2): each
    round's whole start and end, the bytes each rank handed to ``isend``
    and its byte model; then CPD sign on the tree layout (bytes only)."""
    from repro_torch.configs.shapes import train_batch_arrays
    rank, world, dev = mesh_rank
    mesh = make_mesh((world // TP,), ("data",), device=dev, model_axis=TP)
    K = world // TP
    out = {}
    for label, (arch, opt, kw) in inp["runs"].items():
        run = _smoke_run(arch, opt, **kw)
        pack = build_train(run, mesh)
        rounds = []
        _watch(pack, rounds)
        trainer = ShardedTrainer(pack)

        def batch_fn(t, run=run, pack=pack):
            gen = torch.Generator().manual_seed(1000 + t)
            return pack.worker_batch(train_batch_arrays(
                run.model, K, 2, 8, gen, device=dev))

        trainer.train(0, batch_fn, 2 * run.optim.p, log_every=2,
                      verbose=False)
        out[label] = {"rounds": [{k: v for k, v in r.items()
                                  if k != "sent"} for r in rounds],
                      "sent": [r["sent"] for r in rounds],
                      "rank_cycle": trainer.rank_bytes_per_round_cycle(),
                      "worker_cycle": trainer.bytes_per_round_cycle(),
                      "shard_shapes": {k: tuple(v.shape[1:]) for k, v in
                                       pack.params_struct.items()}}
    return out


def _ck_run(arch="olmo-1b", remat="none"):
    run = _smoke_run(arch, use_kernel=True)
    return dataclasses.replace(run, parallel=dataclasses.replace(
        run.parallel, remat=remat))


def checkpoint_run(mesh_rank, inp):
    """A mid-round resume under TP (checkpoint at step 3 of p = 2, resumed
    on the per-step path) against the unbroken run; a TP checkpoint
    (K = world/2 workers) restored into a model axis of 1 (K′ = world, by
    ``restore_elastic``) and a model-axis-1 checkpoint restored under
    TP."""
    from repro_torch.configs.shapes import train_batch_arrays
    from repro_torch.checkpoint import latest_step
    rank, world, dev = mesh_rank
    tp_mesh = make_mesh((world // TP,), ("data",), device=dev, model_axis=TP)
    one_mesh = make_mesh((world,), ("data",), device=dev)
    out = {}

    def batch(pack, K):
        def fn(t):
            gen = torch.Generator().manual_seed(2000 + t)
            return pack.worker_batch(train_batch_arrays(
                pack.model.cfg, K, 2, 8, gen, device=dev))
        return fn

    steps, stop = inp["steps"], inp["stop"]
    pack = build_train(_ck_run(remat="full"), tp_mesh)
    fn = batch(pack, world // TP)
    a = ShardedTrainer(pack).train(0, fn, steps, log_every=2, verbose=False)
    d = _tmpdir()
    ShardedTrainer(pack, ckpt_dir=d, ckpt_every=stop).train(
        0, fn, stop, log_every=2, verbose=False)
    b = ShardedTrainer(pack, ckpt_dir=d).train(0, fn, steps, log_every=2,
                                               verbose=False, resume=True)
    out["resume"] = {"unbroken": (np_tree(a["params"]), np_state(a["state"])),
                     "resumed": (np_tree(b["params"]), np_state(b["state"])),
                     "steps_run": b["steps_run"], "losses": (
                         a["history"].loss, b["history"].loss)}
    # the TP checkpoint of step ``stop``, whole, and restored in K′ = world
    # workers of one rank each
    tp_written = _whole(pack, ShardedTrainer(pack, ckpt_dir=d)._restore(
        stop)[0])
    one = build_train(_ck_run(), one_mesh)
    got, _ = ShardedTrainer(one, ckpt_dir=d)._restore(latest_step(d))
    out["tp_to_one"] = {"written": tp_written, "restored": np_tree(got)}
    # a model-axis-1 checkpoint restored under TP
    d1 = _tmpdir()
    ShardedTrainer(one, ckpt_dir=d1, ckpt_every=stop).train(
        0, batch(one, world), stop, log_every=2, verbose=False)
    one_written = _whole(one, ShardedTrainer(one, ckpt_dir=d1)._restore(
        stop)[0])
    got, _ = ShardedTrainer(pack, ckpt_dir=d1)._restore(stop)
    out["one_to_tp"] = {"written": one_written,
                        "restored": _whole(pack, got)}
    return out


def refusals(mesh_rank):
    """What a model axis of 2 once refused: MLA, the SSD mixer, profile B
    and ``inner="dp"``; each builds and runs a step (its layout's roles
    and the step's loss), or the message of what raised."""
    from repro_torch.configs.shapes import train_batch_arrays
    rank, world, dev = mesh_rank
    mesh = make_mesh((world // TP,), ("data",), device=dev, model_axis=TP)
    checks = {
        "mla": _smoke_run("minicpm3-4b"),
        "ssd": _smoke_run("mamba2-1.3b"),
        "profile_b": dataclasses.replace(
            _smoke_run("olmo-1b"), parallel=ParallelCfg(profile="B")),
        "inner_dp": dataclasses.replace(
            _smoke_run("olmo-1b"), parallel=ParallelCfg(inner="dp")),
    }
    out = {}
    for k, run in checks.items():
        try:
            pack = build_train(run, mesh)
            lay = pack.layout
            params, state = pack.init_fn(0)
            batch = pack.worker_batch(train_batch_arrays(
                run.model, lay.n_workers, 4, 8,
                torch.Generator().manual_seed(7), device=dev))
            _, _, loss = pack.train_step(params, state, batch, 0)
            out[k] = {"roles": (lay.worker_axes, lay.tp_axis,
                                lay.fsdp_axis, lay.inner_axis),
                      "loss": float(loss)}
        except (NotImplementedError, ValueError) as err:
            out[k] = str(err)
    # inner="worker": every axis, the model axis too, gossips
    from repro_torch.launch.mesh import make_layout
    lay = make_layout(ParallelCfg(inner="worker"), mesh)
    out["inner_worker"] = (lay.worker_axes, lay.tp_axis, lay.worker_index)
    return out


def hier_bytes(mesh_rank, inp):
    """One kernel round of PD-SGDM on ``hierarchical(2, 2)`` (flat layout,
    the bf16 inter wire) under TP: the bytes this rank handed to ``isend``
    and ``all_reduce``, and its byte model's per level."""
    rank, world, dev = mesh_rank
    mesh = make_mesh((world // TP,), ("data",), device=dev, model_axis=TP)
    run = RunCfg(model=ModelCfg(**inp["cfg"]),
                 parallel=ParallelCfg(profile="A", remat="none",
                                      node_size=2),
                 optim=OptimCfg(name="pd_sgdm", eta=0.05, mu=0.9, p=2,
                                use_kernel=True, wire_dtype="bfloat16"))
    pack = build_train(run, mesh)
    params = _mine(pack, inp["x0"])
    state = pack.opt.init(params)
    batches = {k: torch.stack([_torch(b)[k] for b in inp["batches"][:2]])
               for k in inp["batches"][0]}
    batches = {k: v[:, pack.layout.worker_index:pack.layout.worker_index + 1]
               for k, v in batches.items()}
    comm = pack.opt.comm
    comm.reduced_bytes = 0
    with isend_bytes() as box:
        pack.train_round(params, state, batches, 0)
    from repro_torch.launch.runtime import per_worker
    return {"sent": box["n"], "reduced": comm.reduced_bytes,
            "levels": pack.opt.hier_bytes_per_level(
                per_worker(pack.params_struct))}


def eight_rank_scenarios(mesh_rank, inp):
    """``reference_run``, ``hier_bytes`` and ``refusals`` in one set of
    ranks."""
    return {"reference": reference_run(mesh_rank, inp),
            "hier": hier_bytes(mesh_rank, inp),
            "refused": refusals(mesh_rank)}


def replicated_grads(mesh_rank, inp):
    """One step's gradient on each run of ``inp["replicated"]`` (label →
    the leaf suffixes that stay whole on every rank): this rank's
    gradients of those leaves, worker batch 2 × seq 8."""
    from repro_torch.configs.shapes import train_batch_arrays
    from repro_torch.launch.runtime import worker_grad_fn
    rank, world, dev = mesh_rank
    mesh = make_mesh((world // TP,), ("data",), device=dev, model_axis=TP)
    out = {}
    for label, leaves in inp["replicated"].items():
        arch, opt, kw = inp["runs"][label]
        run = _smoke_run(arch, opt, **kw)
        pack = build_train(run, mesh)
        params, _ = pack.init_fn(0)
        batch = pack.worker_batch(train_batch_arrays(
            run.model, world // TP, 2, 8, torch.Generator().manual_seed(5),
            device=dev))
        _, grads = worker_grad_fn(pack.model, "none")(params, batch)
        m = run.model
        di, gn = m.ssm_expand * m.d_model // TP, m.ssm_state
        # the B and C segments of the SSD's split leaves (their columns
        # [z, x, B, C, dt] and channels [x, B, C] on this rank)
        seg = {"in_proj.w": slice(2 * di, 2 * di + 2 * gn),
               "conv_w": slice(di, di + 2 * gn),
               "conv_b": slice(di, di + 2 * gn)}
        out[label] = {}
        for k, v in grads.items():
            if k.endswith(leaves):
                cut = [s for suffix, s in seg.items() if k.endswith(suffix)]
                out[label][k] = (v[..., cut[0]] if cut else v).numpy().copy()
    return out


def four_rank_scenarios(mesh_rank, inp):
    """``rounds_run``, ``checkpoint_run`` and ``replicated_grads`` in one
    set of ranks."""
    return {"rounds": rounds_run(mesh_rank, inp),
            "checkpoint": checkpoint_run(mesh_rank, inp),
            "grads": replicated_grads(mesh_rank, inp)}
