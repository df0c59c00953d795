"""Profile B (FSDP × TP inside a worker) and profile A's ``inner="dp"`` on
the port's sharded runtime, in gloo ranks on the CPU, held against the
reference and against one rank per worker.

Two module fixtures spawn the ranks once each (the rank-side scenarios
are ``tests/torch_fsdp_ranks.py``, which imports no JAX):

* eight ranks, 2 pods × data 2 × model 2, under each config's own
  profile B: two kernel rounds of PD-SGDM through ``ShardedTrainer`` on
  the Qwen2-72B (QKV bias), Mixtral (MoE, one dispatch group, at a
  capacity factor of 0.25, where the smoke config drops slots), InternVL2
  (the ``vlm`` −1 labels) and Jamba (the SSD and the MoE under FSDP +
  TP) smoke configs, each round from its captured start against the same
  round with one rank per worker (``DenseComm`` and the gradients worker
  by worker in plain autograd) at ROADMAP C.6's 4.8e-7, the dropped slots
  equal, the bytes each rank hands to ``isend`` against its byte model; a
  mid-round resume bit for bit; a checkpoint restored across ``(data,
  model)`` splits and into one rank per worker; the reference's own
  multi-device check (``tests/test_sharded.py:10-77``) under profile B (4
  pods × data 2) against the reference's dense simulation at its bars
  (5e-4 for PD-SGDM, 8e-3 for CPD-SGDM's sign wire, whose blocks are per
  shard); and every LM arch's own smoke ``RunCfg``, unmodified, through a
  round on a mesh that fits its profile;
* four ranks, 2 workers × a model axis of 2 under ``inner="dp"``: the
  OLMo and Mixtral smoke configs at a per-worker batch the axis divides
  and at one it does not, each round against one rank per worker, the
  worker's two ranks bit-identical, each rank handing ``isend`` the
  worker's whole plan.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelCfg as RModelCfg  # noqa: E402
from repro.configs.shapes import train_batch_arrays as r_batch  # noqa: E402
from repro.core import (CPDSGDM, PDSGDM, CPDSGDMConfig,  # noqa: E402
                        PDSGDMConfig, SignCompressor)
from repro.core.gossip import DenseComm as RDense  # noqa: E402
from repro.core.topology import ring as r_ring  # noqa: E402
from repro.models import make_model as r_make_model  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.configs.shapes import train_batch_arrays  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import DenseComm, make_optimizer, ring  # noqa: E402
from repro_torch.launch.runtime import worker_grad_fn  # noqa: E402
from repro_torch.launch.sharding import shard_plan  # noqa: E402
from repro_torch.launch.spawn import spawn_ranks  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.train.trainer import _stack_batches  # noqa: E402

import torch_fsdp_ranks as fsdp_ranks  # noqa: E402

ROUND_BAR = 4.8e-7
TINY = dict(name="tiny", arch_type="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab=128)
KR = 4                         # the reference check's pods
K = 2                          # the round-by-round checks' workers
BATCH = 4                      # a worker's batch: one sequence a data rank
DROPS = {"capacity_factor": 0.25}
RUNS = {"qwen2": ("qwen2-72b", {}),
        "mixtral": ("mixtral-8x7b", DROPS),
        "internvl2": ("internvl2-76b", {}),
        "jamba": ("jamba-1.5-large-398b", {})}
DP_RUNS = {"olmo": ("olmo-1b", {}), "mixtral": ("mixtral-8x7b", DROPS)}
DP_BATCHES = (2, 3)            # the model axis of 2 divides 2, not 3
CKPT = {"steps": 6, "stop": 3}  # p = 2: step 3 is off a round boundary


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at
    once (see ``tests/test_torch_sharded.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def eight():
    """The reference's x₀ and batches, and the port's 8 ranks."""
    mcfg = RModelCfg(**TINY)
    model = r_make_model(mcfg)
    x0 = model.init(jax.random.PRNGKey(0))
    batches = [_np(r_batch(mcfg, KR, 2, 16, jax.random.fold_in(
        jax.random.PRNGKey(1), t))) for t in range(6)]
    one = params_from_reference(_np(x0), "cpu")
    stacked = {k: np.broadcast_to(v.numpy(), (KR,) + tuple(v.shape)).copy()
               for k, v in one.items()}
    res = spawn_ranks(fsdp_ranks.eight_rank_scenarios, 8,
                      ({"cfg": TINY, "x0": stacked, "batches": batches,
                        "runs": RUNS, "batch": BATCH, **CKPT},),
                      backend="gloo", device="cpu")
    return mcfg, model, x0, batches, res


@pytest.fixture(scope="module")
def four():
    return spawn_ranks(fsdp_ranks.inner_dp_scenarios, 2 * K,
                       ({"runs": DP_RUNS, "batches": DP_BATCHES},),
                       backend="gloo", device="cpu")


def _dense_round(run, start, t, batch):
    """Round ``t // p`` from the whole K-stacked ``start`` with one rank
    per worker: ``DenseComm(ring(K))``'s kernel round, the gradients
    worker by worker in plain autograd, on the ranks' batches."""
    g1 = worker_grad_fn(make_model(run.model), "none")

    def gfn(params, b):
        outs = [g1({k: v[w:w + 1] for k, v in params.items()},
                   {k: v[w:w + 1] for k, v in b.items()}) for w in range(K)]
        return (torch.stack([o[0] for o in outs]).mean(),
                {k: torch.cat([o[1][k] for o in outs]) for k in params})

    o = run.optim
    opt = make_optimizer("pd_sgdm", DenseComm(ring(K), device="cpu"),
                         eta=o.eta, mu=o.mu, p=o.p,
                         weight_decay=o.weight_decay, use_kernel=True)
    x, m = start
    params = {k: torch.from_numpy(v) for k, v in x.items()}
    state = opt.init(params)
    state["m"] = {k: torch.from_numpy(v) for k, v in m.items()}
    state["step"].fill_(t)
    batches = _stack_batches([train_batch_arrays(
        run.model, K, batch, 8, torch.Generator().manual_seed(1000 + t + i),
        device="cpu") for i in range(o.p)])
    params, _, _ = opt.round(state, params, gfn, batches)
    return params


def _hold_rounds(run, rounds, batch, label):
    assert [r["t"] for r in rounds] == [0, 2]
    for rd in rounds:
        want = _dense_round(run, rd["start"], rd["t"], batch)
        gaps = {k: float(np.abs(rd["end"][k] - want[k].numpy()).max())
                for k in want}
        assert max(gaps.values()) <= ROUND_BAR, (label, rd["t"], gaps)
    assert all(np.isfinite(v).all() for v in rounds[-1]["end"].values())


def _one_rank_keeps(run, start, batch):
    """Each worker's kept slots of step 0 with one rank per worker, one
    ``kept_table`` (tokens × experts) per MoE call, and its buffers:
    ``{"keeps", "bufs"}`` a worker."""
    model = make_model(run.model)
    b = train_batch_arrays(run.model, K, batch, 8,
                           torch.Generator().manual_seed(1000),
                           device="cpu")
    out = []
    for w in range(K):
        box, restore = fsdp_ranks._record_keeps(run)
        try:
            model.loss({k: torch.from_numpy(v[w]) for k, v in
                        start[0].items()},
                       {k: v[w] for k, v in b.items()})
        finally:
            restore()
        out.append(box)
    return out


def _hold_keeps(got, want, coord, k):
    """A rank's kept slots against its worker's: the rows of its share
    of the batch (the ``coord``-th slice where it holds a slice, all of
    them where it holds the whole batch).  Returns the dropped slots the
    rank saw."""
    assert len(got) == len(want) > 0
    dropped = 0
    for a, b in zip(got, want):
        n = a.shape[0]
        np.testing.assert_array_equal(
            a, b if n == b.shape[0] else b[coord * n:(coord + 1) * n])
        dropped += int(a.shape[0] * k - a.sum())
    return dropped


@pytest.mark.parametrize("label", list(RUNS))
def test_profile_b_rounds_equal_one_rank_per_worker(eight, label):
    """Each profile B round from its captured start against the same
    round with one rank per worker; every rank gathered the same whole
    params; Mixtral's dropped slots are the one-rank worker's."""
    res = eight[4]
    arch, over = RUNS[label]
    run = fsdp_ranks.own_run(arch, **over)
    assert run.parallel.profile == "B"
    rounds = res[0]["rounds"][label]["rounds"]
    _hold_rounds(run, rounds, BATCH, label)
    for r in res[1:]:
        for a, b in zip(rounds, r["rounds"][label]["rounds"]):
            for k in a["end"]:
                np.testing.assert_array_equal(a["end"][k], b["end"][k])
    if run.model.n_experts:
        want = _one_rank_keeps(run, rounds[0]["start"], BATCH)
        dropped = 0
        for r in res:
            w, c = r["rounds"][label]["coords"]
            dropped += _hold_keeps(r["rounds"][label]["keeps"],
                                   want[w]["keeps"], c, run.model.top_k)
        if label == "mixtral":
            assert dropped > 0


@pytest.mark.parametrize("label", ["mixtral", "jamba"])
def test_profile_b_moe_runs_the_rank_slots(eight, label):
    """Under a split batch each rank's experts run only its own kept
    slots (which slots, ``test_profile_b_rounds_equal_one_rank_per_worker``
    holds): its buffer holds, for every expert, a row for each slot that
    one expert keeps of them, in a static number of rows known without a
    host read, the smaller of the worker's G·C and the rank's N·k slots,
    so no more than the worker's (E, G·C) buffer."""
    res = eight[4]
    arch, over = RUNS[label]
    run = fsdp_ranks.own_run(arch, **over)
    rounds = res[0]["rounds"][label]["rounds"]
    want = _one_rank_keeps(run, rounds[0]["start"], BATCH)
    for r in res:
        got = r["rounds"][label]
        w, c = got["coords"]
        for table, (E, M), (wE, wrows), whole in zip(
                got["keeps"], got["bufs"], want[w]["bufs"],
                want[w]["keeps"]):
            assert table.shape[0] * fsdp_ranks.DATA == whole.shape[0]
            assert E == wE == run.model.n_experts
            kept = max(int(table.sum(0).max()), 1)
            assert kept <= M == min(wrows, table.shape[0] * run.model.top_k)
            assert M <= wrows


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("axis", ["pod", "data", "model"])
def test_mesh_collectives(eight, axis, dim):
    """The mesh's ``all_gather`` and ``reduce_scatter`` over one axis of
    profile B's mesh: under gloo one ``batch_isend_irecv`` each (a
    batch: NCCL pairs its sends and receives, where single posts in
    receive-first order can wait on each other), and the branch NCCL
    takes (``all_gather_into_tensor``/``reduce_scatter_tensor``, none);
    both give the line's tensors concatenated along ``dim`` and this
    rank's slice of their sum."""
    res = eight[4]
    base = np.arange(24, dtype=np.float32).reshape(4, 6)
    for rank, r in enumerate(res):
        got = r["collectives"]
        line = got["lines"][axis]
        ts = [base + 100.0 * q for q in line]
        i = line.index(rank)
        whole = np.concatenate(ts, axis=dim)
        total = np.sum(ts, axis=0)
        n = total.shape[dim] // len(line)
        mine = np.take(total, range(i * n, (i + 1) * n), axis=dim)
        for label, batches in (("p2p", 2), ("native", 0)):
            out = got[(axis, dim, label)]
            np.testing.assert_array_equal(out["gather"], whole)
            np.testing.assert_array_equal(out["scatter"], mine)
            assert out["batches"] == batches


def _rows(shapes):
    return sum(-(-int(np.prod(s)) // 1024) for s in shapes)


@pytest.mark.parametrize("label", list(RUNS))
def test_profile_b_isend_bytes(eight, label):
    """Each rank hands ``isend`` its byte model's bytes every round: the
    used rows of its own shards' plan (TP then FSDP), once to its ring(2)
    neighbour pod; its shards are the plan's."""
    arch, over = RUNS[label]
    run = fsdp_ranks.own_run(arch, **over)
    whole = make_model(run.model).param_shapes(whole=True)
    plan = shard_plan(run.model, whole, fsdp_ranks.MODEL,
                      fsdp_size=fsdp_ranks.DATA)
    rows = _rows(plan.shard_shape(k) for k in whole)
    assert any(plan.fsdp_dim(k) is not None for k in whole)
    for r in eight[4]:
        got = r["rounds"][label]
        assert got["sent"] == [rows * 1024 * 4] * 2
        assert got["rank_cycle"] == (rows * 1024 * 4,)
        assert {k: tuple(v) for k, v in got["shard_shapes"].items()} == \
            {k: plan.shard_shape(k) for k in whole}
        assert got["worker_cycle"] == (_rows(whole.values()) * 1024 * 4,)


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("label", list(RUNS))
def test_profile_b_mid_round_resume_bit_identical(eight, label):
    for r in eight[4]:
        res = r["checkpoint"][label]["resume"]
        assert res["steps_run"] == CKPT["steps"] - CKPT["stop"]
        for a, b in zip(res["unbroken"], res["resumed"]):
            _same(a, b)


@pytest.mark.parametrize("label", list(RUNS))
@pytest.mark.parametrize("into", ["data4", "model4", "one"])
def test_profile_b_checkpoint_restores_across_splits(eight, into, label):
    """The checkpoint of 2 pods × data 2 × model 2, restored whole into
    2 pods × data 4, 2 pods × model 4, and one rank per worker (K′ = 8,
    ``restore_elastic``: workers 0-1 their own leaves, the others those
    of workers 0-1), bit for bit."""
    for rank, r in enumerate(eight[4]):
        ck = r["checkpoint"][label]
        w = ck["written"]
        got = ck[into]
        for k in w:
            if into == "one":
                np.testing.assert_array_equal(got[k][0], w[k][rank % K])
            else:
                np.testing.assert_array_equal(got[k], w[k])


def _dense_sim(opt_name, mcfg, model, x0, batches):
    """The reference test's dense single-device simulation."""
    params = jax.vmap(lambda k: x0)(jnp.arange(KR))
    comm = RDense(r_ring(KR))
    if opt_name == "pd_sgdm":
        opt = PDSGDM(PDSGDMConfig(eta=0.05, mu=0.9, p=2,
                                  weight_decay=1e-4), comm)
    else:
        opt = CPDSGDM(CPDSGDMConfig(eta=0.05, mu=0.9, p=2, gamma=0.4,
                                    weight_decay=1e-4), comm,
                      SignCompressor())
    st = opt.init(params)
    gradf = jax.vmap(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))
    stepf = jax.jit(lambda st, p, b: opt.step(st, p, gradf(p, b)[1]))
    for b in batches:
        params, st = stepf(st, params, b)
    return params_from_reference(_np(params), "cpu")


@pytest.mark.parametrize("opt_name,tol", [("pd_sgdm", 5e-4),
                                          ("cpd_sgdm", 8e-3)])
def test_profile_b_equals_reference_dense_sim(eight, opt_name, tol):
    mcfg, model, x0, batches, res = eight
    got = res[0]["reference"][opt_name]
    want = _dense_sim(opt_name, mcfg, model, x0, batches)
    assert list(got) == list(want)
    errs = {k: float(np.abs(got[k] - want[k].numpy()).max()) for k in want}
    assert max(errs.values()) < tol, errs
    for k in want:
        np.testing.assert_allclose(got[k].mean(0), want[k].numpy().mean(0),
                                   atol=2e-3, err_msg=k)
    for r in res[1:]:
        for k in got:
            np.testing.assert_array_equal(r["reference"][opt_name][k], got[k])


LM_ARCHS = [a for a in ARCHS if a != "paper-resnet20"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_every_arch_own_config_builds_and_trains(eight, arch):
    """``build_train`` takes every LM arch's own smoke ``RunCfg`` as it is,
    profile B's five included, on a mesh that fits its profile, and runs
    a round: finite losses, and each rank hands ``isend`` its byte
    model's bytes."""
    from repro_torch.configs.registry import get_smoke_config
    run = get_smoke_config(arch)
    want = {"A": (("data",), "model", None, None),
            "B": (("pod",), "model", "data", None)}[run.parallel.profile]
    for r in eight[4]:
        got = r["archs"][arch]
        assert got["roles"] == want
        assert len(got["losses"]) == run.optim.p
        assert all(np.isfinite(v) for v in got["losses"])
        assert got["sent"] == got["cycle"][0]


@pytest.mark.parametrize("batch", DP_BATCHES)
@pytest.mark.parametrize("label", list(DP_RUNS))
def test_inner_dp_rounds_equal_one_rank_per_worker(four, label, batch):
    """``inner="dp"``: each round against one rank per worker on the same
    batch (split over the model axis where it divides, whole on both
    ranks where it does not); the two ranks of a worker bit-identical
    after every round; each rank hands ``isend`` the worker's whole plan;
    the MoE's dropped slots are the one-rank worker's."""
    arch, over = DP_RUNS[label]
    run = fsdp_ranks.dp_run(fsdp_ranks.own_run(arch, **over))
    r0 = four[0][(label, batch)]
    _hold_rounds(run, r0["rounds"], batch, label)
    whole = make_model(run.model).param_shapes(whole=True)
    rows = _rows(whole.values())
    for rank, r in enumerate(four):
        got = r[(label, batch)]
        peer = four[rank ^ 1][(label, batch)]
        for a, b in zip(got["rounds"], peer["rounds"]):
            _same(a["end"], b["end"])
        _same(got["params"], peer["params"])
        assert got["sent"] == [rows * 1024 * 4] * 2
        assert got["rank_cycle"] == (rows * 1024 * 4,)
    if run.model.n_experts:
        want = _one_rank_keeps(run, r0["rounds"][0]["start"], batch)
        for rank, r in enumerate(four):
            _hold_keeps(r[(label, batch)]["keeps"], want[rank // 2]["keeps"],
                        rank % 2, run.model.top_k)


def test_inner_dp_split_changes_the_rank_batch(four):
    """Where the model axis divides the batch the two ranks of a worker
    ran different halves of it, and where it does not the same whole
    batch: their losses (the worker's, summed over its ranks, or each
    rank's own) agree either way."""
    for label in DP_RUNS:
        for batch in DP_BATCHES:
            losses = [r[(label, batch)]["losses"] for r in four]
            np.testing.assert_allclose(losses[0], losses[1], rtol=0,
                                       atol=1e-6)
            assert all(np.isfinite(losses[0]))


def test_chip_smoke_split_paths_rows():
    """``chip_smoke.py``'s ``SPLIT`` paths at their real widths (as meta
    tensors, never allocated): a rank's shards under the path's layout
    (FSDP over the data axis, TP over the model axis, or none under
    ``inner="dp"``) make the used rows the script holds the bytes to,
    and Qwen2-72B's widths are its published ones."""
    import importlib.util
    import os
    from repro_torch.kernels.ops import KernelPlan
    from repro_torch.models.layers import TPGroup
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name, sp in cs.SPLIT.items():
        run = cs.split_run(name)
        sizes, names, m = sp["mesh"]
        fsdp = sizes[names.index("data")] if run.parallel.profile == "B" \
            else 1
        tp = 1 if run.parallel.inner == "dp" else m
        grp = (lambda n: TPGroup(n, 0, None) if n > 1 else None)
        shapes = make_model(run.model, tp=grp(tp),
                            fsdp=grp(fsdp)).param_shapes()
        plan = KernelPlan.for_tree(
            {n: torch.empty((1,) + s, device="meta")
             for n, s in shapes.items()}, worker_dim=True)
        assert plan.used_rows == sp["rows"], name
    qwen = cs.split_run("sharded_qwen2_72b_fsdp").model
    assert (qwen.d_model, qwen.n_heads, qwen.n_kv_heads, qwen.d_ff,
            qwen.qkv_bias) == (8192, 64, 8, 29568, True)
