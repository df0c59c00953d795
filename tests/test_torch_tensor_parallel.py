"""Tensor parallelism inside a worker on the port's sharded runtime: a
``"model"`` mesh axis of 2 (``make_mesh(..., model_axis=2)``, profile A),
in gloo ranks on the CPU, held against the reference and against a model
axis of 1.

Two module fixtures spawn the ranks once each (the rank-side scenarios
are ``tests/torch_tp_ranks.py``, which imports no JAX):

* eight ranks, 4 workers × 2: the reference's own multi-device check
  (``tests/test_sharded.py:10-77``) on the port, the reference's tiny
  config, its x₀ and batches through numpy, 6 steps of ``train_step``,
  against the reference's dense simulation at its bars (5e-4 for
  PD-SGDM, 8e-3 for CPD-SGDM's sign wire, whose blocks are per shard;
  the worker mean within 2e-3); and what a model axis of 2 takes (MLA,
  the SSD, profile B, ``inner="dp"``: each builds and runs a step);
* four ranks, 2 workers × 2: two kernel rounds of PD-SGDM through
  ``ShardedTrainer`` on the dense (OLMo), MoE (Mixtral: its attention,
  with one KV head, stays replicated), VLM (InternVL2: the −1 labels of
  the patch prefix), MLA (MiniCPM3), SSD (Mamba2) and hybrid (Jamba,
  overridden to profile A: its SSD, attention and MoE under TP) smoke
  configs, each round from its captured start against the same round
  with a model axis of 1 (``DenseComm`` and the gradients worker by
  worker in plain autograd) at ROADMAP C.6's 4.8e-7; the bytes each rank
  hands to ``isend`` against its byte model (the replicated latents, B,
  C and norms counted on every rank); the gradients of the replicated
  MLA and SSD leaves equal on both ranks of a worker; a mid-round resume
  under TP bit for bit; a TP checkpoint restored into a model axis of 1
  and the other way round.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelCfg as RModelCfg  # noqa: E402
from repro.configs.registry import get_smoke_config as r_smoke  # noqa: E402
from repro.configs.shapes import train_batch_arrays as r_batch  # noqa: E402
from repro.core import (CPDSGDM, PDSGDM, CPDSGDMConfig,  # noqa: E402
                        PDSGDMConfig, SignCompressor, make_optimizer)
from repro.core.gossip import DenseComm as RDense  # noqa: E402
from repro.core.topology import ring as r_ring  # noqa: E402
from repro.models import make_model as r_make_model  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.configs.shapes import train_batch_arrays  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import DenseComm, make_optimizer as t_opt  # noqa: E402
from repro_torch.core import ring  # noqa: E402
from repro_torch.launch.runtime import worker_grad_fn  # noqa: E402
from repro_torch.launch.sharding import shard_plan  # noqa: E402
from repro_torch.launch.spawn import spawn_ranks  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.train.trainer import _stack_batches  # noqa: E402

import torch_tp_ranks as tp_ranks  # noqa: E402

ROUND_BAR = 4.8e-7
TINY = dict(name="tiny", arch_type="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab=128)
KR = 4                         # the reference check's workers
KT = 2                         # the round-by-round checks' workers
RUNS = {"olmo": ("olmo-1b", "pd_sgdm", {"use_kernel": True}),
        "mixtral": ("mixtral-8x7b", "pd_sgdm", {"use_kernel": True}),
        "internvl2": ("internvl2-76b", "pd_sgdm", {"use_kernel": True}),
        "minicpm3": ("minicpm3-4b", "pd_sgdm", {"use_kernel": True}),
        "mamba2": ("mamba2-1.3b", "pd_sgdm", {"use_kernel": True}),
        "jamba": ("jamba-1.5-large-398b", "pd_sgdm", {"use_kernel": True})}
# the leaves MLA and the SSD keep whole on every rank of a worker
REPLICATED = {"minicpm3": ("attn.wdq.w", "attn.wdkv.w", "attn.wkr.w",
                           "attn.q_norm.scale", "attn.kv_norm.scale"),
              "mamba2": ("mamba.in_proj.w", "mamba.conv_w", "mamba.conv_b"),
              "jamba": ("mamba.in_proj.w", "mamba.conv_w", "mamba.conv_b")}
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
    """The reference's x₀ and batches, and the port's 4 × 2 ranks."""
    mcfg = RModelCfg(**TINY)
    model = r_make_model(mcfg)
    x0 = model.init(jax.random.PRNGKey(0))
    batches = [_np(r_batch(mcfg, KR, 2, 16, jax.random.fold_in(
        jax.random.PRNGKey(1), t))) for t in range(6)]
    one = params_from_reference(_np(x0), "cpu")
    stacked = {k: np.broadcast_to(v.numpy(), (KR,) + tuple(v.shape)).copy()
               for k, v in one.items()}
    res = spawn_ranks(tp_ranks.eight_rank_scenarios, 2 * KR,
                      ({"cfg": TINY, "x0": stacked, "batches": batches},),
                      backend="gloo", device="cpu")
    return mcfg, model, x0, batches, res


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
def test_tp_equals_reference_dense_sim(eight, opt_name, tol):
    mcfg, model, x0, batches, res = eight
    got = res[0]["reference"][opt_name]
    want = _dense_sim(opt_name, mcfg, model, x0, batches)
    assert list(got) == list(want)
    errs = {k: float(np.abs(got[k] - want[k].numpy()).max()) for k in want}
    assert max(errs.values()) < tol, errs
    for k in want:
        np.testing.assert_allclose(got[k].mean(0), want[k].numpy().mean(0),
                                   atol=2e-3, err_msg=k)
    # every rank gathered the same whole params
    for r in res[1:]:
        for k in got:
            np.testing.assert_array_equal(r["reference"][opt_name][k], got[k])


def test_tp_hierarchical_isend_bytes(eight):
    """``hierarchical(2, 2)`` on the flat layout under TP: each node
    leader's ranks hand ``isend`` the inter level of their own shards'
    plan, the other members nothing; every rank hands ``all_reduce`` the
    in-node levels."""
    res = eight[4]
    for rank, r in enumerate(res):
        h = r["hier"]
        leader = (rank // 2) % 2 == 0          # worker w = rank // 2
        assert h["sent"] == (h["levels"]["inter_site"] if leader else 0)
        assert h["reduced"] == h["levels"]["intra_result"]
        assert h["levels"] == res[rank % 2]["hier"]["levels"]


def test_refusals(eight):
    """What a model axis of 2 once refused now builds and runs a step:
    MLA and the SSD split by heads, profile B (the mesh's ``"data"`` axis
    is then the FSDP axis of one worker) and ``inner="dp"``; each step's
    loss is finite and the layout's roles are the reference's."""
    for rank, r in enumerate(eight[4]):
        ref = dict(r["refused"])
        # inner="worker" takes the model axis as a gossip axis, no TP
        assert ref.pop("inner_worker") == (("data", "model"), None, rank)
        roles = {"mla": (("data",), "model", None, None),
                 "ssd": (("data",), "model", None, None),
                 "profile_b": ((), "model", "data", None),
                 "inner_dp": (("data",), None, None, "model")}
        for k, want in roles.items():
            got = ref.pop(k)
            assert not isinstance(got, str), (k, got)
            assert got["roles"] == want, k
            assert np.isfinite(got["loss"]), k
        assert not ref


@pytest.fixture(scope="module")
def four():
    return spawn_ranks(tp_ranks.four_rank_scenarios, 2 * KT,
                       ({"runs": RUNS, "replicated": REPLICATED, **CKPT},),
                       backend="gloo",
                       device="cpu")


def _dense_round(arch, start, t):
    """Round ``t // p`` from the whole K-stacked ``start`` with a model
    axis of 1: ``DenseComm(ring(K))``'s kernel round, the gradients worker
    by worker in plain autograd, on the ranks' batches."""
    run = tp_ranks._smoke_run(arch, use_kernel=True)
    g1 = worker_grad_fn(make_model(run.model), "none")

    def gfn(params, batch):
        outs = [g1({k: v[w:w + 1] for k, v in params.items()},
                   {k: v[w:w + 1] for k, v in batch.items()})
                for w in range(KT)]
        return (torch.stack([o[0] for o in outs]).mean(),
                {k: torch.cat([o[1][k] for o in outs]) for k in params})

    o = run.optim
    opt = t_opt("pd_sgdm", DenseComm(ring(KT), device="cpu"), eta=o.eta,
                mu=o.mu, p=o.p, weight_decay=o.weight_decay, use_kernel=True)
    x, m = start
    params = {k: torch.from_numpy(v) for k, v in x.items()}
    state = opt.init(params)
    state["m"] = {k: torch.from_numpy(v) for k, v in m.items()}
    state["step"].fill_(t)
    batches = _stack_batches([train_batch_arrays(
        run.model, KT, 2, 8, torch.Generator().manual_seed(1000 + t + i),
        device="cpu") for i in range(o.p)])
    params, _, _ = opt.round(state, params, gfn, batches)
    return params


@pytest.mark.parametrize("label", list(RUNS))
def test_tp_rounds_equal_model_axis_one(four, label):
    """Each TP round from its captured start against the same round with
    a model axis of 1; every rank gathered the same whole params."""
    rounds = four[0]["rounds"][label]["rounds"]
    assert [r["t"] for r in rounds] == [0, 2]
    for rd in rounds:
        want = _dense_round(RUNS[label][0], rd["start"], rd["t"])
        gaps = {k: float(np.abs(rd["end"][k] - want[k].numpy()).max())
                for k in want}
        assert max(gaps.values()) <= ROUND_BAR, (label, rd["t"], gaps)
    assert all(np.isfinite(v).all() for v in rounds[-1]["end"].values())


@pytest.mark.parametrize("label", list(REPLICATED))
def test_tp_replicated_leaf_grads_equal_on_a_worker(four, label):
    """The gradients of the leaves MLA and the SSD keep whole (the
    latents' projections and norms; ``in_proj``'s, ``conv_w``'s and
    ``conv_b``'s B and C segments) are the same on both ranks of a
    worker, and whole: summed once over the model axis."""
    for rank in range(0, len(four), 2):
        a, b = (four[rank]["grads"][label], four[rank + 1]["grads"][label])
        assert set(a) == set(b) and a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.abs(a[k]).max() > 0, k


@pytest.mark.parametrize("label", list(RUNS))
def test_tp_isend_bytes(four, label):
    """Each rank hands ``isend`` its byte model's bytes every round: the
    used rows of its own shards' plan, once to its one ring(2) neighbour.
    The worker's figure, summed over its ranks, exceeds the reference's
    one-plan figure by each replicated leaf shipped again and each
    shard's tail row."""
    arch = RUNS[label][0]
    per_rank = [r["rounds"][label] for r in four]
    cfg = r_smoke(arch).model
    shapes = {k: tuple(v.shape) for k, v in params_from_reference(
        _np(r_make_model(cfg).init(jax.random.PRNGKey(0))), "cpu").items()}
    plan = shard_plan(get_smoke_config(arch).model, shapes, 2)
    rows = sum(-(-int(np.prod(plan.shard_shape(k))) // 1024)
               for k in shapes)
    for r in per_rank:
        assert r["sent"] == [rows * 1024 * 4] * 2
        assert r["rank_cycle"] == (rows * 1024 * 4,)
        assert {k: tuple(v) for k, v in r["shard_shapes"].items()} == \
            {k: plan.shard_shape(k) for k in shapes}
    ref = make_optimizer("pd_sgdm", RDense(r_ring(KT)), p=2, use_kernel=True)
    want = ref.bytes_per_round_cycle(r_make_model(cfg).init(
        jax.random.PRNGKey(0)))
    assert per_rank[0]["worker_cycle"] == want
    whole_rows = sum(-(-int(np.prod(s)) // 1024) for s in shapes.values())
    assert want == (whole_rows * 1024 * 4,)
    extra = sum(2 * -(-int(np.prod(plan.shard_shape(k))) // 1024)
                - -(-int(np.prod(s)) // 1024) for k, s in shapes.items())
    assert 2 * rows - whole_rows == extra
    if label == "olmo":
        # every leaf splits into whole rows: no difference
        assert extra == 0


def test_tp_mid_round_resume_bit_identical(four):
    for r in four:
        res = r["checkpoint"]["resume"]
        assert res["steps_run"] == CKPT["steps"] - CKPT["stop"]
        for a, b in zip(res["unbroken"], res["resumed"]):
            _same(a, b)


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


def test_tp_checkpoint_restores_across_model_axes(four):
    """A TP checkpoint (K = 2 workers of 2 ranks) restored into a model
    axis of 1 (K′ = 4 ranks, ``restore_elastic``: workers 0-1 their own
    leaves, 2-3 those of workers 0-1), and a model-axis-1 checkpoint
    (K = 4) restored under TP (workers 0-1 their own), bit for bit."""
    for rank, r in enumerate(four):
        ck = r["checkpoint"]
        w = ck["tp_to_one"]["written"]
        got = ck["tp_to_one"]["restored"]
        for k in w:
            np.testing.assert_array_equal(got[k][0], w[k][rank % KT])
        w = ck["one_to_tp"]["written"]
        got = ck["one_to_tp"]["restored"]
        for k in w:
            np.testing.assert_array_equal(got[k], w[k][:KT])


def test_trainpack_without_tp_structs():
    """A ``TrainPack`` built without the whole worker's structs (a rank
    that holds its whole worker, as ``chip_smoke.py``'s ResNet and
    embedding packs are) takes the rank's own: the trainer's byte model
    and restore templates read them."""
    from repro_torch.launch.runtime import TrainPack
    struct = {"w": torch.empty((1, 3), device="meta")}
    state = {"m": struct, "step": torch.empty((), device="meta")}
    pack = TrainPack(model=None, opt=None, layout=None, device=None,
                     params_struct=struct, state_struct=state,
                     state_keys={}, init_fn=None, train_step=None,
                     train_round=None)
    assert pack.worker_struct is struct
    assert pack.worker_state_struct is state
