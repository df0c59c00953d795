"""MT-DSGDm and QG-DSGDm in the port against the reference, and
``SimTrainer``'s eval hook.

The smooth-model runs use a quadratic loss, ``0.5·mean((w − y)²)`` per
worker, on inputs made with numpy from a seed, so nothing flips and the
bars are tight; the reference runs its kernel rounds in Pallas interpret
mode, as tests/test_tracking.py runs them.  Where the two packages part:
``DenseComm.mix`` is a BLAS ``W @ x`` on both sides, summed in an order
neither pins, and XLA may contract ``a·b + c`` into an FMA, so the state
differs by a few ulps of its magnitude (each test states what it
measured).  The sign codec's scale sums in an order the reference does not
pin (a few ulps, tests/test_torch_compression.py).  Bytes per round are
exact.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import make_optimizer as r_make_optimizer  # noqa: E402
from repro.core.compression import SignCompressor as RSign  # noqa: E402
from repro.core.compression import TopKCompressor as RTopK  # noqa: E402
from repro.core.gossip import DenseComm as RDenseComm  # noqa: E402
from repro.core.topology import (  # noqa: E402
    one_peer_exponential_schedule as r_one_peer)
from repro.core.topology import ring as r_ring  # noqa: E402
from repro.data.synthetic import ClassStreamCfg as RCfg  # noqa: E402
from repro.data.synthetic import class_batch as r_class_batch  # noqa: E402
from repro.models import resnet as r_resnet  # noqa: E402
from repro.train.trainer import SimTrainer as RSimTrainer  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import (DenseComm, MTDSGDMConfig,  # noqa: E402
                              MTDSGDm, PDSGDM, QGDSGDMConfig, QGDSGDm,
                              RandKCompressor, SignCompressor,
                              TopKCompressor, exponential, full_membership,
                              make_optimizer, make_schedule, ring)
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.kernels.gossip_mix import gossip_mix  # noqa: E402
from repro_torch.kernels.momentum import momentum_update  # noqa: E402
from repro_torch.kernels.sign_compress import sign_pack, sign_unpack  # noqa: E402
from repro_torch.models.resnet import resnet20_init, resnet20_loss  # noqa: E402
from repro_torch.train.trainer import SimTrainer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small tensor ops: the
    suite runs several test processes at once, and a thread pool per
    process on the shared cores makes every small op wait at its barrier
    (under the parallel run this file took 20x its time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


K, P, STEPS = 8, 4, 9
# noniid_sweep.py's step: at η = 0.1 MT's tracked direction diverges at p = 4
HYPER = dict(eta=0.05, mu=0.9, p=P, weight_decay=1e-4)
_COUNTERS = (momentum_update, gossip_mix, sign_pack, sign_unpack)
_EXTRAS = ("m", "c", "g_prev", "xprev")


def _launches():
    return tuple(f.launches for f in _COUNTERS)


def _compressors(kind):
    """(reference compressor, port compressor) of one correction wire."""
    return {None: (None, None),
            "sign": (RSign(), SignCompressor()),
            "topk": (RTopK(fraction=0.1), TopKCompressor(fraction=0.1))}[kind]


CASES = [("mt_dsgdm", None), ("mt_dsgdm", "sign"), ("mt_dsgdm", "topk"),
         ("qg_dsgdm", None)]


# ------------------------------------------------------------ smooth model
def _quad_setup(seed=0):
    """Per-worker params that differ, and 9 steps of per-worker targets
    (heterogeneous: every worker's optimum is its own)."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((K, 2500), dtype=np.float32),
              "b": rng.standard_normal((K, 7), dtype=np.float32)}
    batches = [{"y": rng.standard_normal((K, 2500), dtype=np.float32),
                "c": rng.standard_normal((K, 7), dtype=np.float32)}
               for _ in range(STEPS)]
    return params, batches


def _quad_loss_jax(p, b):
    return (0.5 * jnp.mean((p["w"] - b["y"]) ** 2)
            + 0.5 * jnp.mean((p["b"] - b["c"]) ** 2)), {}


def _quad_loss_torch(p, b):
    return (0.5 * torch.mean((p["w"] - b["y"]) ** 2)
            + 0.5 * torch.mean((p["b"] - b["c"]) ** 2)), {}


def _quad_eval(avg):
    """Worker 0's squared distance to the origin (every worker holds the
    average), for either package's arrays."""
    return 0.5 * float((avg["w"][0] ** 2).mean() + (avg["b"][0] ** 2).mean())


def _port_quad(name, kind, use_kernel, comm=None, **kw):
    params, batches = _quad_setup()
    opt = make_optimizer(name, comm or DenseComm(ring(K), device="cpu"),
                         use_kernel=use_kernel,
                         compressor=_compressors(kind)[1], **HYPER)
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    out = SimTrainer(_quad_loss_torch, opt, device="cpu").train(
        params_from_reference(params, "cpu"), lambda t: tb[t], STEPS,
        log_every=1, **kw)
    return (opt,) + out


@functools.lru_cache(maxsize=None)
def _ref_quad(name, kind, use_kernel):
    params, batches = _quad_setup()
    opt = r_make_optimizer(name, RDenseComm(r_ring(K)), use_kernel=use_kernel,
                           kernel_interpret=True,
                           compressor=_compressors(kind)[0], **HYPER)
    p, s, hist = RSimTrainer(_quad_loss_jax, opt).train(
        jax.tree_util.tree_map(jnp.asarray, params),
        lambda t: jax.tree_util.tree_map(jnp.asarray, batches[t]), STEPS,
        log_every=1, eval_fn=_quad_eval)
    state = {k: jax.tree_util.tree_map(np.asarray, s[k]) for k in _EXTRAS
             if k in s}
    return jax.tree_util.tree_map(np.asarray, p), state, hist


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name,kind", CASES)
def test_matches_reference_on_a_smooth_model(name, kind, use_kernel):
    """9 steps (2 rounds of p = 4 and a 1-step tail) through SimTrainer
    with the eval hook on, on the tree and on the kernel layout, against
    the reference's run at the same setting.  Measured: losses 2.0e-7
    relative at most, eval values 1.9e-7, params 2.4e-7 apart, m 3.0e-7
    (entries up to 1.3), c 6.0e-8, ĝ_prev 3.0e-8, x_prev 2.4e-7.  The sign
    and top-k correction wires decide every element alike on both
    sides."""
    before = _launches()
    _, got, state, hist = _port_quad(name, kind, use_kernel,
                                     eval_fn=_quad_eval)
    assert _launches() == before                    # CPU: plain versions
    want, rstate, rhist = _ref_quad(name, kind, use_kernel)
    assert hist.steps == rhist.steps == list(range(STEPS))
    assert hist.comm_mb == rhist.comm_mb
    assert int(state["step"]) == STEPS
    np.testing.assert_allclose(hist.loss, rhist.loss, rtol=1e-5)
    np.testing.assert_allclose(hist.eval_metric, rhist.eval_metric,
                               rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-6)
    assert set(rstate) == set(k for k in _EXTRAS if k in state)
    for key, tree in rstate.items():
        for k in tree:
            np.testing.assert_allclose(state[key][k].numpy(), tree[k],
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{key}/{k}")


# ------------------------------------------------ kernel round ≡ tree round
def _ragged_params(k=4):
    """A multi-leaf tree whose leaves end mid-row (mirrors
    tests/test_tracking.py::_run_kernel_rounds)."""
    rng = np.random.default_rng(0)
    return {"w1": rng.standard_normal((k, 33, 65), dtype=np.float32),
            "w2": rng.standard_normal((k, 7), dtype=np.float32),
            "w3": rng.standard_normal((k, 2, 5, 11), dtype=np.float32)}


def _ragged_rounds(opt, k=4, p=4, rounds=2):
    params = {n: torch.from_numpy(v) for n, v in _ragged_params(k).items()}
    rng = np.random.default_rng(9)
    targets = torch.from_numpy(rng.standard_normal((p, k), dtype=np.float32))

    def grads_fn(pp, batch):
        t = batch["t"][:, None]
        grads = {n: (x - t.reshape((k,) + (1,) * (x.dim() - 1)))
                 for n, x in pp.items()}
        loss = sum(0.5 * ((x - t.reshape((k,) + (1,) * (x.dim() - 1))) ** 2
                          ).sum() for x in pp.values()) / k
        return loss, grads

    state = opt.init(params)
    for _ in range(rounds):
        params, state, losses = opt.round(state, params, grads_fn,
                                          {"t": targets})
    return params, state, losses


@pytest.mark.parametrize("name,kind", CASES + [("mt_dsgdm", "sign64")])
def test_kernel_round_equals_tree_round(name, kind):
    """Two fused rounds on the kernel layout against the tree rounds of the
    port itself, at tests/test_tracking.py's bar (atol 2e-5): params, m
    and the tracking state; the losses (up to 5,014) at rtol 1e-6.  The
    local steps round as the tree's ops do; the gossip differs, the kernel
    layout summing the shifted views left to right and the tree taking
    ``W @ x``.  Measured: 2.9e-6 at most (m, entries up to 11.6), losses
    6e-8 relative.  A sign block other than the lane falls back to the
    tree comm at the boundary: bit-identical."""
    comp = (SignCompressor(block=64) if kind == "sign64"
            else _compressors(kind)[1])
    outs = []
    for uk in (False, True):
        opt = make_optimizer(name, DenseComm(ring(4), device="cpu"),
                             compressor=comp, use_kernel=uk, **HYPER)
        outs.append(_ragged_rounds(opt))
    assert opt.kernel_comm_supported == (kind != "sign64")
    (pa, sa, la), (pb, sb, lb) = outs
    assert int(sb["step"]) == 2 * P
    np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=1e-6)
    for key in ("m",) + tuple(k for k in ("c", "g_prev", "xprev") if k in sa):
        for n in pa:
            np.testing.assert_allclose(sa[key][n].numpy(), sb[key][n].numpy(),
                                       atol=2e-5, err_msg=f"{key}/{n}")
    for n in pa:
        np.testing.assert_allclose(pa[n].numpy(), pb[n].numpy(), atol=2e-5)


def test_randk_tracking_falls_back_to_the_tree_comm():
    """rand-k has no rows format: ``kernel_comm_supported`` is False and
    the kernel round ends with the tree comm at the boundary, on the same
    trajectory as the tree round (tests/test_tracking.py's bar)."""
    outs = []
    for uk in (False, True):
        opt = MTDSGDm(MTDSGDMConfig(eta=0.05, mu=0.9, p=2, use_kernel=uk),
                      DenseComm(ring(4), device="cpu"),
                      RandKCompressor(fraction=0.2))
        outs.append(_ragged_rounds(opt, p=2))
    assert not opt.kernel_comm_supported and opt._counts == {}
    for n in outs[0][0]:
        np.testing.assert_allclose(outs[0][0][n].numpy(),
                                   outs[1][0][n].numpy(), atol=2e-5)
        np.testing.assert_allclose(outs[0][1]["c"][n].numpy(),
                                   outs[1][1]["c"][n].numpy(), atol=2e-5)


# ----------------------------------------------------------- algorithm
def _hetero(scale=1.0, d=80):
    """F_k(x) = ||x − b_k||²/2 with very different b_k: the global optimum
    is mean(b), every local gradient points at its own b_k."""
    rng = np.random.default_rng(3)
    b = torch.from_numpy(scale * rng.standard_normal((K, d)).astype(np.float32))

    def grads_fn(params, batch):
        return (0.5 * ((params["w"] - b) ** 2).sum(-1).mean(),
                {"w": params["w"] - b})

    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (K, d)).astype(np.float32))
    return grads_fn, b, {"w": x0}


def _per_step(opt, grads_fn, params, steps):
    """The per-step schedule: a local step, and a gossip after step t
    where mod(t+1, p) == 0."""
    state = opt.init(params)
    for t in range(steps):
        params, state = opt.local_step(state, params,
                                       grads_fn(params, None)[1])
        if (t + 1) % opt.config.p == 0:
            params, state = opt.comm_round(state, params)
    return params, state


def test_tracking_invariant_mean_c_equals_mean_gradient():
    """After every local step and every gossip, mean_k c = mean_k ĝ (the
    latest folded gradients): c₀ = ĝ₋₁ = 0 sets it, the local update and
    the doubly stochastic mix keep it (measured: 2.3e-7 apart at most, on
    entries up to 1.2).  Also at the end of each kernel round."""
    opt = MTDSGDm(MTDSGDMConfig(eta=0.05, mu=0.9, p=P, weight_decay=1e-4),
                  DenseComm(ring(K), device="cpu"))
    grads_fn, _, params = _hetero()
    state = opt.init(params)
    for t in range(2 * P + 1):                  # crosses two gossip rounds
        g = grads_fn(params, None)[1]
        ghat = g["w"] + 1e-4 * params["w"]
        params, state = opt.local_step(state, params, g)
        if (t + 1) % P == 0:
            params, state = opt.comm_round(state, params)
        np.testing.assert_allclose(state["c"]["w"].mean(0).numpy(),
                                   ghat.mean(0).numpy(), rtol=1e-5,
                                   atol=1e-6)
    kopt = MTDSGDm(MTDSGDMConfig(eta=0.05, mu=0.9, p=P, weight_decay=1e-4,
                                 use_kernel=True),
                   DenseComm(ring(K), device="cpu"))
    _, _, params = _hetero()
    state = kopt.init(params)
    seen = []

    def spy(pp, b):
        loss, g = grads_fn(pp, b)
        seen.append(g["w"] + 1e-4 * pp["w"])
        return loss, g

    for _ in range(2):
        params, state, _ = kopt.round(state, params, spy,
                                      {"x": torch.zeros((P, 1))})
        np.testing.assert_allclose(state["c"]["w"].mean(0).numpy(),
                                   seen[-1].mean(0).numpy(), rtol=1e-5,
                                   atol=1e-6)


def _dist(params, b):
    return float(((params["w"] - b.mean(0)) ** 2).sum(-1).mean().sqrt())


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mt_beats_plain_momentum_on_heterogeneous_quadratic(use_kernel):
    """tests/test_tracking.py's claim in the port: on the heterogeneous
    quadratic over ``exponential(8)``, tracking pulls every worker to the
    global optimum, plain local momentum leaves each at its own b_k, QG
    sits between; sign-compressed tracking still beats PD."""
    grads_fn, b, x0 = _hetero(scale=3.0)
    dist = {}
    for label, name, comp in (("pd", "pd_sgdm", None), ("mt", "mt_dsgdm", None),
                              ("qg", "qg_dsgdm", None),
                              ("mt_sign", "mt_dsgdm", SignCompressor())):
        opt = make_optimizer(name, DenseComm(exponential(K), device="cpu"),
                             eta=0.05, mu=0.9, p=P, compressor=comp,
                             use_kernel=use_kernel)
        params, state = dict(x0), opt.init(x0)
        for _ in range(100):
            params, state, _ = opt.round(state, params, grads_fn,
                                         {"x": torch.zeros((P, 1))})
        dist[label] = _dist(params, b)
    assert dist["mt"] < 0.05 * dist["pd"], dist
    assert dist["qg"] < 0.5 * dist["pd"], dist
    assert dist["mt_sign"] < 0.7 * dist["pd"], dist


@pytest.mark.parametrize("kind", [None, "sign"])
def test_mt_one_peer_schedule_round_equals_per_step(kind):
    """MT on the one-peer exponential schedule (period 3): three fused rounds
    (tree and kernel layout) against the per-step schedule, and against the
    reference's per-step run; x and c follow each round's W.  Measured:
    fused (either layout) and per-step bit-identical; against the
    reference 6.0e-7 (entries up to 2.5)."""
    grads_fn, _, x0 = _hetero()
    rcomp, comp = _compressors(kind)

    def opt_of(uk):
        return MTDSGDm(MTDSGDMConfig(eta=0.05, mu=0.9, p=P, weight_decay=1e-4,
                                     use_kernel=uk),
                       DenseComm(make_schedule("one_peer_exp", (K,)),
                                 device="cpu"), comp)

    ps, ss = _per_step(opt_of(False), grads_fn, dict(x0), 3 * P)
    for uk in (False, True):
        opt = opt_of(uk)
        params, state = dict(x0), opt.init(x0)
        for _ in range(3):
            params, state, _ = opt.round(state, params, grads_fn,
                                         {"x": torch.zeros((P, 1))})
        np.testing.assert_allclose(params["w"].numpy(), ps["w"].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(state["c"]["w"].numpy(),
                                   ss["c"]["w"].numpy(), rtol=1e-6, atol=1e-6)

    ropt = r_make_optimizer("mt_dsgdm", RDenseComm(r_one_peer(K)), eta=0.05,
                            mu=0.9, p=P, weight_decay=1e-4, compressor=rcomp)
    b = jnp.asarray(_hetero()[1].numpy())
    rp = {"w": jnp.asarray(x0["w"].numpy())}
    rs = ropt.init(rp)
    step = jax.jit(lambda s, pp: ropt.step(s, pp, {"w": pp["w"] - b}))
    for _ in range(3 * P):
        rp, rs = step(rs, rp)
    np.testing.assert_allclose(ps["w"].numpy(), np.asarray(rp["w"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ss["c"]["w"].numpy(), np.asarray(rs["c"]["w"]),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ bytes
BYTES = [
    # (name, kind, use_kernel, graph, bytes per round over the cycle)
    ("mt_dsgdm", None, True, "ring", (5_079_040,)),     # 2 × 2 × 310 rows
    ("mt_dsgdm", None, False, "ring", (4_356_512,)),    # 2 × 2 × 272,282 f32
    ("mt_dsgdm", "sign", True, "ring", (2_621_360,)),   # + 2 × 40,920 B
    ("mt_dsgdm", "sign", False, "ring", (2_260_096,)),
    ("mt_dsgdm", "topk", True, "ring", (3_050_400,)),   # + 2 × 255,440 B
    ("qg_dsgdm", None, True, "ring", (2_539_520,)),
    ("qg_dsgdm", None, False, "ring", (2_178_256,)),
    ("mt_dsgdm", None, True, "one_peer", (2_178_256,) * 3),
    ("mt_dsgdm", "sign", True, "one_peer", (1_130_048,) * 3),
    ("qg_dsgdm", None, False, "one_peer", (1_089_128,) * 3),
]


@pytest.mark.parametrize("name,kind,use_kernel,graph,expected", BYTES)
def test_bytes_per_round_cycle_equal_reference(name, kind, use_kernel, graph,
                                               expected):
    """ResNet-20 at width 16, K = 8: the 2-tensor payload of MT (x on the
    kernel wire's 310 used rows or the tree's 272,282 f32, plus c at f32 or
    its codec's exact bytes) and QG's one tensor, on the ring and over the
    one-peer schedule's cycle (a time-varying graph mixes through W_r and
    ships the tree wire), exactly as the reference computes them."""
    params = resnet20_init(torch.Generator().manual_seed(0), width=16,
                           device="cpu")
    rcomp, comp = _compressors(kind)
    graph_of = {"ring": (lambda: ring(K), lambda: r_ring(K)),
                "one_peer": (lambda: make_schedule("one_peer_exp", (K,)),
                             lambda: r_one_peer(K))}[graph]
    opt = make_optimizer(name, DenseComm(graph_of[0](), device="cpu"),
                         use_kernel=use_kernel, compressor=comp, **HYPER)
    assert opt.bytes_per_round_cycle(params) == expected
    shapes = jax.eval_shape(lambda k: r_resnet.resnet20_init(k, width=16),
                            jax.random.PRNGKey(0))
    ropt = r_make_optimizer(name, RDenseComm(graph_of[1]()),
                            use_kernel=use_kernel, compressor=rcomp, **HYPER)
    assert ropt.bytes_per_round_cycle(shapes) == expected


# ------------------------------------------------------------ construction
def test_factory_and_refusals():
    comm = DenseComm(ring(K), device="cpu")
    for alias in ("mt_dsgdm", "mt-dsgdm", "mtdsgdm", "mt"):
        opt = make_optimizer(alias, comm, eta=0.05, p=2, weight_decay=1e-4,
                             use_kernel=True)
        assert isinstance(opt, MTDSGDm) and opt.codec is None
        assert (opt.config.eta, opt.config.p, opt.config.weight_decay) == \
            (0.05, 2, 1e-4) and opt.config.use_kernel
    for alias in ("qg_dsgdm", "qgdsgdm", "qg"):
        assert isinstance(make_optimizer(alias, comm), QGDSGDm)
    assert make_optimizer("mt", comm,
                          compressor=SignCompressor()).codec.name == "sign"
    assert isinstance(make_optimizer("mt", comm), PDSGDM)
    with pytest.raises(ValueError, match="nesterov"):
        QGDSGDm(QGDSGDMConfig(nesterov=True), comm)
    with pytest.raises(ValueError, match="overlap"):
        MTDSGDm(MTDSGDMConfig(overlap=True), comm, SignCompressor())
    # overlapped rounds (tests/test_torch_overlap.py): MT drips, QG folds
    for name in ("mt_dsgdm", "qg_dsgdm"):
        opt = make_optimizer(name, comm, overlap=True)
        assert opt.config.overlap
        assert opt.overlap_refreshes == (name == "mt_dsgdm")
    assert "buf_c" in make_optimizer("mt", comm, overlap=True).init(
        {"w": torch.zeros(K, 3)})["mix"]
    churn = DenseComm(ring(K), membership=full_membership(K), device="cpu")
    tree = {"w": torch.arange(3.0 * K).reshape(K, 3)}
    assert torch.equal(churn.stale_mix(tree, r=0)["w"], churn.mix(tree)["w"])
    # MT's per-level bytes on a hierarchical graph double PD's (the (x, c)
    # pair; tests/test_torch_hierarchical.py holds them against the
    # reference)
    hier = DenseComm(make_topology("hierarchical", (2, 2)), device="cpu")
    opt = make_optimizer("mt", hier)
    w = {"w": torch.zeros(10)}
    pd_levels = make_optimizer("pd_sgdm", hier).hier_bytes_per_level(w)
    assert opt.hier_bytes_per_level(w) == {k: 2 * v
                                           for k, v in pd_levels.items()}
    assert opt.bytes_per_comm_round(w) == 2 * pd_levels["inter"] == 40.0


# ------------------------------------------------------------ eval hook
def test_eval_fn_one_value_per_log_point_on_the_average():
    """One eval value per log step, taken on the worker average re-stacked
    over the K workers at the end of the round (or tail) holding the log
    point; ``rows()`` pairs them; ``rounds_per_log`` > 1 is refused."""
    seen = []

    def eval_fn(avg):
        seen.append({k: v.clone() for k, v in avg.items()})
        return float(avg["w"].sum())

    _, got, _, hist = _port_quad("pd_sgdm", None, True, eval_fn=eval_fn)
    assert hist.steps == list(range(STEPS))
    assert len(hist.eval_metric) == STEPS
    # two rounds and the tail: one eval a block, shared by its log steps
    assert len(seen) == 3
    assert hist.eval_metric[:P] == [hist.eval_metric[0]] * P
    final = seen[-1]
    for k, v in final.items():
        assert v.shape == got[k].shape
        mean = got[k].mean(0)
        for i in range(K):
            assert torch.equal(v[i], mean)
    assert hist.eval_metric[-1] == float(final["w"].sum())
    rows = list(hist.rows())
    assert [r["step"] for r in rows] == hist.steps
    assert [r["eval"] for r in rows] == hist.eval_metric
    assert [r["comm_mb"] for r in rows] == hist.comm_mb
    assert all(r["eval"] is None for r in _port_quad("pd_sgdm", None,
                                                     True)[3].rows())
    for where in ("init", "train"):
        opt = make_optimizer("pd_sgdm", DenseComm(ring(K), device="cpu"))
        trainer = SimTrainer(_quad_loss_torch, opt, device="cpu",
                             rounds_per_log=2 if where == "init" else None)
        with pytest.raises(ValueError, match="rounds_per_log=1"):
            trainer.train(params_from_reference(_quad_setup()[0], "cpu"),
                          lambda t: None, STEPS, eval_fn=eval_fn,
                          **({"rounds_per_log": 2} if where == "train"
                             else {}))
    # log every 5: one eval for each block that holds steps 0, 5 and 8
    params, batches = _quad_setup()
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    opt = make_optimizer("pd_sgdm", DenseComm(ring(K), device="cpu"), **HYPER)
    seen.clear()
    _, _, hist = SimTrainer(_quad_loss_torch, opt, device="cpu").train(
        params_from_reference(params, "cpu"), lambda t: tb[t], STEPS,
        log_every=5, eval_fn=eval_fn)
    assert hist.steps == [0, 5, 8] and len(hist.eval_metric) == 3
    assert len(seen) == 3


# ---------------------------------------------- ResNet-20, non-IID, eval
WIDTH, BATCH, ALPHA = 4, 2, 0.1


@functools.lru_cache(maxsize=None)
def _resnet_setup():
    """Stacked reference params, 9 steps of Dirichlet(0.1) class batches
    and two IID eval batches of the same class means (numpy), as
    benchmarks/noniid_sweep.py draws them."""
    init = jax.jit(r_resnet.resnet20_init, static_argnames=("width",))
    p = init(jax.random.PRNGKey(0), width=WIDTH)
    stacked = jax.tree_util.tree_map(
        lambda x: np.array(jnp.broadcast_to(x[None], (K,) + x.shape)), p)
    fn = jax.jit(r_class_batch, static_argnums=0)
    cfg = RCfg(batch=BATCH, n_workers=K, seed=0, dirichlet_alpha=ALPHA)
    batches = [jax.tree_util.tree_map(np.array, fn(cfg, t))
               for t in range(STEPS)]
    ecfg = RCfg(batch=BATCH, n_workers=K, seed=0)
    evals = [jax.tree_util.tree_map(np.array, fn(ecfg, 10_000 + i))
             for i in range(2)]
    return stacked, batches, evals


@functools.lru_cache(maxsize=None)
def _resnet_ref(name):
    stacked, batches, evals = _resnet_setup()
    vloss = jax.jit(jax.vmap(lambda p, b: r_resnet.resnet20_loss(p, b)[0]))

    def eval_fn(avg):
        return float(np.mean([float(vloss(avg, b).mean()) for b in evals]))

    opt = r_make_optimizer(name, RDenseComm(r_ring(K)), use_kernel=True,
                           kernel_interpret=True, **HYPER)
    params, _, hist = RSimTrainer(r_resnet.resnet20_loss, opt).train(
        jax.tree_util.tree_map(jnp.asarray, stacked),
        lambda t: jax.tree_util.tree_map(jnp.asarray, batches[t]), STEPS,
        log_every=4, eval_fn=eval_fn)
    return jax.tree_util.tree_map(np.asarray, params), hist


def _rel_l2(ours: dict, theirs: dict) -> float:
    diff = sum(float(((ours[n] - theirs[n]) ** 2).sum()) for n in theirs)
    norm = sum(float((theirs[n] ** 2).sum()) for n in theirs)
    return (diff / norm) ** 0.5


@pytest.mark.parametrize("name", ["mt_dsgdm", "qg_dsgdm"])
def test_resnet_noniid_run_with_eval_matches_reference(name):
    """The slice end to end at a small size: ResNet-20 width 4, K = 8 ring,
    batch 2 of Dirichlet(0.1) labels, η = 0.05, p = 4, 9 steps on the
    kernel layout, judged by ``eval_fn`` (the global loss of the averaged
    model on two IID batches, as benchmarks/noniid_sweep.py judges).  The
    runs part only by the ReLU flips of tests/test_torch_pdsgdm.py.
    Measured, MT (QG): first losses equal, losses 4.9e-4 (6.0e-5)
    relative at most, eval values 8.3e-4 (1.3e-5), params 3.3e-3 (3.0e-4)
    apart in relative L2."""
    stacked, batches, evals = _resnet_setup()
    tb = [{"images": torch.from_numpy(b["images"]),
           "labels": torch.from_numpy(b["labels"]).long()} for b in batches]
    te = [{"images": torch.from_numpy(b["images"]),
           "labels": torch.from_numpy(b["labels"]).long()} for b in evals]
    vloss = torch.func.vmap(lambda p, b: resnet20_loss(p, b)[0])

    def eval_fn(avg):
        with torch.no_grad():
            return float(np.mean([float(vloss(avg, b).mean()) for b in te]))

    opt = make_optimizer(name, DenseComm(ring(K), device="cpu"),
                         use_kernel=True, **HYPER)
    before = _launches()
    params, state, hist = SimTrainer(resnet20_loss, opt, device="cpu").train(
        params_from_reference(stacked, "cpu"), lambda t: tb[t], STEPS,
        log_every=4, eval_fn=eval_fn)
    assert _launches() == before
    rparams, rhist = _resnet_ref(name)
    assert hist.steps == rhist.steps == [0, 4, 8]
    assert hist.comm_mb == rhist.comm_mb
    np.testing.assert_allclose(hist.loss[0], rhist.loss[0], rtol=1e-5)
    np.testing.assert_allclose(hist.loss, rhist.loss, rtol=1e-2)
    np.testing.assert_allclose(hist.eval_metric, rhist.eval_metric,
                               rtol=1e-2)
    assert _rel_l2(params, params_from_reference(rparams, "cpu")) < 5e-2
