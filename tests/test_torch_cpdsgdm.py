"""CPD-SGDM (Algorithm 2) in the port against the reference, with the sign,
QSGD and top-k wires.

Setup as in tests/test_torch_pdsgdm.py: ResNet-20 at width 4, K = 8 on
``ring(8)``, p = 4, batch 2 per worker, 9 steps (2 rounds and a 1-step
tail), η = 0.1, μ = 0.9, weight decay 1e-4, γ = 0.4 (0.2 for Fig. 3's
top-10 % wire), from the reference's params on the reference's batches.
Bytes and comm-MB are exact.

Where the two packages can part (each test says how far):

* the consensus ``W @ x̂`` is a BLAS product on both sides, summed in an
  order neither pins, and XLA may contract ``x + γ·(mix − x̂)`` into an
  FMA, so the round's params differ by an ulp or two;
* the drift ``x_new − x̂`` can lie within that ulp of zero (a sign bit
  flips, moving x̂ by 2·scale there) or of a QSGD rounding tie (a level
  moves by one, moving x̂ by norm/s); the round-level bars admit exactly
  those elements and hold every other one to a few ulps;
* the reference's sign scale sums with ``jnp.sum`` (few ulps, see
  tests/test_torch_compression.py);
* on ResNet-20 a ReLU input within rounding of zero flips a gradient, as
  tests/test_torch_pdsgdm.py finds for PD-SGDM; the trainer bars cover
  that.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import make_optimizer as r_make_optimizer  # noqa: E402
from repro.core.compression import QSGDCompressor as RQSGD  # noqa: E402
from repro.core.compression import SignCompressor as RSign  # noqa: E402
from repro.core.compression import TopKCompressor as RTopK  # noqa: E402
from repro.core.gossip import DenseComm as RDenseComm  # noqa: E402
from repro.core.topology import ring as r_ring  # noqa: E402
from repro.data.synthetic import ClassStreamCfg as RCfg  # noqa: E402
from repro.data.synthetic import class_batch as r_class_batch  # noqa: E402
from repro.kernels.ops import KernelPlan as RPlan  # noqa: E402
from repro.models import resnet as r_resnet  # noqa: E402
from repro.train.trainer import SimTrainer as RSimTrainer  # noqa: E402
from repro_torch.convert import (params_from_reference,  # noqa: E402
                                 state_from_reference)
from repro_torch.core import (CPDSGDM, CSGDM, DenseComm,  # noqa: E402
                              IdentityCompressor, MTDSGDm, QGDSGDm,
                              QSGDCompressor,
                              SignCompressor, TopKCompressor,
                              full_membership, make_optimizer,
                              make_schedule, make_topology, ring)
from repro_torch.kernels.gossip_mix import gossip_mix  # noqa: E402
from repro_torch.kernels.momentum import momentum_update  # noqa: E402
from repro_torch.kernels.ops import KernelPlan  # noqa: E402
from repro_torch.kernels.qsgd_quant import qsgd_dequant, qsgd_quant  # noqa: E402
from repro_torch.kernels.sign_compress import sign_pack, sign_unpack  # noqa: E402
from repro_torch.kernels.topk_select import topk_scatter, topk_select  # noqa: E402
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


WIDTH, K, BATCH, P, STEPS = 4, 8, 2, 4, 9
HYPER = dict(eta=0.1, mu=0.9, p=P, weight_decay=1e-4, gamma=0.4)
GAMMA = np.float32(HYPER["gamma"])
_COUNTERS = (momentum_update, gossip_mix, sign_pack, sign_unpack, qsgd_quant,
             qsgd_dequant, topk_select, topk_scatter)


def _compressors(kind):
    """(reference compressor, port compressor) of one wire."""
    return {"sign": (RSign(), SignCompressor()),
            "qsgd": (RQSGD(levels=7), QSGDCompressor(levels=7)),
            "sign64": (RSign(block=64), SignCompressor(block=64)),
            "topk": (RTopK(fraction=0.1), TopKCompressor(fraction=0.1))}[kind]


def _hyper(kind):
    """The run's hyper-parameters: Fig. 3 runs its top-10 % wire at
    γ = 0.2 (benchmarks/fig3_cpdsgdm.py:20-22)."""
    return dict(HYPER, gamma=0.2) if kind == "topk" else HYPER


def _launches():
    return tuple(f.launches for f in _COUNTERS)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@functools.lru_cache(maxsize=None)
def _ref_setup():
    """Stacked reference ResNet params and the run's batches (numpy)."""
    init = jax.jit(r_resnet.resnet20_init, static_argnames=("width",))
    p = init(jax.random.PRNGKey(0), width=WIDTH)
    stacked = jax.tree_util.tree_map(
        lambda x: np.array(jnp.broadcast_to(x[None], (K,) + x.shape)), p)
    cfg = RCfg(batch=BATCH, n_workers=K, seed=0)
    fn = jax.jit(r_class_batch, static_argnums=0)
    batches = [_np_tree(fn(cfg, t)) for t in range(STEPS)]
    return stacked, batches


def _smooth_setup():
    """Softmax regression on the same batches: no ReLU, nothing flips."""
    rng = np.random.default_rng(0)
    p0 = {"b": np.zeros((10,), np.float32),
          "w": (0.01 * rng.standard_normal((32 * 32 * 3, 10))
                ).astype(np.float32)}
    return {k: np.broadcast_to(v[None], (K,) + v.shape).copy()
            for k, v in p0.items()}


def _linear_loss_torch(p, b):
    x = b["images"].reshape(b["images"].shape[0], -1) / 32.0
    logp = torch.log_softmax(x @ p["w"] + p["b"], dim=-1)
    return -logp.gather(-1, b["labels"][:, None].long())[:, 0].mean(), {}


def _linear_loss_jax(p, b):
    x = b["images"].reshape(b["images"].shape[0], -1) / 32.0
    logp = jax.nn.log_softmax(x @ p["w"] + p["b"])
    return -jnp.take_along_axis(logp, b["labels"][:, None],
                                axis=-1)[:, 0].mean(), {}


MODELS = {"resnet": (lambda: _ref_setup()[0], r_resnet.resnet20_loss,
                     resnet20_loss),
          "smooth": (_smooth_setup, _linear_loss_jax, _linear_loss_torch)}


def _port_batch_fn():
    tb = [{"images": torch.from_numpy(b["images"]),
           "labels": torch.from_numpy(b["labels"]).long()}
          for b in _ref_setup()[1]]
    return lambda t: tb[t]


def _port_run(kind, model="resnet", use_kernel=True, steps=STEPS):
    init, _, loss = MODELS[model]
    opt = make_optimizer("cpd_sgdm", DenseComm(ring(K), device="cpu"),
                         use_kernel=use_kernel,
                         compressor=_compressors(kind)[1], **_hyper(kind))
    out = SimTrainer(loss, opt, device="cpu").train(
        params_from_reference(init(), "cpu"), _port_batch_fn(), steps,
        log_every=1)
    return (opt,) + out


@functools.lru_cache(maxsize=None)
def _ref_run(kind, model="resnet"):
    init, loss, _ = MODELS[model]
    _, batches = _ref_setup()
    opt = r_make_optimizer("cpd_sgdm", RDenseComm(r_ring(K)), use_kernel=True,
                           kernel_interpret=True,
                           compressor=_compressors(kind)[0], **_hyper(kind))
    params, state, hist = RSimTrainer(loss, opt).train(
        jax.tree_util.tree_map(jnp.asarray, init()),
        lambda t: jax.tree_util.tree_map(jnp.asarray, batches[t]), STEPS,
        log_every=1)
    return _np_tree(params), _np_tree(state["xhat"]), hist


def _rel_l2(ours: dict, theirs: dict) -> float:
    diff = sum(float(((ours[n] - theirs[n]) ** 2).sum()) for n in theirs)
    norm = sum(float((theirs[n] ** 2).sum()) for n in theirs)
    return (diff / norm) ** 0.5


def _spacing(a):
    return np.spacing(np.abs(np.asarray(a, np.float32)))


# ------------------------------------------------------------ one round
def _round_inputs():
    """Per-worker params x and stored copies x̂ that differ from them: the
    drift x_new − x̂ then spans several scales and signs."""
    stacked, _ = _ref_setup()
    rng = np.random.default_rng(1)
    x = jax.tree_util.tree_map(
        lambda a: a + 0.01 * rng.standard_normal(a.shape).astype(np.float32),
        stacked)
    xh = jax.tree_util.tree_map(
        lambda a: a + 0.01 * rng.standard_normal(a.shape).astype(np.float32),
        x)
    return x, xh


@pytest.mark.parametrize("kind", ["sign", "qsgd"])
def test_comm_round_mat_matches_reference(kind):
    """One kernel-layout comm round of both packages from the same x and
    x̂ (the port's x̂ through ``state_from_reference``).  Measured on these
    inputs: x_new 1.2e-7 apart at most (6,176 elements differ, each by an
    ulp of its magnitude), x̂ 1.2e-7; no sign bit moved, and one QSGD
    element lay close enough to a tie to be admitted (it did not move)."""
    x, xh = _round_inputs()
    rcomp, comp = _compressors(kind)
    ropt = r_make_optimizer("cpd_sgdm", RDenseComm(r_ring(K)), use_kernel=True,
                            kernel_interpret=True, compressor=rcomp, **HYPER)
    rstate = ropt.init(jax.tree_util.tree_map(jnp.asarray, x))
    rstate["xhat"] = jax.tree_util.tree_map(jnp.asarray, xh)
    rplan = RPlan.for_tree(rstate["xhat"], worker_dim=True)
    rx = rplan.flatten(jax.tree_util.tree_map(jnp.asarray, x))
    rxn, rmats = ropt.comm_round_mat(rx, ropt.mat_state(rplan, rstate),
                                     rplan.row_counts(), 0, plan=rplan)

    opt = make_optimizer("cpd_sgdm", DenseComm(ring(K), device="cpu"),
                         use_kernel=True, compressor=comp, **HYPER)
    state = state_from_reference(_np_tree(rstate), "cpu")
    px = params_from_reference(x, "cpu")
    plan = KernelPlan.for_tree(px, worker_dim=True)
    xm = plan.flatten(px)
    before = _launches()
    xn, mats = opt.comm_round_mat(xm, opt.mat_state(plan, state),
                                  opt.row_counts(plan, xm), 0, plan=plan)
    assert _launches() == before                    # CPU: plain versions

    xh_m = plan.flatten(state["xhat"]).numpy().reshape(K, -1)
    x_m = xm.numpy().reshape(K, -1)
    W = np.abs(opt.comm.topology.W)
    magnitude = np.abs(x_m) + GAMMA * (W @ np.abs(xh_m) + np.abs(xh_m))
    got, want = xn.numpy().reshape(K, -1), np.asarray(rxn).reshape(K, -1)
    dx = np.abs(got.astype(np.float64) - want)
    assert np.all(dx <= 2 * _spacing(magnitude))

    # the drift each package encodes, and what its codec may decide
    # differently: a sign where |d| ≤ |Δd|, a QSGD level where d·s/norm is
    # within the perturbation of a half-integer
    d_ref = want - xh_m
    d_got = got - xh_m
    dd = np.abs(d_got.astype(np.float64) - d_ref)
    rows = d_ref.reshape(K, plan.rows, -1)
    dd_row = dd.reshape(K, plan.rows, -1).max(-1, keepdims=True)
    if kind == "sign":
        scale = np.abs(rows).sum(-1, keepdims=True) / np.maximum(
            plan.row_counts().numpy()[None], 1)
        may_move = (np.signbit(d_got) != np.signbit(d_ref)).reshape(rows.shape)
        assert np.all(np.abs(rows[may_move]) <= dd.reshape(rows.shape)[may_move])
        quantum = 2 * scale
        tol = 16 * _spacing(scale) + dd_row
    else:
        s = np.float32(comp.levels)
        norm = np.abs(rows).max(-1, keepdims=True)
        t = rows.astype(np.float64) * s / np.maximum(norm, 1e-30)
        may_move = np.abs(np.abs(t - np.floor(t)) - 0.5) <= \
            s * (dd_row + _spacing(norm)) / np.maximum(norm, 1e-30) + 1e-6
        quantum = norm / s
        tol = 2 * _spacing(norm) + dd_row
    hx_got = mats["xhat"].numpy().reshape(rows.shape)
    hx_want = np.asarray(rmats["xhat"]).reshape(rows.shape)
    gap = np.abs(hx_got.astype(np.float64) - hx_want)
    allowed = 2 * _spacing(hx_want) + tol + np.where(may_move, quantum, 0.0)
    assert np.all(gap <= allowed)
    assert int(may_move.sum()) <= 1e-4 * may_move.size


# ------------------------------------------------------------ trainers
@pytest.mark.parametrize("kind", ["sign", "qsgd", "topk"])
def test_trainer_matches_reference_on_a_smooth_model(kind):
    """SimTrainer of both packages on the kernel layout, softmax regression
    as the model: nothing flips, so the bars are tight (measured, for the
    sign and QSGD wires: losses 2.4e-7 apart at most, params 1.2e-7, x̂
    6.0e-8; top-k at f = 0.1, γ = 0.2: 2.4e-7, 1.2e-7 and 8.9e-8, every
    slot the same).  A near-tie at a top-k row's W-th place, on opposite
    sides in the two packages, would swap one slot: x̂ then differs in a
    handful of elements, each by at most 2·max|x̂ − x₀|, which is the bar
    for x̂ beyond rtol 1e-3 / atol 1e-4 (at most 4 such elements)."""
    opt, params, state, hist = _port_run(kind, "smooth")
    rparams, rxhat, rhist = _ref_run(kind, "smooth")
    np.testing.assert_allclose(hist.loss, rhist.loss, rtol=1e-4)
    assert hist.comm_mb == rhist.comm_mb
    init = MODELS["smooth"][0]()
    drift = max(float(np.abs(rxhat[n] - init[n]).max()) for n in rxhat)
    moved = 0
    for name in params:
        np.testing.assert_allclose(params[name].numpy(), rparams[name],
                                   rtol=1e-3, atol=1e-4)
        ours = state["xhat"][name].numpy()
        far = ~np.isclose(ours, rxhat[name], rtol=1e-3, atol=1e-4)
        assert np.all(np.abs(ours - rxhat[name])[far] <= 2 * drift)
        moved += int(far.sum())
    assert moved <= (4 if kind == "topk" else 0)


@pytest.mark.parametrize("kind", ["sign", "qsgd"])
def test_kernel_round_trainer_matches_reference(kind):
    """ResNet-20 end to end.  The first three losses agree to 1e-6; at
    step 3 the ReLU flip of tests/test_torch_pdsgdm.py (a block output
    within 1e-6 of zero, on opposite sides in the two packages' f32
    convolutions) parts the runs.  Measured: loss gap 1.0e-2 (sign) and 1.1e-2 (QSGD) by step 8,
    final params 2.3e-2 apart in relative L2, x̂ 3.6e-2 (sign) and 2.3e-2
    (QSGD).  The bars cover that; the optimizer itself is held tightly by
    the smooth-model and one-round tests."""
    before = _launches()
    opt, params, state, hist = _port_run(kind)
    assert _launches() == before
    rparams, rxhat, rhist = _ref_run(kind)
    assert hist.steps == rhist.steps == list(range(STEPS))
    np.testing.assert_allclose(hist.loss[:3], rhist.loss[:3], rtol=1e-5)
    np.testing.assert_allclose(hist.loss, rhist.loss, rtol=1e-2)
    assert hist.comm_mb == rhist.comm_mb
    assert int(state["step"]) == STEPS
    assert list(params) == list(params_from_reference(rparams, "cpu"))
    assert _rel_l2(params, params_from_reference(rparams, "cpu")) < 5e-2
    assert _rel_l2(state["xhat"], params_from_reference(rxhat, "cpu")) < 5e-2
    # one device copy of the tiled row counts, reused by every round
    assert len(opt._counts) == 1


@pytest.mark.parametrize("kind", ["sign", "qsgd", "topk"])
def test_kernel_path_equals_tree_path(kind):
    """The port's kernel round against its own tree round.  The p local
    steps are bit-identical; both wires pack the same drift on the same
    kernel rows.  They differ only in the consensus ``W @ x̂``, one product
    over the whole matrix against one per leaf, and an 8-term product may
    round its last bit differently in the two shapes.  Measured on the CPU:
    losses, params and x̂ bit-identical after 2 rounds and a tail; held to
    rtol 1e-6 / atol 1e-7."""
    before = _launches()
    _, pk, sk, hk = _port_run(kind, use_kernel=True)
    _, pt, st, ht = _port_run(kind, use_kernel=False)
    assert _launches() == before
    assert hk.comm_mb == ht.comm_mb
    np.testing.assert_allclose(hk.loss, ht.loss, rtol=1e-6)
    for name in pk:
        np.testing.assert_allclose(pk[name].numpy(), pt[name].numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(sk["xhat"][name].numpy(),
                                   st["xhat"][name].numpy(),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["sign", "qsgd", "topk"])
def test_payload_wire_equals_kernel_wire(kind):
    """The per-leaf codec wire and the kernel wire on the same drift give
    the same x̂, bit for bit: the kernel rows are the per-leaf blocks."""
    x, xh = _round_inputs()
    opt = make_optimizer("cpd_sgdm", DenseComm(ring(K), device="cpu"),
                         compressor=_compressors(kind)[1], **_hyper(kind))
    diff = params_from_reference(x, "cpu")
    xhat = params_from_reference(xh, "cpu")
    by_rows, by_leaf = {}, {}
    opt._comm_kernel_wire(by_rows, xhat, diff)
    opt._comm_payload_wire(by_leaf, xhat, diff, 0)
    for name in xhat:
        assert torch.equal(by_rows["xhat"][name], by_leaf["xhat"][name])


@pytest.mark.parametrize("kind,use_kernel,expected", [
    ("sign", True, 81_840),          # 2 × 310 × (128 + 4)
    ("sign", False, 81_840),
    ("qsgd", True, 319_920),         # 2 × 310 × (512 + 4)
    ("sign64", True, 102_528),       # per-leaf blocks of 64
    ("topk", True, 510_880),         # 2 × 310 × 103 × (4 + 4)
    ("topk", False, 510_880),
])
def test_bytes_per_comm_round_at_full_width(kind, use_kernel, expected):
    params = resnet20_init(torch.Generator().manual_seed(0), width=16,
                           device="cpu")
    rcomp, comp = _compressors(kind)
    opt = make_optimizer("cpd_sgdm", DenseComm(ring(K), device="cpu"),
                         use_kernel=use_kernel, compressor=comp,
                         **_hyper(kind))
    assert opt.bytes_per_comm_round(params) == expected
    assert opt.bytes_per_round_cycle(params) == (expected,)
    shapes = jax.eval_shape(lambda k: r_resnet.resnet20_init(k, width=16),
                            jax.random.PRNGKey(0))
    ropt = r_make_optimizer("cpd_sgdm", RDenseComm(r_ring(K)),
                            use_kernel=use_kernel, compressor=rcomp,
                            **_hyper(kind))
    assert ropt.bytes_per_comm_round(shapes) == expected


def test_block64_falls_back_to_the_tree_comm():
    """Fig. 3's ``SignCompressor(block=64)`` has no kernel wire: the kernel
    round runs its local steps on the kernel layout, unflattens, and runs
    the tree comm round at the boundary — the tree path's round exactly,
    and the reference's within the smooth-model bars."""
    opt, pk, sk, hk = _port_run("sign64", "smooth", use_kernel=True)
    assert not opt.kernel_comm_supported and opt._counts == {}
    _, pt, st, ht = _port_run("sign64", "smooth", use_kernel=False)
    assert hk.loss == ht.loss and hk.comm_mb == ht.comm_mb
    for name in pk:
        assert torch.equal(pk[name], pt[name])
        assert torch.equal(sk["xhat"][name], st["xhat"][name])
    rparams, rxhat, rhist = _ref_run("sign64", "smooth")
    np.testing.assert_allclose(hk.loss, rhist.loss, rtol=1e-4)
    assert hk.comm_mb == rhist.comm_mb
    for name in pk:
        np.testing.assert_allclose(pk[name].numpy(), rparams[name],
                                   rtol=1e-3, atol=1e-4)


def test_identity_and_unpacked_wires():
    """The identity codec has no kernel format (per-leaf wire, tree comm
    fallback) and ships 4 B per element; ``packed_wire=False`` applies Q
    leaf-wise, the same x̂ as the codec round trip, charged at f32."""
    params = resnet20_init(torch.Generator().manual_seed(0), width=16,
                           device="cpu")
    n = sum(v.numel() for v in params.values())
    comm = DenseComm(ring(K), device="cpu")
    ident = make_optimizer("cpd_sgdm", comm, compressor=IdentityCompressor(),
                           use_kernel=True)
    assert not ident.kernel_comm_supported
    assert ident.bytes_per_comm_round(params) == 2 * 4 * n
    from repro_torch.core.cpdsgdm import CPDSGDMConfig
    raw = CPDSGDM(CPDSGDMConfig(packed_wire=False), comm, SignCompressor())
    assert raw.bytes_per_comm_round(params) == 2 * 4 * n
    x, xh = _round_inputs()
    diff = params_from_reference(x, "cpu")
    xhat = params_from_reference(xh, "cpu")
    by_q = raw._apply_Q(diff, 0)
    by_rows = {}
    make_optimizer("cpd_sgdm", comm)._comm_kernel_wire(by_rows, xhat, diff)
    for name in xhat:
        assert torch.equal(xhat[name] + by_q[name], by_rows["xhat"][name])


def test_optimizer_factory_builds_the_baselines():
    comm = DenseComm(ring(K), device="cpu")
    cpd = make_optimizer("cpd-sgdm", comm, gamma=0.5)
    assert isinstance(cpd, CPDSGDM) and cpd.config.gamma == 0.5
    assert cpd.codec.name == "sign" and cpd.kernel_comm_supported
    choco = make_optimizer("choco_sgd", comm, eta=0.05, gamma=0.3,
                           compressor=QSGDCompressor(levels=1))
    assert isinstance(choco, CPDSGDM) and choco.codec.bits == 2
    assert (choco.config.mu, choco.config.p, choco.config.gamma) == \
        (0.0, 1, 0.3)
    d = make_optimizer("d_sgd", comm, weight_decay=1e-4)
    assert (d.config.mu, d.config.p, d.config.weight_decay) == (0.0, 1, 1e-4)
    pd = make_optimizer("pd_sgd", comm, p=8)
    assert (pd.config.mu, pd.config.p) == (0.0, 8)
    assert isinstance(make_optimizer("c_sgdm", comm), CSGDM)
    # MT-DSGDm and QG-DSGDm: ported (tests/test_torch_tracking.py)
    assert isinstance(make_optimizer("mt_dsgdm", comm), MTDSGDm)
    assert isinstance(make_optimizer("qg", comm), QGDSGDm)
    assert make_topology("hierarchical", (2, 4)).name == "hierarchical"
    assert make_schedule("hier_one_peer", (2, 4)).period == 1
    churn = DenseComm(ring(K), membership=full_membership(K), device="cpu")
    tree = {"w": torch.arange(3.0 * K).reshape(K, 3)}
    assert torch.equal(churn.stale_mix(tree, r=0)["w"], churn.mix(tree)["w"])
    # overlapped rounds (tests/test_torch_overlap.py): PD-SGD is PD-SGDM at
    # μ = 0; CPD overlaps on the tree path only, as in the reference
    for name in ("cpd_sgdm", "pd_sgd", "mt_dsgdm", "qg"):
        assert make_optimizer(name, comm, overlap=True).config.overlap
    assert make_optimizer("pd_sgd", comm, overlap=True).config.mu == 0.0
    with pytest.raises(ValueError, match="use_kernel"):
        make_optimizer("cpd_sgdm", comm, overlap=True, use_kernel=True)
    for name in ("d_sgd", "choco"):
        with pytest.raises(ValueError):
            make_optimizer(name, comm, overlap=True)
