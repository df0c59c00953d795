"""The slice as a whole: the port's PD-SGDM ``SimTrainer`` on the kernel
layout against the reference's, from the same reference params on the same
reference batches.

Setup: ResNet-20 at width 4, K = 8 on ``ring(8)``, p = 4, batch 2 per
worker, 9 steps (2 rounds and a 1-step tail), η = 0.1, μ = 0.9, weight
decay 1e-4.  Comm-MB and bytes per round are exact everywhere.  Losses and
params are held to rtol 1e-4 and atol 1e-4 / rtol 1e-3 where the two runs
can agree that closely; each test states where and why they cannot (the
convolutions sum in another order, XLA contracts the momentum chain into
FMAs, and a ReLU input within rounding of zero flips a gradient).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import make_optimizer as r_make_optimizer  # noqa: E402
from repro.core import schedules as r_schedules  # noqa: E402
from repro.core.gossip import DenseComm as RDenseComm  # noqa: E402
from repro.core import topology as r_top  # noqa: E402
from repro.core.topology import ring as r_ring  # noqa: E402
from repro.data.synthetic import ClassStreamCfg as RCfg  # noqa: E402
from repro.data.synthetic import class_batch as r_class_batch  # noqa: E402
from repro.kernels import ops as r_kops  # noqa: E402
from repro.kernels import ref as r_kref  # noqa: E402
from repro.models import resnet as r_resnet  # noqa: E402
from repro.train.trainer import SimTrainer as RSimTrainer  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import (DenseComm, exponential,  # noqa: E402
                              full_membership, make_optimizer, make_schedule,
                              make_topology, ring, schedules, torus)
from repro_torch.kernels.gossip_mix import gossip_mix  # noqa: E402
from repro_torch.kernels.momentum import momentum_update  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.ops import KernelPlan  # noqa: E402
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
HYPER = dict(eta=0.1, mu=0.9, p=P, weight_decay=1e-4)


@functools.lru_cache(maxsize=None)
def _ref_setup():
    """Stacked reference params and the run's reference batches (numpy)."""
    init = jax.jit(r_resnet.resnet20_init, static_argnames=("width",))
    p = init(jax.random.PRNGKey(0), width=WIDTH)
    stacked = jax.tree_util.tree_map(
        lambda x: np.array(jnp.broadcast_to(x[None], (K,) + x.shape)), p)
    cfg = RCfg(batch=BATCH, n_workers=K, seed=0)
    fn = jax.jit(r_class_batch, static_argnums=0)
    batches = [jax.tree_util.tree_map(np.array, fn(cfg, t))
               for t in range(STEPS)]
    return stacked, batches


def _port_batch_fn(batches):
    tb = [{"images": torch.from_numpy(b["images"]),
           "labels": torch.from_numpy(b["labels"]).long()} for b in batches]
    return lambda t: tb[t]


def _port_run(use_kernel, steps=STEPS):
    stacked, batches = _ref_setup()
    opt = make_optimizer("pd_sgdm", DenseComm(ring(K), device="cpu"),
                         use_kernel=use_kernel, **HYPER)
    trainer = SimTrainer(resnet20_loss, opt, device="cpu")
    return trainer.train(params_from_reference(stacked, "cpu"),
                         _port_batch_fn(batches), steps, log_every=1)


@functools.lru_cache(maxsize=None)
def _ref_run():
    stacked, batches = _ref_setup()
    opt = r_make_optimizer("pd_sgdm", RDenseComm(r_ring(K)), use_kernel=True,
                           kernel_interpret=True, **HYPER)
    trainer = RSimTrainer(r_resnet.resnet20_loss, opt)
    params, _state, hist = trainer.train(
        jax.tree_util.tree_map(jnp.asarray, stacked),
        lambda t: jax.tree_util.tree_map(jnp.asarray, batches[t]), STEPS,
        log_every=1)
    return jax.tree_util.tree_map(np.array, params), hist


def test_kernel_round_trainer_matches_reference():
    """ResNet-20 end to end.  The first three losses hold to rtol 1e-5
    (measured 1.6e-7).  After them the two runs part: at step 2 one ReLU
    input of worker 0 (the output of block s2b1) lies within 1e-6 of zero,
    the two packages' f32 convolutions put it on opposite sides, and that
    worker's early-layer gradients differ by 3e-3 (the port's agree with a
    float64 evaluation of the same step to 5e-7).  At η = 0.1 on two images
    per worker the trajectories then drift apart: measured loss gap 2.2e-3
    by step 6, final params 2.0e-2 apart in relative L2.  The bars below
    cover that; the optimizer itself is held tightly by
    ``test_trainer_matches_reference_on_a_smooth_model``."""
    before = (momentum_update.launches, gossip_mix.launches)
    params, state, hist = _port_run(use_kernel=True)
    assert (momentum_update.launches, gossip_mix.launches) == before
    rparams, rhist = _ref_run()
    assert hist.steps == rhist.steps == list(range(STEPS))
    np.testing.assert_allclose(hist.loss[:3], rhist.loss[:3], rtol=1e-5)
    np.testing.assert_allclose(hist.loss, rhist.loss, rtol=1e-2)
    assert hist.comm_mb == rhist.comm_mb
    assert int(state["step"]) == STEPS
    rparams = params_from_reference(rparams, "cpu")
    assert list(params) == list(rparams)
    diff = sum(float(((params[n] - rparams[n]) ** 2).sum()) for n in rparams)
    norm = sum(float((rparams[n] ** 2).sum()) for n in rparams)
    assert (diff / norm) ** 0.5 < 5e-2


def _linear_loss_torch(p, b):
    x = b["images"].reshape(b["images"].shape[0], -1) / 32.0
    logp = torch.log_softmax(x @ p["w"] + p["b"], dim=-1)
    return -logp.gather(-1, b["labels"][:, None].long())[:, 0].mean(), {}


def _linear_loss_jax(p, b):
    x = b["images"].reshape(b["images"].shape[0], -1) / 32.0
    logp = jax.nn.log_softmax(x @ p["w"] + p["b"])
    return -jnp.take_along_axis(logp, b["labels"][:, None],
                                axis=-1)[:, 0].mean(), {}


def test_trainer_matches_reference_on_a_smooth_model():
    """The same trainer, optimizer, kernel layout and ring gossip on the
    same batches, with softmax regression as the model: no ReLU, so nothing
    flips, and the module docstring's bars hold (measured: losses 1.2e-7 apart, params
    4.5e-8)."""
    _stacked, batches = _ref_setup()
    rng = np.random.default_rng(0)
    p0 = {"b": np.zeros((10,), np.float32),
          "w": (0.01 * rng.standard_normal((32 * 32 * 3, 10))
                ).astype(np.float32)}
    stacked = {k: np.broadcast_to(v[None], (K,) + v.shape).copy()
               for k, v in p0.items()}
    ropt = r_make_optimizer("pd_sgdm", RDenseComm(r_ring(K)), use_kernel=True,
                            kernel_interpret=True, **HYPER)
    rparams, _s, rhist = RSimTrainer(_linear_loss_jax, ropt).train(
        jax.tree_util.tree_map(jnp.asarray, stacked),
        lambda t: jax.tree_util.tree_map(jnp.asarray, batches[t]), STEPS,
        log_every=1)
    opt = make_optimizer("pd_sgdm", DenseComm(ring(K), device="cpu"),
                         use_kernel=True, **HYPER)
    params, _s, hist = SimTrainer(_linear_loss_torch, opt, device="cpu").train(
        params_from_reference(stacked, "cpu"), _port_batch_fn(batches), STEPS,
        log_every=1)
    np.testing.assert_allclose(hist.loss, rhist.loss, rtol=1e-4)
    assert hist.comm_mb == rhist.comm_mb
    for name in params:
        np.testing.assert_allclose(params[name].numpy(),
                                   np.asarray(rparams[name]),
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("route", ["flatten", "leaves"])
def test_kernel_path_equals_tree_path(route, monkeypatch):
    """The port's kernel round against its own tree round, on one round of
    ResNet-20.  The p local steps are bit-identical (same ops, same
    rounding), with the gradient read through the momentum launch's leaf
    table (``leaves``: ResNet-20's leaves end mid-row, and the conv
    kernels' grads and the 10-element head bias are copied first) and
    handed over flattened (``flatten``, the hand-off before the table).
    The gossip sums the same three products, as an AXPY on one side and
    as ``W @ flat`` on the other, so it is held to 1 ulp per added term
    of Σⱼ|w_kj·x_j| (measured: 2 ulps, the bound).  Relative to the result
    the gap is unbounded where the terms cancel (measured 8,420 ulps)."""
    stacked, batches = _ref_setup()
    params = params_from_reference(stacked, "cpu")
    k_opt, t_opt = (make_optimizer("pd_sgdm", DenseComm(ring(K), device="cpu"),
                                   use_kernel=uk, **HYPER)
                    for uk in (True, False))
    if route == "flatten":
        step = k_opt.local_step_mat
        monkeypatch.setattr(k_opt, "local_step_mat", lambda x, mats, g, s: (
            step(x, mats, kops.as_matrix(g), s)), raising=False)
    grads_fn = SimTrainer(resnet20_loss, k_opt, device="cpu")._grads_fn
    round_batches = _port_batch_fn(batches)
    stack = {k: torch.stack([round_batches(t)[k] for t in range(P)])
             for k in ("images", "labels")}
    xk, sk, lk = k_opt.round(k_opt.init(params), params, grads_fn, stack,
                             gossip=False)
    xt, st, lt = t_opt.round(t_opt.init(params), params, grads_fn, stack,
                             gossip=False)
    assert torch.equal(lk, lt) and torch.equal(sk["step"], st["step"])
    for name in params:
        assert torch.equal(xk[name], xt[name]), name
        assert torch.equal(sk["m"][name], st["m"][name]), name

    plan = KernelPlan.for_tree(xk, worker_dim=True)
    yk = plan.unflatten(k_opt._gossip_mat(plan.flatten(xk), None, plan=plan))
    yt = t_opt.comm.mix(xt)
    W = np.abs(t_opt.comm.topology.W)
    for name in params:
        x = xk[name].reshape(K, -1).numpy().astype(np.float64)
        magnitude = (W @ np.abs(x)).astype(np.float32)
        gap = np.abs(yk[name].reshape(K, -1).numpy().astype(np.float64)
                     - yt[name].reshape(K, -1).numpy())
        assert np.all(gap <= 2 * np.spacing(magnitude)), name

    pk, _, hk = _port_run(use_kernel=True)
    pt, _, ht = _port_run(use_kernel=False)
    assert hk.comm_mb != ht.comm_mb       # the kernel wire ships whole rows
    np.testing.assert_allclose(hk.loss, ht.loss, rtol=1e-5)


@pytest.mark.parametrize("use_kernel,expected", [(True, 2_539_520),
                                                 (False, 2_178_256)])
def test_bytes_per_comm_round_at_full_width(use_kernel, expected):
    """ResNet-20 at width 16 on ring(8): 2 × 310 rows × 1024 × 4 B on the
    kernel wire, 2 × 272,282 × 4 B on the tree wire — as the reference."""
    params = resnet20_init(torch.Generator().manual_seed(0), width=16,
                           device="cpu")
    opt = make_optimizer("pd_sgdm", DenseComm(ring(K), device="cpu"),
                         use_kernel=use_kernel, **HYPER)
    assert opt.bytes_per_comm_round(params) == expected
    assert opt.bytes_per_round_cycle(params) == (expected,)
    shapes = jax.eval_shape(lambda k: r_resnet.resnet20_init(k, width=16),
                            jax.random.PRNGKey(0))
    ropt = r_make_optimizer("pd_sgdm", RDenseComm(r_ring(K)),
                            use_kernel=use_kernel, **HYPER)
    assert ropt.bytes_per_comm_round(shapes) == expected


@pytest.mark.parametrize("graph", ["ring", "torus", "exp16"])
def test_gossip_mat_matches_reference(graph, monkeypatch):
    """The kernel-layout gossip step of a static shift graph, one fused mix
    per topology axis over neighbour views cut to the ``used_rows`` wire
    extent (41 of 64 rows here; every row of the matrix random, so the cut
    shows): bit for bit against the reference's ``PDSGDM._gossip_mat`` with
    its plain left-to-right sum in place of the Pallas kernel, and within
    Σ (views − 1) over the axes ulps of its magnitude against the Pallas
    kernel in interpret mode, where XLA may fuse a product and a sum (as
    tests/test_torch_kernels.py's ``test_gossip_mix_matches_pallas_kernel``
    bounds one mix)."""
    tops = {"ring": (ring(8), r_ring(8)),
            "torus": (torus((2, 4)), r_top.torus((2, 4))),
            "exp16": (exponential(16), r_top.exponential(16))}
    top, rtop = tops[graph]
    k = top.n_workers
    rng = np.random.default_rng(k + len(top.shifts))
    tree = {"w": rng.standard_normal((k, 40_000), dtype=np.float32),
            "b": rng.standard_normal((k, 7), dtype=np.float32)}
    plan = KernelPlan.for_tree({n: torch.from_numpy(v)
                                for n, v in tree.items()},
                               worker_dim=True, block_rows=64)
    rplan = r_kops.KernelPlan.for_tree(tree, worker_dim=True, block_rows=64)
    assert (plan.used_rows, plan.rows) == (rplan.used_rows, rplan.rows) \
        == (41, 64)
    x = rng.standard_normal((k, plan.rows, 1024), dtype=np.float32)
    opt = make_optimizer("pd_sgdm", DenseComm(top, device="cpu"),
                         use_kernel=True, **HYPER)
    before = gossip_mix.launches
    y = opt._gossip_mat(torch.from_numpy(x), 0, plan=plan).numpy()
    assert gossip_mix.launches == before            # CPU: plain version
    ropt = r_make_optimizer("pd_sgdm", RDenseComm(rtop), use_kernel=True,
                            kernel_interpret=True, **HYPER)
    yk = np.asarray(ropt._gossip_mat(jnp.asarray(x), 0, plan=rplan))

    def plain_mix(mats, weights, interpret=False):
        rows = [m.reshape(-1, 1024) for m in mats]
        return r_kref.gossip_mix_ref(rows, weights).reshape(mats[0].shape)

    monkeypatch.setattr(r_kops, "gossip_mix_mat", plain_mix)
    yr = np.asarray(ropt._gossip_mat(jnp.asarray(x), 0, plan=rplan))
    np.testing.assert_array_equal(y, yr)
    # the magnitude: the same mix of |x| (every weight is positive)
    magnitude = opt._gossip_mat(torch.from_numpy(np.abs(x)), 0,
                                plan=plan).numpy()
    spacing = np.spacing(np.maximum(magnitude, np.maximum(np.abs(y),
                                                          np.abs(yk))))
    axes = len({ax for (ax, _, _) in top.shifts})
    gap = np.max(np.abs(y.astype(np.float64) - yk) / spacing)
    assert gap <= len(top.shifts) - axes


def test_tail_steps_do_not_gossip():
    """A 1-round run plus a 2-step tail: comm-MB stops at one round."""
    _params, state, hist = _port_run(use_kernel=True, steps=6)
    per_round = 2 * (hist.comm_mb[3] * 2 ** 20) / 2     # one round's bytes
    assert hist.comm_mb[:3] == [0.0, 0.0, 0.0]
    assert hist.comm_mb[3:] == [per_round / 2 ** 20] * 3
    assert int(state["step"]) == 6


@pytest.mark.parametrize("name,args", [
    ("constant", ()),
    ("step_decay", ((3, 6),)),
    ("warmup_cosine", (3, 10)),
])
def test_schedules_match_reference(name, args):
    ours = getattr(schedules, name)(*args)
    theirs = getattr(r_schedules, name)(*args)
    for step in range(12):
        got = ours(torch.tensor(step, dtype=torch.int32))
        want = theirs(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_optimizer_factory_refuses_what_this_slice_does_not_port():
    """What the port refuses: an unknown optimizer, and what the reference
    refuses on the sharded backend (overlapped CPD-SGDM here; the others
    are tests/test_torch_sharded.py's).  CPD-SGDM and MT's compressed
    tracking build on it, as overlapped rounds and hierarchical graphs do
    on the dense backend (tests/test_torch_sharded_cpd.py,
    tests/test_torch_overlap.py, tests/test_torch_hierarchical.py)."""
    comm = DenseComm(ring(K), device="cpu")
    for name in ("pd_sgdm", "mt_dsgdm", "qg_dsgdm"):
        opt = make_optimizer(name, comm, overlap=True)
        assert opt.config.overlap and "mix" in opt.init(
            {"w": torch.zeros(K, 3)})
    with pytest.raises(ValueError):
        make_optimizer("adam", comm)
    from repro_torch.core import SignCompressor
    from repro_torch.core.gossip import ShardedComm
    from repro_torch.launch.mesh import WorkerMesh
    sharded = ShardedComm(ring(K), axis_names=("w",), mesh=WorkerMesh(
        ("w",), (K,), 0, torch.device("cpu"), "gloo", {"w": None}))
    with pytest.raises(ValueError, match="dense-only"):
        make_optimizer("cpd_sgdm", sharded, overlap=True)
    assert make_optimizer("cpd_sgdm", sharded).sharded
    assert make_optimizer("mt_dsgdm", sharded,
                          compressor=SignCompressor()).sharded
    assert make_optimizer("pd_sgdm", sharded).sharded
    assert make_topology("hierarchical", (2, 4)).axis_sizes == (2, 4)
    assert make_schedule("hier_one_peer", (2, 4)).name == "hier_one_peer"
    # the stale mix under membership: all active, it is the mix
    churn = DenseComm(ring(K), membership=full_membership(K), device="cpu")
    tree = {"w": torch.arange(3.0 * K).reshape(K, 3)}
    assert torch.equal(churn.stale_mix(tree, r=0)["w"], churn.mix(tree)["w"])
