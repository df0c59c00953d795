"""C-SGDM (the paper's Fig. 1 baseline) in the port against the reference,
and ``SimTrainer``'s ``rounds_per_log``.

C-SGDM averages the gradients over all K workers every step (``comm.mix``
with the complete topology, W = 11ᵀ/K), then takes the momentum step; its
params never gossip.  The smooth-model runs use a quadratic loss,
``0.5·mean((w − y)²)`` per worker, on inputs made with numpy from a seed,
so nothing flips and the bars are tight: losses rtol 1e-5, params
rtol 1e-5 / atol 1e-6 (the mean is a BLAS product and the momentum chain
rounds in another order on each side).  Bytes per round are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import make_optimizer as r_make_optimizer  # noqa: E402
from repro.core.gossip import DenseComm as RDenseComm  # noqa: E402
from repro.core.topology import ring as r_ring  # noqa: E402
from repro.models import resnet as r_resnet  # noqa: E402
from repro.train.trainer import SimTrainer as RSimTrainer  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import (CSGDM, DenseComm, PDSGDMConfig,  # noqa: E402
                              Topology, complete, make_optimizer, ring)
from repro_torch.kernels.gossip_mix import gossip_mix  # noqa: E402
from repro_torch.kernels.momentum import momentum_update  # noqa: E402
from repro_torch.models.resnet import resnet20_init  # noqa: E402
from repro_torch.train import trainer as trainer_mod  # noqa: E402
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


K, STEPS = 8, 9
HYPER = dict(eta=0.1, mu=0.9, weight_decay=1e-4)


def _quad_setup(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((K, 2500), dtype=np.float32),
              "b": rng.standard_normal((K, 7), dtype=np.float32)}
    # every worker starts from the same point, as a C-SGDM run does
    params = {k: np.broadcast_to(v[:1], v.shape).copy()
              for k, v in params.items()}
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


def _port_train(opt, params, batches, **kw):
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    return SimTrainer(_quad_loss_torch, opt, device="cpu").train(
        params_from_reference(params, "cpu"), lambda t: tb[t], STEPS,
        log_every=1, **kw)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_csgdm_matches_reference_on_a_smooth_model(use_kernel):
    """N = 9 steps (9 rounds of p = 1) through SimTrainer, the port's
    C-SGDM against the reference's (the kernel round in Pallas interpret
    mode where ``use_kernel``): the module's bars (measured: losses
    1.3e-7 relative, params 1.2e-7 apart).  Every worker holds the same
    params after every step, bit for bit; no gossip kernel launches."""
    params, batches = _quad_setup()
    opt = make_optimizer("c_sgdm", DenseComm(ring(K), device="cpu"), p=4,
                         use_kernel=use_kernel, **HYPER)
    ropt = r_make_optimizer("c_sgdm", RDenseComm(r_ring(K)), p=4,
                            use_kernel=use_kernel, kernel_interpret=True,
                            **HYPER)
    before = (momentum_update.launches, gossip_mix.launches)
    got, state, hist = _port_train(opt, params, batches)
    assert (momentum_update.launches, gossip_mix.launches) == before
    want, _s, rhist = RSimTrainer(_quad_loss_jax, ropt).train(
        jax.tree_util.tree_map(jnp.asarray, params),
        lambda t: jax.tree_util.tree_map(jnp.asarray, batches[t]), STEPS,
        log_every=1)
    assert hist.steps == rhist.steps == list(range(STEPS))
    assert hist.comm_mb == rhist.comm_mb
    assert int(state["step"]) == STEPS
    np.testing.assert_allclose(hist.loss, rhist.loss, rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
        for i in range(1, K):
            assert torch.equal(got[k][i], got[k][0]), (k, i)
            assert torch.equal(state["m"][k][i], state["m"][k][0]), (k, i)


def test_csgdm_kernel_round_equals_tree_round():
    """As tests/test_kernels.py holds the reference: one C-SGDM round on
    the kernel layout (the mean of the gradient matrix, one momentum
    launch, no gossip) against the tree round, from params that differ
    per worker (measured: equal)."""
    k = 4
    params = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        (k, 130), dtype=np.float32))}

    def grads_fn(pp, _b):
        return torch.zeros(()), {n: 0.3 * x for n, x in pp.items()}

    outs = []
    for uk in (False, True):
        opt = make_optimizer("c_sgdm", DenseComm(ring(k), device="cpu"),
                             eta=0.05, mu=0.9, use_kernel=uk)
        p1, s1, _ = opt.round(opt.init(params), params, grads_fn,
                              {"x": torch.zeros((1, 1))})
        outs.append((p1, s1))
    np.testing.assert_allclose(outs[0][0]["w"].numpy(),
                               outs[1][0]["w"].numpy(), atol=1e-7, rtol=0)
    np.testing.assert_allclose(outs[0][1]["m"]["w"].numpy(),
                               outs[1][1]["m"]["w"].numpy(), atol=1e-7,
                               rtol=0)
    # the mean of 0.3·x over the workers, the same on every worker
    mean = (0.3 * params["w"]).mean(0)
    np.testing.assert_allclose(outs[0][1]["m"]["w"][0].numpy(),
                               mean.numpy(), rtol=1e-6)


def test_c_sgdm_factory():
    comm = DenseComm(ring(K), device="cpu")
    opt = make_optimizer("c-sgdm", comm, p=8, eta=0.05, use_kernel=True)
    assert isinstance(opt, CSGDM)
    assert opt.config.p == 1 and opt.config.eta == 0.05
    assert opt.config.use_kernel and opt.kernel_comm_supported
    assert opt.comm.topology.name == "complete"
    assert opt.comm.topology.n_workers == K
    assert opt.comm.device == comm.device
    np.testing.assert_array_equal(opt.comm.topology.W, complete(K).W)
    assert isinstance(make_optimizer("csgdm", comm), CSGDM)
    with pytest.raises(ValueError, match="complete"):
        CSGDM(PDSGDMConfig(), DenseComm(ring(K), device="cpu"))
    assert CSGDM(PDSGDMConfig(p=4),
                 DenseComm(complete(K), device="cpu")).config.p == 1
    hier = Topology("hierarchical", np.eye(4), ((0, 0, 1.0),), (2, 2))
    with pytest.raises(ValueError, match="hierarchical"):
        make_optimizer("c_sgdm", DenseComm(hier, device="cpu"))
    with pytest.raises(ValueError, match="overlap"):
        make_optimizer("c_sgdm", comm, overlap=True)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_csgdm_bytes_per_round_at_full_width(use_kernel):
    """ResNet-20 at width 16, K = 8: the complete graph's degree 7 times
    the tree's 272,282 f32 (the kernel wire is off for the complete graph):
    7,623,896 B a round, as the reference computes it."""
    params = resnet20_init(torch.Generator().manual_seed(0), width=16,
                           device="cpu")
    opt = make_optimizer("c_sgdm", DenseComm(ring(K), device="cpu"),
                         use_kernel=use_kernel, **HYPER)
    assert opt.bytes_per_comm_round(params) == 7_623_896
    assert opt.bytes_per_round_cycle(params) == (7_623_896,)
    shapes = jax.eval_shape(lambda k: r_resnet.resnet20_init(k, width=16),
                            jax.random.PRNGKey(0))
    ropt = r_make_optimizer("c_sgdm", RDenseComm(r_ring(K)),
                            use_kernel=use_kernel, **HYPER)
    assert ropt.bytes_per_comm_round(shapes) == 7_623_896


@pytest.mark.parametrize("where", ["init", "train"])
@pytest.mark.parametrize("rounds_per_log,chunks", [
    (None, [2, 2, 2, 2, 1]), (2, [4, 4, 1]), (3, [6, 2, 1])])
def test_rounds_per_log_sets_the_block(rounds_per_log, chunks, where,
                                       monkeypatch):
    """PD-SGDM at p = 2 over 9 steps logged every step: the default block
    is one round (enough to reach the next log point); ``rounds_per_log``
    at construction or per call sets it.  The history, the params and the
    comm-MB do not depend on it, and equal the reference's at the same
    setting."""
    seen = []
    log_chunk = trainer_mod._log_chunk

    def spy(hist, losses, t0, **kw):
        seen.append(len(losses))
        return log_chunk(hist, losses, t0, **kw)

    monkeypatch.setattr(trainer_mod, "_log_chunk", spy)
    params, batches = _quad_setup(seed=1)
    opt = make_optimizer("pd_sgdm", DenseComm(ring(K), device="cpu"), p=2,
                         use_kernel=True, **HYPER)
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    kw = {"rounds_per_log": rounds_per_log}
    trainer = SimTrainer(_quad_loss_torch, opt, device="cpu",
                         **(kw if where == "init" else {}))
    got, _s, hist = trainer.train(params_from_reference(params, "cpu"),
                                  lambda t: tb[t], STEPS, log_every=1,
                                  **(kw if where == "train" else {}))
    assert seen == chunks
    ropt = r_make_optimizer("pd_sgdm", RDenseComm(r_ring(K)), p=2,
                            use_kernel=True, kernel_interpret=True, **HYPER)
    want, _rs, rhist = RSimTrainer(
        _quad_loss_jax, ropt, rounds_per_log=rounds_per_log).train(
        jax.tree_util.tree_map(jnp.asarray, params),
        lambda t: jax.tree_util.tree_map(jnp.asarray, batches[t]), STEPS,
        log_every=1)
    assert hist.steps == rhist.steps and hist.comm_mb == rhist.comm_mb
    np.testing.assert_allclose(hist.loss, rhist.loss, rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
