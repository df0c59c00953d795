"""The port's chaos harness against the reference's: scripts, the dense
chaos drive of every optimizer family under churn, and the claims of
``benchmarks/elastic_sweep.py`` and ``benchmarks/topology_sweep.py``.

The drives run the heterogeneous quadratic of tests/test_chaos.py on the
reference's own targets b and start x₀ (drawn with JAX's generator, handed
to the port through numpy), so both packages walk the same trajectory.
Scripts come from numpy's ``default_rng`` on both sides and are held
exactly; so are the accounted bytes, every round, and the byte oracle.
The trajectories are f32 on both sides with reductions whose order
neither pins: PD, MT and QG are held to rtol 1e-5 / atol 1e-5 (measured:
params 9.5e-7 apart at most, consensus 6.4e-8 and loss 1.5e-7 relative);
the sign and top-k wires at the admission bars of
tests/test_torch_cpdsgdm.py (params rtol 1e-3 / atol 1e-4; x̂ beyond that
in at most 4 elements, each by at most 2·max|x̂ − x₀|; measured: params
1.9e-6 apart, every element of x̂ and c within the bar).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import make_compressor as r_make_compressor  # noqa: E402
from repro.core import make_optimizer as r_make_optimizer  # noqa: E402
from repro.core import PDSGDM as RPDSGDM  # noqa: E402
from repro.core import PDSGDMConfig as RPDSGDMConfig  # noqa: E402
from repro.core.gossip import DenseComm as RDenseComm  # noqa: E402
from repro.core import topology as r_top  # noqa: E402
from repro.testing import chaos as r_chaos  # noqa: E402
from repro.train.trainer import SimTrainer as RSimTrainer  # noqa: E402
from repro_torch.core import (PDSGDM, PDSGDMConfig, DenseComm,  # noqa: E402
                              make_compressor, make_optimizer)
from repro_torch.core import topology as top  # noqa: E402
from repro_torch.testing import chaos  # noqa: E402
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


K, D, P, R = 8, 24, 2, 12
SEED = 7
BENCH = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                     "BENCH_elastic.json")

CONFIGS = {
    "pd": ("pd_sgdm", {}),
    "cpd_sign": ("cpd_sgdm", {"gamma": 0.5, "compressor": ("sign", {})}),
    "cpd_topk": ("cpd_sgdm", {"gamma": 0.5,
                              "compressor": ("topk", {"fraction": 0.25})}),
    "mt": ("mt_dsgdm", {}),
    "mt_sign": ("mt_dsgdm", {"compressor": ("sign", {})}),
    "qg": ("qg_dsgdm", {}),
}
CODEC_WIRES = ("cpd_sign", "cpd_topk", "mt_sign")


def _kw(kw, make_comp):
    out = dict(kw)
    if "compressor" in kw:
        name, ckw = kw["compressor"]
        out["compressor"] = make_comp(name, **ckw)
    return out


def _targets(d=D):
    """The reference's b and x₀ (tests/test_chaos.py), as numpy."""
    b = np.array(2.0 * jax.random.normal(jax.random.PRNGKey(3), (K, d)))
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (1, d)))
    return b, x0


def _port_quadratic(b):
    bt = torch.from_numpy(b)

    def grads_fn(params, batch):
        g = {"w": params["w"] - bt}
        return 0.5 * torch.sum((params["w"] - bt) ** 2, dim=-1).mean(), g

    return grads_fn


def _ref_quadratic(b):
    bj = jnp.asarray(b)

    def grads_fn(params, batch):
        g = {"w": params["w"] - bj}
        return 0.5 * jnp.sum((params["w"] - bj) ** 2, axis=-1).mean(), g

    return grads_fn


def _port_params(x0):
    return {"w": torch.from_numpy(np.broadcast_to(x0, (K, x0.shape[1]))
                                  .copy())}


def _port_opt(cname, membership, use_kernel=False, **over):
    name, kw = CONFIGS[cname]
    return make_optimizer(name, DenseComm(top.ring(K), membership=membership,
                                          device="cpu"),
                          eta=0.05, mu=0.9, p=P, use_kernel=use_kernel,
                          **_kw(kw, make_compressor), **over)


def _port_run(cname, use_kernel, events=None, d=D, rounds=R):
    events = chaos.chaos_script(K, rounds, seed=SEED) if events is None \
        else events
    b, x0 = _targets(d)
    opt = _port_opt(cname, chaos.membership_for(K, rounds, events),
                    use_kernel)
    return opt, chaos.run_dense_chaos(opt, events, _port_params(x0),
                                      _port_quadratic(b), rounds)


# ------------------------------------------------------------- the scripts
@pytest.mark.parametrize("seed,kw", [
    (7, {}), (11, {}), (3, {"kill_prob": 0.25, "straggle_prob": 0.25}),
    (5, {"kill_prob": 0.4, "straggle_prob": 0.1, "down_rounds": 3,
         "min_live": 4})])
def test_chaos_script_matches_reference(seed, kw):
    """The same events, in the same order, and the same membership and
    revivals."""
    ours = chaos.chaos_script(K, 16, seed=seed, **kw)
    ref = r_chaos.chaos_script(K, 16, seed=seed, **kw)
    assert [(e.round, e.kind, e.worker) for e in ours] == \
        [(e.round, e.kind, e.worker) for e in ref]
    assert chaos.revivals_by_round(ours) == r_chaos.revivals_by_round(ref)
    ms, rms = chaos.membership_for(K, 16, ours), \
        r_chaos.membership_for(K, 16, ref)
    np.testing.assert_array_equal(ms.live, rms.live)
    np.testing.assert_array_equal(ms.active, rms.active)
    for r in range(16):
        assert ms.live_at(r).sum() >= kw.get("min_live", 2)


def test_event_semantics():
    """tests/test_chaos.py's script: a kill holds until the revive, a
    straggle masks one round."""
    ev = chaos.ChaosEvent
    events = [ev(1, "kill", 2), ev(3, "revive", 2), ev(2, "straggle", 5)]
    ms = chaos.membership_for(K, 6, events)
    assert ms.live_at(0).all() and ms.active_at(0).all()
    for r in (1, 2):
        assert not ms.live_at(r)[2] and not ms.active_at(r)[2]
    assert ms.live_at(3)[2] and ms.active_at(3)[2]
    assert ms.live_at(2)[5] and not ms.active_at(2)[5]
    assert ms.active_at(3)[5]
    assert chaos.revivals_by_round(events) == {3: [2]}


@pytest.mark.parametrize("tname", ["ring", "exponential", "complete"])
def test_check_round_matrix_every_round(tname):
    """Rows stochastic, masked rows e_k, no dead column read, and for the
    symmetric bases doubly stochastic over the active set; the matrices
    equal the reference's."""
    ms = chaos.membership_for(K, R, chaos.chaos_script(K, R, seed=SEED))
    rms = r_chaos.membership_for(K, R, r_chaos.chaos_script(K, R, seed=SEED))
    comm = DenseComm(getattr(top, tname)(K), membership=ms, device="cpu")
    rcomm = RDenseComm(getattr(r_top, tname)(K), membership=rms)
    for r in range(R):
        W = chaos.check_round_matrix(comm, r)
        np.testing.assert_array_equal(W, r_chaos.check_round_matrix(rcomm, r))
        act = comm.active_at(r)
        np.testing.assert_allclose(W[:, act].sum(axis=0),
                                   np.ones(int(act.sum())), atol=1e-12)
    bad = DenseComm(top.ring(K), membership=ms, device="cpu")
    bad.effective_matrix = lambda r: np.eye(K) * 0.5
    with pytest.raises(AssertionError):
        chaos.check_round_matrix(bad, 0)


# ---------------------------------------------------------- the chaos drive
@pytest.mark.parametrize("use_kernel", [False, True], ids=["tree", "kernel"])
@pytest.mark.parametrize("cname", sorted(CONFIGS))
def test_dense_chaos_matches_reference(cname, use_kernel):
    """tests/test_chaos.py's six configs through ``run_dense_chaos``, 12
    rounds of the seed-7 script, port against reference: accounted bytes
    equal exactly, and equal ``oracle_fleet_bytes`` every round; the
    trajectory at the bars of the module docstring."""
    opt, run = _port_run(cname, use_kernel)
    name, kw = CONFIGS[cname]
    b, x0 = _targets()
    revents = r_chaos.chaos_script(K, R, seed=SEED)
    ropt = r_make_optimizer(
        name, RDenseComm(r_top.ring(K),
                         membership=r_chaos.membership_for(K, R, revents)),
        eta=0.05, mu=0.9, p=P, **_kw(kw, r_make_compressor))
    rrun = r_chaos.run_dense_chaos(
        ropt, revents, {"w": jnp.broadcast_to(jnp.asarray(x0), (K, D))},
        _ref_quadratic(b), R)
    np.testing.assert_array_equal(run.accounted_bytes, rrun.accounted_bytes)
    np.testing.assert_array_equal(run.live, rrun.live)
    one = {"w": torch.zeros(D)}
    for r in range(R):
        assert run.accounted_bytes[r] == chaos.oracle_fleet_bytes(opt, one, r)
    assert run.accounted_bytes.min() < run.accounted_bytes.max()
    got, want = run.params["w"].numpy(), np.asarray(rrun.params["w"])
    if cname not in CODEC_WIRES:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(run.consensus, rrun.consensus, rtol=1e-5)
        np.testing.assert_allclose(run.avg_loss, rrun.avg_loss, rtol=1e-5)
        return
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(run.consensus, rrun.consensus, rtol=1e-3)
    np.testing.assert_allclose(run.avg_loss, rrun.avg_loss, rtol=1e-3)
    key = "xhat" if name == "cpd_sgdm" else "c"
    ours, ref = run.state[key]["w"].numpy(), np.asarray(rrun.state[key]["w"])
    drift = float(np.abs(ref - x0).max()) if key == "xhat" else \
        float(np.abs(ref).max())
    far = ~np.isclose(ours, ref, rtol=1e-3, atol=1e-4)
    assert int(far.sum()) <= 4
    assert np.all(np.abs(ours - ref)[far] <= 2 * drift)


@pytest.mark.parametrize("cname", sorted(CONFIGS))
def test_kernel_round_equals_tree_round_under_churn(cname):
    """On the CPU the kernel layout runs the kernels' plain versions, which
    round as the tree round does, and under churn both mix with the same
    masked W: the two drives agree bit for bit, bytes included."""
    _, tree = _port_run(cname, False)
    _, kern = _port_run(cname, True)
    assert torch.equal(tree.params["w"], kern.params["w"])
    np.testing.assert_array_equal(tree.consensus, kern.consensus)
    np.testing.assert_array_equal(tree.avg_loss, kern.avg_loss)
    np.testing.assert_array_equal(tree.accounted_bytes, kern.accounted_bytes)
    for key, sub in tree.state.items():
        if isinstance(sub, dict):
            assert torch.equal(sub["w"], kern.state[key]["w"]), key


@pytest.mark.parametrize("use_kernel", [False, True], ids=["tree", "kernel"])
def test_cpd_dead_worker_xhat_frozen_exactly(use_kernel):
    """While worker 3 is down (rounds 1-3) its x̂ does not move at all, and
    neither does it while it cannot commit; it moves again once it and its
    neighbours are back."""
    events = [chaos.ChaosEvent(1, "kill", 3), chaos.ChaosEvent(4, "revive", 3)]
    opt = _port_opt("cpd_sign", chaos.membership_for(K, 6, events),
                    use_kernel)
    b, x0 = _targets()
    grads_fn = _port_quadratic(b)
    params = _port_params(x0)
    state = opt.init(params)
    batches = {"dummy": torch.zeros(P, 1)}
    frozen = None
    for r in range(6):
        params, state, _ = opt.round(state, params, grads_fn, batches)
        xh3 = state["xhat"]["w"][3].clone()
        if r == 0:
            frozen = xh3
        elif r < 4:
            assert torch.equal(xh3, frozen), r
        else:
            assert not torch.equal(xh3, frozen), r
    # its neighbours 2 and 4 cannot commit while 3 is down either
    assert [opt._commit_np[r].tolist() for r in (0, 1)] == [
        [True] * K, [True, True, False, False, False, True, True, True]]


@pytest.mark.parametrize("use_kernel", [False, True], ids=["tree", "kernel"])
def test_mt_sign_straggler_keeps_its_raw_c(use_kernel):
    """MT with the sign correction wire: a straggler's masked row is e_k,
    and its c after the round is its raw c, not its own Q(c); an active
    worker's c is the mix of the quantized corrections."""
    events = [chaos.ChaosEvent(0, "straggle", 5)]
    opt = _port_opt("mt_sign", chaos.membership_for(K, 2, events),
                    use_kernel)
    plain = _port_opt("mt_sign", top.full_membership(K), use_kernel)
    b, x0 = _targets()
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(
        rng.standard_normal((K, D), dtype=np.float32))}
    batches = {"dummy": torch.zeros(P, 1)}
    grads_fn = _port_quadratic(b)
    raw_opt = _port_opt("mt_sign", top.full_membership(K), use_kernel)
    # the c before the gossip: P local steps with no round at the end
    _, raw, _ = raw_opt.round(raw_opt.init(params), params, grads_fn,
                              batches, gossip=False)
    _, got, _ = opt.round(opt.init(params), params, grads_fn, batches)
    _, full, _ = plain.round(plain.init(params), params, grads_fn, batches)
    c, c_raw, c_full = got["c"]["w"], raw["c"]["w"], full["c"]["w"]
    assert torch.equal(c[5], c_raw[5])
    assert not torch.equal(c_full[5], c_raw[5])     # Q(c) differs from c
    # an active worker with both neighbours active mixes as without churn
    assert torch.equal(c[1], c_full[1])
    assert not torch.equal(c[4], c_full[4])         # lost neighbour 5


# ------------------------------------------------------- the elastic sweep
SWEEP = [("pd_sgdm", {}), ("cpd_sgdm", {"gamma": 0.5,
                                        "compressor": ("sign", {})}),
         ("mt_dsgdm", {}), ("qg_dsgdm", {})]


@pytest.mark.parametrize("name,kw", SWEEP, ids=[n for n, _ in SWEEP])
def test_elastic_sweep_reproduces_bench(name, kw):
    """``benchmarks/elastic_sweep.py``'s cells for one optimizer (K = 8
    ring, D = 64, p = 2, η = 0.05, μ = 0.9, 16 rounds, script seed 7 at
    churn 0, 0.1 and 0.25) on the reference's b and x₀, on the kernel
    layout: ``final_loss`` within rtol 1e-3 of the committed
    ``BENCH_elastic.json``, ``mb_total`` and ``bytes_saved_frac`` equal
    to its 4 printed decimals, ``max_consensus`` within rtol 1e-3, and the
    survivors bounded (final loss ≤ 2×, peak consensus ≤ 5× the churn-free
    run's)."""
    rows = {row["name"]: row["derived"] for row in json.load(open(BENCH))
            ["rows"]}
    rounds, d = 16, 64
    b, x0 = _targets(d)
    cells = {}
    for rate in (0.0, 0.1, 0.25):
        if rate == 0.0:
            events, ms = [], top.full_membership(K)
        else:
            events = chaos.chaos_script(K, rounds, seed=SEED, kill_prob=rate,
                                        straggle_prob=rate)
            ms = chaos.membership_for(K, rounds, events)
        opt = make_optimizer(name, DenseComm(top.ring(K), membership=ms,
                                             device="cpu"),
                             eta=0.05, mu=0.9, p=P, use_kernel=True,
                             **_kw(kw, make_compressor))
        run = chaos.run_dense_chaos(opt, events, _port_params(x0),
                                    _port_quadratic(b), rounds)
        one = {"w": torch.zeros(d)}
        for r in range(rounds):
            assert run.accounted_bytes[r] == \
                chaos.oracle_fleet_bytes(opt, one, r)
        cells[rate] = (float(run.avg_loss[-1]), float(run.consensus.max()),
                       float(run.accounted_bytes.sum()))
        want = rows[f"elastic/{name}_c{rate:g}"]
        np.testing.assert_allclose(cells[rate][0], want["final_loss"],
                                   rtol=1e-3)
        np.testing.assert_allclose(cells[rate][1], want["max_consensus"],
                                   rtol=1e-3)
        assert round(cells[rate][2] / 1e6, 4) == want["mb_total"]
        saved = 1.0 - cells[rate][2] / cells[0.0][2]
        assert round(saved, 4) == want["bytes_saved_frac"]
    base = cells[0.0]
    for rate in (0.1, 0.25):
        assert cells[rate][0] <= 2.0 * base[0]
        assert cells[rate][1] <= 5.0 * base[1]
    if name == "pd_sgdm":
        assert rows["elastic/claim_bytes"]["bytes_saved_frac"] == 0.8516
        assert round(1.0 - cells[0.25][2] / base[2], 4) == 0.8516


# ------------------------------------------------------ the topology sweep
def _sweep_targets():
    base = jax.random.normal(jax.random.PRNGKey(3), (64,))
    offs = jax.random.normal(jax.random.PRNGKey(4), (16, 64)) * 3.0
    return np.array(base[None, :] + offs)


@pytest.mark.parametrize("graph,steps", [("ring", 96), ("one_peer", 192)])
def test_topology_sweep_matches_reference(graph, steps):
    """``benchmarks/topology_sweep.py``'s equal-bytes pair (K = 16, D = 64,
    PD at η = 0.2, μ = 0.9, p = 4): the static ring at 96 steps and the
    one-peer exponential schedule at 192.  The consensus equals the
    reference's to rtol 1e-4, comm-MB exactly, and both runs ship the same
    MB (held on the tree layout, the sweep's: on the kernel layout the
    ring's shifted views ship a whole 1024-lane row per 64-float leaf).
    The kernel layout's consensus equals the tree layout's to rtol 1e-5."""
    k = 16
    targets = _sweep_targets()
    tt = torch.from_numpy(targets)

    def loss_t(params, batch):
        return 0.5 * torch.mean((params["x"] - batch["y"]) ** 2), {}

    def loss_j(params, batch):
        return 0.5 * jnp.mean((params["x"] - batch) ** 2), {}

    def consensus(x):
        x = np.asarray(x, np.float64)
        return float(np.mean(np.linalg.norm(x - x.mean(0), axis=1)))

    def sched(m):
        return (m.static_schedule(m.ring(k)) if graph == "ring"
                else m.one_peer_exponential_schedule(k))

    got = {}
    for use_kernel in (False, True):
        opt = PDSGDM(PDSGDMConfig(eta=0.2, mu=0.9, p=4,
                                  use_kernel=use_kernel),
                     DenseComm(sched(top), device="cpu"))
        params, _, hist = SimTrainer(
            loss_t, opt, device="cpu", rounds_per_log=steps // 4).train(
                {"x": torch.zeros(k, 64)}, lambda t: {"y": tt}, steps,
                log_every=steps)
        got[use_kernel] = (consensus(params["x"].numpy()), hist.comm_mb[-1])
    ropt = RPDSGDM(RPDSGDMConfig(eta=0.2, mu=0.9, p=4),
                   RDenseComm(sched(r_top)))
    rparams, _, rhist = RSimTrainer(loss_j, ropt,
                                    rounds_per_log=steps // 4).train(
        {"x": jnp.zeros((k, 64))}, lambda t: jnp.asarray(targets), steps,
        log_every=steps)
    want = consensus(rparams["x"])
    np.testing.assert_allclose(got[False][0], want, rtol=1e-4)
    np.testing.assert_allclose(got[True][0], got[False][0], rtol=1e-5)
    assert got[False][1] == rhist.comm_mb[-1]
    assert got[False][1] == 12_288 / 2 ** 20       # 24 × 2 × 256 B = 48 × 256
    assert got[True][1] == (12_288 if graph == "one_peer"
                            else 24 * 2 * 4096) / 2 ** 20
    assert want == pytest.approx(3.0346 if graph == "one_peer" else 6.5874,
                                 abs=1e-4)
