"""The port's topologies, schedules and scheduled rounds against the
reference's.

Topologies and schedules are numpy on both sides, built by the same
arithmetic, so ``W``, the shifts, the perms, the structure matrices, the
gaps and every schedule's stacked ``W`` are held bit for bit, and bytes per
round exactly.  ``DenseComm.mix`` is ``W @ flat``, a K-term reduction whose
order neither side pins (BLAS on both), so it is held to rtol 1e-6.

The scheduled rounds (mirroring tests/test_topology_schedule.py) run a
smooth quadratic model, ``0.5·mean((w − y)²)`` per worker, on inputs made
with numpy from a seed.  Nothing there flips, so the two packages stay
within rtol 1e-5 / atol 1e-6 (the momentum chain and the ``W @ x``
products round in other orders; each test states what it measured).  The
CPD-SGDM sign round adds the sign scale's sum, which the reference takes
with ``jnp.sum`` in an order it does not pin (a few ulps, see
tests/test_torch_compression.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import make_optimizer as r_make_optimizer  # noqa: E402
from repro.core.compression import SignCompressor as RSign  # noqa: E402
from repro.core import gossip as r_gossip  # noqa: E402
from repro.core import topology as r_top  # noqa: E402
from repro.train.trainer import SimTrainer as RSimTrainer  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import SignCompressor, make_optimizer  # noqa: E402
from repro_torch.core import topology as top  # noqa: E402
from repro_torch.core.gossip import DenseComm  # noqa: E402
from repro_torch.kernels import LANE  # noqa: E402
from repro_torch.kernels.gossip_mix import gossip_mix, launch_count  # noqa: E402
from repro_torch.kernels.momentum import momentum_update  # noqa: E402
from repro_torch.train.trainer import SimTrainer  # noqa: E402

STATIC = {
    "ring8": lambda m: m.ring(8),
    "torus2x4": lambda m: m.torus((2, 4)),
    "complete8": lambda m: m.complete(8),
    "exponential8": lambda m: m.exponential(8),
    "exponential12": lambda m: m.exponential(12),
    "exponential16": lambda m: m.exponential(16),
    "exponential32": lambda m: m.exponential(32),
    "disconnected8": lambda m: m.disconnected(8),
}

SCHEDULES = {
    "static_ring8": lambda m: m.make_schedule("static", (8,)),
    "static_exp16": lambda m: m.make_schedule("static", (16,),
                                              base_topology="exponential"),
    "one_peer_exp1": lambda m: m.one_peer_exponential_schedule(1),
    "one_peer_exp8": lambda m: m.make_schedule("one_peer_exp", (8,)),
    "one_peer_exp16": lambda m: m.one_peer_exponential_schedule(16, 0.25),
    "alt_axes2x4": lambda m: m.make_schedule("alt_axes", (2, 4)),
    "alt_axes8": lambda m: m.alternating_axes_schedule((8,)),
    "random_matching8": lambda m: m.make_schedule("random_matching", (8,),
                                                  rounds=3, seed=2),
    "random_matching7": lambda m: m.make_schedule("random_matching", (7,)),
}

P = 2
HYPER = dict(eta=0.1, mu=0.9, p=P, weight_decay=1e-4)


def _assert_same_topology(ours, theirs):
    assert ours.name == theirs.name
    np.testing.assert_array_equal(ours.W, theirs.W)
    assert ours.shifts == theirs.shifts
    assert ours.perms == theirs.perms
    assert tuple(ours.axis_sizes) == tuple(theirs.axis_sizes)
    assert ours.symmetric == theirs.symmetric
    assert ours.degree == theirs.degree
    assert ours.self_weight() == theirs.self_weight()
    assert ours.rho == theirs.rho
    np.testing.assert_array_equal(ours.structure_matrix(),
                                  theirs.structure_matrix())


@pytest.mark.parametrize("name", sorted(STATIC))
def test_static_topology_equals_reference(name):
    """W, structure and gaps bit for bit; the structure matrix rebuilds W
    (to 1e-12: ±K/2 of the exponential graph sums two weights)."""
    ours, theirs = STATIC[name](top), STATIC[name](r_top)
    _assert_same_topology(ours, theirs)
    ours.validate()
    np.testing.assert_allclose(ours.structure_matrix(), ours.W, atol=1e-12)
    for fn in ("spectral_gap", "mixing_gap"):
        assert getattr(top, fn)(ours.W) == getattr(r_top, fn)(theirs.W)
    assert top.is_doubly_stochastic(ours.W)
    assert top.cycle_spectral_gap([ours.W, ours.W]) == \
        r_top.cycle_spectral_gap([theirs.W, theirs.W])


@pytest.mark.parametrize("name,grid", [
    ("ring", (8,)), ("torus", (2, 4)), ("torus", (8,)), ("complete", (4,)),
    ("exponential", (16,)), ("exponential", (2, 16)), ("disconnected", (5,)),
])
def test_make_topology_equals_reference(name, grid):
    _assert_same_topology(top.make_topology(name, grid),
                          r_top.make_topology(name, grid))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_equals_reference(name):
    ours, theirs = SCHEDULES[name](top), SCHEDULES[name](r_top)
    assert ours.name == theirs.name and ours.period == theirs.period
    assert ours.n_workers == theirs.n_workers
    assert ours.axis_sizes == theirs.axis_sizes
    np.testing.assert_array_equal(ours.stacked_W(), theirs.stacked_W())
    np.testing.assert_array_equal(ours.cycle_product(),
                                  theirs.cycle_product())
    assert ours.cycle_rho == theirs.cycle_rho
    assert ours.degrees() == theirs.degrees()
    for r in range(2 * ours.period + 1):
        _assert_same_topology(ours.at(r), theirs.at(r))
    ours.validate()
    assert top.cycle_spectral_gap(list(ours.stacked_W())) == \
        pytest.approx(ours.cycle_rho, abs=1e-12)


def test_schedule_builders_refuse_what_the_reference_refuses():
    for m, err in ((top, ValueError), (r_top, ValueError)):
        with pytest.raises(err):
            m.make_schedule("one_peer_exp", (2, 4))
        with pytest.raises(err):
            m.make_schedule("random_matching", (2, 4))
        with pytest.raises(err):
            m.make_schedule("no_such_schedule", (8,))
        with pytest.raises(err):
            m.random_matching_schedule(8, 0)
        with pytest.raises(err):
            m.make_topology("no_such_graph", (8,))
        with pytest.raises(err):
            m.TopologySchedule("empty", ())
    bad = top.Topology("bad", np.eye(4), ((0, 0, 1.0),), (4,),
                       perms=((0, (0, 0, 1, 2), 0.0),))
    with pytest.raises(ValueError, match="permutation"):
        bad.validate()
    with pytest.raises(ValueError, match="grid"):
        top.TopologySchedule("mixed", (top.ring(8), top.torus((2, 4)))
                             ).validate()


def test_hierarchical_graphs_raise_naming_item_10():
    """Item 10 is ported: the hierarchical graphs build as the reference's,
    bit for bit (tests/test_torch_hierarchical.py), and refuse what the
    reference refuses."""
    for ours, ref in ((top.make_topology("hierarchical", (2, 4)),
                       r_top.make_topology("hierarchical", (2, 4))),
                      (top.hierarchical_schedule(4, 2).at(1),
                       r_top.hierarchical_schedule(4, 2).at(1))):
        np.testing.assert_array_equal(ours.W, ref.W)
        assert ours.shifts == ref.shifts
    assert top.make_schedule("hier_one_peer", (4, 2)).period == 2
    with pytest.raises(ValueError, match="grid"):
        top.make_topology("hierarchical", (8,))
    with pytest.raises(ValueError, match="grid"):
        top.make_schedule("hier_one_peer", (8,))


# ------------------------------------------------------------ DenseComm
def _stacked_tree(K, seed=0):
    rng = np.random.default_rng(seed)
    return {"conv": rng.standard_normal((K, 3, 3, 2, 4), dtype=np.float32),
            "bias": rng.standard_normal((K, 5), dtype=np.float32)}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_scheduled_dense_comm_equals_reference(name):
    """Round r's mix with an int and with a 0-d tensor round index, over
    two cycles; the period, the cycle and the topology of each round."""
    ours = DenseComm(SCHEDULES[name](top), device="cpu")
    theirs = r_gossip.DenseComm(SCHEDULES[name](r_top))
    assert ours.period == theirs.period
    assert ours.round_cycle == theirs.round_cycle
    assert ours.topology.name == theirs.topology.name
    K = ours.topology.n_workers
    tree = _stacked_tree(K, seed=K)
    ptree = params_from_reference(tree, "cpu")
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    for r in range(2 * ours.period):
        assert ours.topology_at(r).name == theirs.topology_at(r).name
        want = theirs.mix(jtree, r=jnp.int32(r))
        for rr in (r, torch.tensor(r, dtype=torch.int32)):
            got = ours.mix(ptree, r=rr)
            for k in tree:
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), rtol=1e-6,
                                           atol=1e-7)
    if ours.period > 1:
        for comm in (ours, theirs):
            with pytest.raises(ValueError, match="round index"):
                comm.mix(ptree if comm is ours else jtree)


# ------------------------------------------------------------ gossip_mix
def test_gossip_mix_launch_count():
    """One launch takes up to 32 inputs; past that a mix chains launches
    of at most 32, each later one taking the partial sum: 1 + ⌈(n − 32)/31⌉
    (the values themselves are held at n = 9, 17 and 33 in
    tests/test_torch_kernels.py)."""
    assert [launch_count(n) for n in range(1, 10)] == [1] * 9
    assert [launch_count(n) for n in (15, 16, 17, 22, 23, 33)] == \
        [1, 1, 1, 1, 1, 2]
    assert [launch_count(n) for n in (32, 63, 64, 94, 95)] == [1, 2, 3, 3, 4]


# ------------------------------------------------------------ rounds
def _quad_setup(K, seed=0, steps=13):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((K, 2500), dtype=np.float32),
              "b": rng.standard_normal((K, 7), dtype=np.float32)}
    batches = [{"y": rng.standard_normal((K, 2500), dtype=np.float32),
                "c": rng.standard_normal((K, 7), dtype=np.float32)}
               for _ in range(steps)]
    return params, batches


def _quad_loss_jax(p, b):
    return (0.5 * jnp.mean((p["w"] - b["y"]) ** 2)
            + 0.5 * jnp.mean((p["b"] - b["c"]) ** 2)), {}


def _quad_loss_torch(p, b):
    return (0.5 * torch.mean((p["w"] - b["y"]) ** 2)
            + 0.5 * torch.mean((p["b"] - b["c"]) ** 2)), {}


def _port_train(opt, params, batches, steps, **kw):
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    return SimTrainer(_quad_loss_torch, opt, device="cpu").train(
        params_from_reference(params, "cpu"), lambda t: tb[t], steps,
        log_every=1, **kw)


def _ref_train(opt, params, batches, steps):
    out = RSimTrainer(_quad_loss_jax, opt).train(
        jax.tree_util.tree_map(jnp.asarray, params),
        lambda t: jax.tree_util.tree_map(jnp.asarray, batches[t]), steps,
        log_every=1)
    return jax.tree_util.tree_map(np.array, out[0]), out[1], out[2]


SCHEDULED_RUNS = {
    "one_peer_exp": (8, lambda m: m.make_schedule("one_peer_exp", (8,))),
    "random_matching": (8, lambda m: m.make_schedule(
        "random_matching", (8,), rounds=3, seed=2)),
    "alt_axes": (8, lambda m: m.make_schedule("alt_axes", (2, 4))),
    "exponential16": (16, lambda m: m.exponential(16)),
    "disconnected": (4, lambda m: m.disconnected(4)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULED_RUNS))
def test_scheduled_pdsgdm_matches_reference(name):
    """PD-SGDM through SimTrainer on the kernel layout, two schedule
    cycles and a tail step, against the reference's kernel round (Pallas
    in interpret mode): the time-varying graphs and the disconnected one
    mix through ``comm.mix`` with round r's W; the exponential graph
    through the shifted-view AXPY of 9 inputs, chained past 8 in the port.
    Bytes per round cycle and comm-MB exactly; losses rtol 1e-5, params
    rtol 1e-5 / atol 1e-6 (measured: losses 1.2e-7 relative, params at
    most 2.4e-7 apart)."""
    K, build = SCHEDULED_RUNS[name]
    ours, theirs = build(top), build(r_top)
    T = ours.period if hasattr(ours, "period") else 1
    steps = 2 * T * P + 1
    params, batches = _quad_setup(K, steps=steps)
    opt = make_optimizer("pd_sgdm", DenseComm(ours, device="cpu"),
                         use_kernel=True, **HYPER)
    ropt = r_make_optimizer("pd_sgdm", r_gossip.DenseComm(theirs),
                            use_kernel=True, kernel_interpret=True, **HYPER)
    one = {k: v[0] for k, v in params.items()}
    assert opt.bytes_per_round_cycle(params_from_reference(one, "cpu")) == \
        ropt.bytes_per_round_cycle(one)
    assert opt._mat_wire_static() == ropt._mat_wire_static()
    got, state, hist = _port_train(opt, params, batches, steps)
    want, _rstate, rhist = _ref_train(ropt, params, batches, steps)
    assert hist.comm_mb == rhist.comm_mb
    assert int(state["step"]) == steps
    np.testing.assert_allclose(hist.loss, rhist.loss, rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-6)


def test_scheduled_round_matches_numpy_reference():
    """The port's fused rounds under the one-peer schedule apply round r's
    W_r: cross-checked against a float64 numpy loop over two cycles, as
    tests/test_topology_schedule.py checks the reference."""
    K = 8
    sched = top.one_peer_exponential_schedule(K)
    params, batches = _quad_setup(K, steps=2 * sched.period * P)
    opt = make_optimizer("pd_sgdm", DenseComm(sched, device="cpu"), eta=0.1,
                         mu=0.9, p=P)
    got, state, _ = _port_train(opt, params, batches, 2 * sched.period * P)
    x = params["w"].astype(np.float64)
    m = np.zeros_like(x)
    for r in range(2 * sched.period):
        for i in range(P):
            g = (x - batches[r * P + i]["y"]) / x.shape[1]
            m = 0.9 * m + g
            x = x - 0.1 * m
        x = sched.at(r).W @ x
    np.testing.assert_allclose(got["w"].numpy(), x, rtol=1e-5, atol=1e-5)
    assert int(state["step"]) == 2 * sched.period * P


@pytest.mark.parametrize("name", ["one_peer_exp", "alt_axes"])
def test_scheduled_kernel_round_equals_tree_round(name):
    """The port's kernel round against its tree round under a schedule:
    the p local steps are bit-identical, and the gossip is the same
    ``W_r @ flat`` on the matrix and on the leaves (measured: equal)."""
    K, build = SCHEDULED_RUNS[name]
    sched = build(top)
    steps = 2 * sched.period * P + 1
    params, batches = _quad_setup(K, steps=steps)
    outs = [_port_train(make_optimizer("pd_sgdm",
                                       DenseComm(sched, device="cpu"),
                                       use_kernel=uk, **HYPER),
                        params, batches, steps) for uk in (True, False)]
    np.testing.assert_allclose(outs[0][2].loss, outs[1][2].loss, rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(outs[0][0][k].numpy(),
                                   outs[1][0][k].numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("block", [8, LANE])
def test_scheduled_cpdsgdm_sign_matches_reference(block):
    """CPD-SGDM's sign wire under the one-peer schedule, three rounds and
    a tail step: the consensus with round r's W, the drift, the sign
    payload (per leaf at block 8; the kernel wire at block 1024) and bytes
    of round r's degree.  Bytes and comm-MB exactly; params rtol 1e-3 /
    atol 1e-4 and x̂ to the same bars (measured: params 3.6e-7, x̂ 4.8e-7
    apart: no drift sat on a sign)."""
    K = 8
    steps = 3 * P + 1
    params, batches = _quad_setup(K, seed=3, steps=steps)
    hyper = dict(HYPER, gamma=0.4)
    opt = make_optimizer(
        "cpd_sgdm", DenseComm(top.one_peer_exponential_schedule(K),
                              device="cpu"),
        use_kernel=True, compressor=SignCompressor(block=block), **hyper)
    ropt = r_make_optimizer(
        "cpd_sgdm", r_gossip.DenseComm(r_top.one_peer_exponential_schedule(K)),
        use_kernel=True, kernel_interpret=True,
        compressor=RSign(block=block), **hyper)
    assert opt.kernel_comm_supported == ropt.kernel_comm_supported \
        == (block == LANE)
    one = {k: v[0] for k, v in params.items()}
    cycle = opt.bytes_per_round_cycle(params_from_reference(one, "cpu"))
    assert cycle == ropt.bytes_per_round_cycle(one)
    assert len(cycle) == 3
    got, state, hist = _port_train(opt, params, batches, steps)
    want, rstate, rhist = _ref_train(ropt, params, batches, steps)
    assert hist.comm_mb == rhist.comm_mb
    np.testing.assert_allclose(hist.loss, rhist.loss, rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(state["xhat"][k].numpy(),
                                   np.asarray(rstate["xhat"][k]), rtol=1e-3,
                                   atol=1e-4)


def test_exponential16_kernel_round_launches():
    """On the CPU the plain versions count no launch; the shifted-view mix
    of exponential(16) takes 9 views on one axis, which a CUDA tensor
    runs as one launch a round."""
    opt = make_optimizer("pd_sgdm", DenseComm(top.exponential(16),
                                              device="cpu"),
                         use_kernel=True, **HYPER)
    assert opt._mat_wire_static()
    views = [s for s in opt.comm.topology.shifts if s[0] == 0]
    assert len(views) == 9 and launch_count(len(views)) == 1
    params, batches = _quad_setup(16, steps=P)
    before = (momentum_update.launches, gossip_mix.launches)
    _port_train(opt, params, batches, P)
    assert (momentum_update.launches, gossip_mix.launches) == before
