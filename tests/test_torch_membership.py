"""Elastic membership in the port against the reference: membership
schedules, masked matrices, the masked dense gossip, revival warm-starts
and bytes per round under churn.

Schedules and masked matrices are numpy on both sides, built by the same
arithmetic in the same order, so they are held bit for bit, and so are
the stacked f32 matrices each ``DenseComm`` selects and the bytes per
round.  ``DenseComm.mix`` is ``W @ flat``, a K-term reduction whose order
neither side pins (BLAS on both): held to rtol 1e-6 / atol 1e-7
(measured: at most 1 ulp).  Within the port, a ``full_membership`` comm
and an all-active round mix bit for bit as a comm without membership.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import elastic as r_elastic  # noqa: E402
from repro.core import make_compressor as r_make_compressor  # noqa: E402
from repro.core import make_optimizer as r_make_optimizer  # noqa: E402
from repro.core import gossip as r_gossip  # noqa: E402
from repro.core import topology as r_top  # noqa: E402
from repro.testing import chaos_script as r_chaos_script  # noqa: E402
from repro_torch.checkpoint import pick_donor, warm_start_worker  # noqa: E402
from repro_torch.core import make_compressor, make_optimizer  # noqa: E402
from repro_torch.core import topology as top  # noqa: E402
from repro_torch.core.gossip import (DenseComm,  # noqa: E402
                                     gossip_bytes_per_round)

K = 8
# the churn script of chip_smoke.py's churn paths, and
# tests/test_chaos.py's event-semantics script
SCRIPTS = {
    "churn3": (3, [(0, "kill", 3), (1, "straggle", 6), (2, "revive", 3)]),
    "semantics6": (6, [(1, "kill", 2), (3, "revive", 2), (2, "straggle", 5)]),
    "seed7": (12, [(e.round, e.kind, e.worker)
                   for e in r_chaos_script(K, 12, seed=7)]),
    "seed11_hot": (16, [(e.round, e.kind, e.worker)
                        for e in r_chaos_script(K, 16, seed=11,
                                                kill_prob=0.25,
                                                straggle_prob=0.25)]),
}
TOPOLOGIES = {
    "ring8": lambda m: m.ring(K),
    "exponential8": lambda m: m.exponential(K),
    "complete8": lambda m: m.complete(K),
    "torus2x4": lambda m: m.torus((2, 4)),
    "matching8": lambda m: m.random_matching_schedule(K, 3, seed=1).at(1),
}


def _memberships(name):
    n, events = SCRIPTS[name]
    return (top.membership_from_events(K, n, events),
            r_top.membership_from_events(K, n, events))


# ------------------------------------------------------------ the schedules
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_membership_from_events_matches_reference(name):
    ours, ref = _memberships(name)
    assert ours.name == ref.name and ours.period == ref.period
    assert ours.n_workers == ref.n_workers == K
    np.testing.assert_array_equal(ours.live, ref.live)
    np.testing.assert_array_equal(ours.active, ref.active)
    assert ours.all_active() == ref.all_active()
    for r in range(2 * ours.period):
        np.testing.assert_array_equal(ours.live_at(r), ref.live_at(r))
        np.testing.assert_array_equal(ours.active_at(r), ref.active_at(r))


def test_full_membership_matches_reference():
    ours, ref = top.full_membership(K), r_top.full_membership(K)
    np.testing.assert_array_equal(ours.live, ref.live)
    np.testing.assert_array_equal(ours.active, ref.active)
    assert ours.period == 1 and ours.all_active()


BAD = {
    "kind": lambda m: m.membership_from_events(K, 3, [(0, "pause", 1)]),
    "worker": lambda m: m.membership_from_events(K, 3, [(0, "kill", K)]),
    "round": lambda m: m.membership_from_events(K, 3, [(3, "kill", 1)]),
    "active_not_live": lambda m: m.MembershipSchedule(
        "x", np.array([[True, False]]), np.array([[True, True]])).validate(),
    "nobody_live": lambda m: m.MembershipSchedule(
        "x", np.zeros((2, 2), bool), np.zeros((2, 2), bool)).validate(),
    "dtype": lambda m: m.MembershipSchedule(
        "x", np.ones((1, 2)), np.ones((1, 2))).validate(),
    "shape": lambda m: m.MembershipSchedule(
        "x", np.ones((1, 2), bool), np.ones((2, 2), bool)).validate(),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_membership_refusals_match_reference(case):
    with pytest.raises(ValueError) as ours:
        BAD[case](top)
    with pytest.raises(ValueError) as ref:
        BAD[case](r_top)
    assert str(ours.value) == str(ref.value)


# ------------------------------------------------------- masked matrices
@pytest.mark.parametrize("tname", sorted(TOPOLOGIES))
def test_masked_matrix_and_edges_match_reference(tname):
    """Every round of two scripts, and every single-worker mask: the
    masked matrix bit for bit (float64), the active-edge count exactly;
    an all-active mask gives the structure matrix to 1e-15 (the self
    weight is 1 − Σ there, not the topology's own entry)."""
    t, rt = TOPOLOGIES[tname](top), TOPOLOGIES[tname](r_top)
    masks = [np.eye(K, dtype=bool)[k] for k in range(K)]
    masks += [~m for m in masks] + [np.ones(K, bool)]
    for name in ("seed7", "seed11_hot"):
        ms = _memberships(name)[0]
        masks += [ms.active_at(r) for r in range(ms.period)]
    for act in masks:
        got = top.masked_matrix(t, act)
        want = r_top.masked_matrix(rt, act)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        assert top.active_edge_count(t, act) == \
            r_top.active_edge_count(rt, act)
    full = np.ones(K, bool)
    np.testing.assert_allclose(top.masked_matrix(t, full),
                               t.structure_matrix(), rtol=0, atol=1e-15)
    assert top.active_edge_count(t, full) == K * t.degree
    with pytest.raises(ValueError):
        top.masked_matrix(t, np.ones(K + 1, bool))


def test_round_cycle_is_the_joint_period():
    """A one-peer schedule (period 3 at K = 8) under a 16-round membership:
    48 rounds; the matrices, active masks and edges per worker of every
    round equal the reference's."""
    ms, rms = (m.membership_from_events(K, 16, SCRIPTS["seed11_hot"][1])
               for m in (top, r_top))
    comm = DenseComm(top.make_schedule("one_peer_exp", (K,)), membership=ms,
                     device="cpu")
    rcomm = r_gossip.DenseComm(r_top.make_schedule("one_peer_exp", (K,)),
                               membership=rms)
    assert comm.round_cycle == rcomm.round_cycle == 48
    assert tuple(comm._Wm.shape) == (48, K, K)
    assert tuple(comm._act.shape) == (48, K)
    np.testing.assert_array_equal(comm._Wm.numpy(), np.asarray(rcomm._Wm))
    np.testing.assert_array_equal(comm._act.numpy(), np.asarray(rcomm._act))
    for r in range(50):
        np.testing.assert_array_equal(comm.effective_matrix(r),
                                      rcomm.effective_matrix(r))
        np.testing.assert_array_equal(comm.active_at(r), rcomm.active_at(r))
        assert comm.edges_per_worker(r) == rcomm.edges_per_worker(r)
        assert type(comm.edges_per_worker(r)) is \
            type(rcomm.edges_per_worker(r))


@pytest.mark.parametrize("tname", ["ring8", "exponential8", "torus2x4"])
def test_effective_matrix_and_active_at_match_reference(tname):
    ms, rms = _memberships("seed7")
    comm = DenseComm(TOPOLOGIES[tname](top), membership=ms, device="cpu")
    rcomm = r_gossip.DenseComm(TOPOLOGIES[tname](r_top), membership=rms)
    assert comm.round_cycle == rcomm.round_cycle == ms.period
    for r in range(ms.period):
        np.testing.assert_array_equal(comm.effective_matrix(r),
                                      rcomm.effective_matrix(r))
        np.testing.assert_array_equal(comm.active_at(r), rcomm.active_at(r))
        np.testing.assert_array_equal(comm._W_at(r).numpy(),
                                      np.asarray(rcomm._W_at(r)))
        np.testing.assert_array_equal(comm.active_mask(r).numpy(),
                                      np.asarray(rcomm.active_mask(r)))
        assert comm.edges_per_worker(r) == rcomm.edges_per_worker(r)
    plain = DenseComm(TOPOLOGIES[tname](top), device="cpu")
    assert plain.active_mask(3) is None
    np.testing.assert_array_equal(plain.active_at(3), np.ones(K, bool))


# ----------------------------------------------------------- the dense mix
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((K, 33, 65), dtype=np.float32),
            "b": rng.standard_normal((K, 7), dtype=np.float32)}


@pytest.mark.parametrize("r_kind", ["int", "tensor"])
def test_dense_mix_matches_reference(r_kind):
    """Round r's masked mix, r a Python int or a 0-d tensor (selected on
    the device), against the reference at every round of the script:
    rtol 1e-6 / atol 1e-7.  The matrix selected is the reference's, bit
    for bit."""
    ms, rms = _memberships("seed7")
    comm = DenseComm(top.ring(K), membership=ms, device="cpu")
    rcomm = r_gossip.DenseComm(r_top.ring(K), membership=rms)
    tree = _tree()
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    for r in range(ms.period + 2):
        rr = r if r_kind == "int" else torch.tensor(r, dtype=torch.int32)
        np.testing.assert_array_equal(comm._W_at(rr).numpy(),
                                      np.asarray(rcomm._W_at(r)))
        got = comm.mix(ttree, r=rr)
        want = rcomm.mix({k: jnp.asarray(v) for k, v in tree.items()}, r=r)
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(
            comm.active_mask(rr).numpy(), ms.active_at(r))


@pytest.mark.parametrize("graph", ["ring8", "one_peer8"])
def test_full_membership_mixes_bitwise_as_none(graph):
    """``full_membership`` and the all-active rounds of a script reuse the
    topology's own W: the mix is bit for bit that of a comm without
    membership."""
    def make(m):
        return (top.ring(K) if graph == "ring8"
                else top.make_schedule("one_peer_exp", (K,)))
    tree = {k: torch.from_numpy(v) for k, v in _tree(1).items()}
    plain = DenseComm(make(top), device="cpu")
    full = DenseComm(make(top), membership=top.full_membership(K),
                     device="cpu")
    churn = DenseComm(make(top), membership=_memberships("churn3")[0],
                      device="cpu")
    for r in range(6):
        for rr in (r, torch.tensor(r)):
            want = plain.mix(tree, r=rr)
            for k, v in full.mix(tree, r=rr).items():
                assert torch.equal(v, want[k])
            if churn.active_at(r).all():            # round 2 of each cycle
                for k, v in churn.mix(tree, r=rr).items():
                    assert torch.equal(v, want[k])


def test_round_index_needed_past_one_round():
    """A cycle longer than 1 needs the round index, as in the reference;
    full membership does not; a mismatched K is refused."""
    comm = DenseComm(top.ring(K), membership=_memberships("churn3")[0],
                     device="cpu")
    rcomm = r_gossip.DenseComm(r_top.ring(K),
                               membership=_memberships("churn3")[1])
    tree = {"w": torch.ones(K, 3)}
    for fn, rfn in ((lambda: comm.mix(tree),
                     lambda: rcomm.mix({"w": jnp.ones((K, 3))})),
                    (lambda: comm.active_mask(None),
                     lambda: rcomm.active_mask(None))):
        with pytest.raises(ValueError) as ours:
            fn()
        with pytest.raises(ValueError) as ref:
            rfn()
        assert str(ours.value) == str(ref.value)
    full = DenseComm(top.ring(K), membership=top.full_membership(K),
                     device="cpu")
    assert torch.equal(full.mix(tree)["w"], tree["w"])
    assert bool(full.active_mask(None).all())
    with pytest.raises(ValueError):
        DenseComm(top.ring(4), membership=top.full_membership(K),
                  device="cpu")
    # the stale mix needs it too (tests/test_torch_overlap.py)
    with pytest.raises(ValueError) as ours:
        comm.stale_mix(tree)
    with pytest.raises(ValueError) as ref:
        rcomm.stale_mix({"w": jnp.ones((K, 3))})
    assert str(ours.value) == str(ref.value)


# ----------------------------------------------------------- warm starts
@pytest.mark.parametrize("live,joiner", [
    ((1, 0, 0, 1, 1, 1, 1, 1), 1), ((1, 0, 0, 1, 1, 1, 1, 1), 2),
    ((0, 0, 0, 0, 0, 0, 1, 0), 2), ((1, 1, 1, 1, 1, 1, 1, 1), 7),
    ((0, 1, 0, 0), 0)])
def test_pick_donor_matches_reference(live, joiner):
    assert pick_donor(np.array(live, bool), joiner) == \
        r_elastic.pick_donor(np.array(live, bool), joiner)


def test_pick_donor_refuses_an_empty_fleet():
    with pytest.raises(ValueError, match="no live donor"):
        pick_donor(np.zeros(4, bool), 0)


def test_warm_start_worker_on_a_cpd_state_matches_reference():
    """A CPD-SGDM state after one round (m, x̂, step): the joiner's slot is
    the donor's in params and every state tree, the other slots and the
    step counter are untouched, and the caller's tensors are not written;
    equal to the reference's result bit for bit."""
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((K, 24), dtype=np.float32)}
    b = rng.standard_normal((K, 24), dtype=np.float32)
    opt = make_optimizer("cpd_sgdm", DenseComm(top.ring(K), device="cpu"),
                         eta=0.05, mu=0.9, p=2, gamma=0.5,
                         compressor=make_compressor("sign"))
    ropt = r_make_optimizer("cpd_sgdm", r_gossip.DenseComm(r_top.ring(K)),
                            eta=0.05, mu=0.9, p=2, gamma=0.5,
                            compressor=r_make_compressor("sign"))
    tb = torch.from_numpy(b)
    tp = {"w": torch.from_numpy(params["w"].copy())}
    tp, ts, _ = opt.round(opt.init(tp), tp,
                          lambda p, _: (torch.zeros(()),
                                        {"w": p["w"] - tb}),
                          {"dummy": torch.zeros(2, 1)})
    rp = {"w": jnp.asarray(params["w"])}
    rp, rs, _ = ropt.round(ropt.init(rp), rp,
                           lambda p, _: (0.0, {"w": p["w"] - b}),
                           jnp.zeros((2, 1)))
    before = {"w": tp["w"].clone(), "m": ts["m"]["w"].clone(),
              "xhat": ts["xhat"]["w"].clone()}
    wp, ws = warm_start_worker(tp, ts, joiner=3, donor=6)
    rwp, rws = r_elastic.warm_start_worker(rp, rs, joiner=3, donor=6)
    assert torch.equal(tp["w"], before["w"])                 # not written
    assert torch.equal(ts["m"]["w"], before["m"])
    assert torch.equal(ts["xhat"]["w"], before["xhat"])
    for got, src in ((wp["w"], before["w"]), (ws["m"]["w"], before["m"]),
                     (ws["xhat"]["w"], before["xhat"])):
        assert torch.equal(got[3], src[6])
        keep = [i for i in range(K) if i != 3]
        assert torch.equal(got[keep], src[keep])
    assert int(ws["step"]) == int(np.asarray(rws["step"])) == 2
    np.testing.assert_allclose(wp["w"].numpy(), np.asarray(rwp["w"]),
                               rtol=1e-6, atol=1e-6)
    for key in ("m", "xhat"):
        np.testing.assert_allclose(ws[key]["w"].numpy(),
                                   np.asarray(rws[key]["w"]),
                                   rtol=1e-6, atol=1e-6)
    # the copy is exact: the port's own slots, moved
    assert set(ws) == set(rws) == {"m", "step", "xhat"}


# --------------------------------------------------------- bytes under churn
OPTS = {
    "pd": ("pd_sgdm", {}),
    "cpd_sign": ("cpd_sgdm", {"compressor": ("sign", {})}),
    "cpd_topk": ("cpd_sgdm", {"compressor": ("topk", {"fraction": 0.1})}),
    "mt": ("mt_dsgdm", {}),
    "mt_sign": ("mt_dsgdm", {"compressor": ("sign", {})}),
    "qg": ("qg_dsgdm", {}),
}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("oname", sorted(OPTS))
def test_bytes_per_round_cycle_matches_reference(oname, use_kernel):
    """``bytes_per_round_cycle`` over a 12-round script on ring(8) and on
    the one-peer schedule (joint cycle 12), tree and kernel layout: every
    round's bytes equal the reference's, value and type (a float in a
    churn round, an int in an all-active one)."""
    name, kw = OPTS[oname]
    tree = {"w": np.zeros((2500,), np.float32), "b": np.zeros((7,),
                                                               np.float32)}
    ms, rms = _memberships("seed7")
    for graph in ("ring", "one_peer_exp"):
        def make(m):
            return (m.ring(K) if graph == "ring"
                    else m.make_schedule("one_peer_exp", (K,)))
        ckw, rkw = dict(kw), dict(kw)
        if "compressor" in kw:
            cname, ckws = kw["compressor"]
            ckw["compressor"] = make_compressor(cname, **ckws)
            rkw["compressor"] = r_make_compressor(cname, **ckws)
        opt = make_optimizer(name, DenseComm(make(top), membership=ms,
                                             device="cpu"),
                             use_kernel=use_kernel, **ckw)
        ropt = r_make_optimizer(name, r_gossip.DenseComm(make(r_top),
                                                         membership=rms),
                                use_kernel=use_kernel, **rkw)
        got = opt.bytes_per_round_cycle(
            {k: torch.from_numpy(v) for k, v in tree.items()})
        want = ropt.bytes_per_round_cycle(
            {k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
             for k, v in tree.items()})
        assert len(got) == 12
        assert got == want
        assert [type(v) for v in got] == [type(v) for v in want]


def test_gossip_bytes_per_round_under_churn():
    """The membership branch: active edges per worker × the leaf bytes, or
    × elements × bits / 8 (a float)."""
    ms, rms = _memberships("churn3")
    comm = DenseComm(top.ring(K), membership=ms, device="cpu")
    rcomm = r_gossip.DenseComm(r_top.ring(K), membership=rms)
    tree = {"w": torch.zeros(272_282)}
    rtree = {"w": jax.ShapeDtypeStruct((272_282,), jnp.float32)}
    for r in range(3):
        for bits in (None, 1.0, 32.0):
            got = gossip_bytes_per_round(tree, comm, bits, r=r)
            assert got == r_gossip.gossip_bytes_per_round(rtree, rcomm,
                                                          bits, r=r)
    assert [gossip_bytes_per_round(tree, comm, r=r) for r in range(3)] == \
        [1_633_692.0, 1_089_128.0, 2_178_256]
