"""Overlapped rounds in the port against the reference: one-round-stale
delayed mixing (``overlap=True``) on the dense backend.

Round r's payload, the snapshot of the params (CPD: of x̂) at round r's
end, is exchanged at the start of round r+1 and lands at its end,
``x ← x + gate·(W̃·buf − buf)``, with W̃ the payload round's topology masked
by the delivery round's liveness.  The port runs the reference's smooth
model (K = 4 on a ring, p = 4, η = 0.05, μ = 0.9; gradient 0.1·x + b) from
the same numpy params, and is held against the reference's own run and
against the reference tests' numpy oracles.

Tolerances: the per-step arithmetic is the same on both sides, but XLA may
contract a product and a sum into one FMA and sums ``W @ x`` in its own
order, so params and state agree to a few f32 ulps of their magnitude
(about 1): atol 2e-6 after 3-4 rounds (measured: at most 2.4e-7); the
numpy oracles keep the reference tests' bars (2e-5, 3e-5).  What the
reference pins is held bit for bit: every stale matrix, the gated round 0
(signs of zero included) and the bytes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import elastic as r_elastic  # noqa: E402
from repro.core import make_compressor as r_make_compressor  # noqa: E402
from repro.core import make_optimizer as r_make_optimizer  # noqa: E402
from repro.core.gossip import DenseComm as RDenseComm  # noqa: E402
from repro.core import topology as r_top  # noqa: E402
from repro.testing import chaos_script as r_chaos_script  # noqa: E402
from repro_torch.checkpoint import warm_start_worker  # noqa: E402
from repro_torch.core import (PDSGDM, DenseComm,  # noqa: E402
                              make_compressor, make_optimizer)
from repro_torch.core import topology as top  # noqa: E402


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


K, P, ETA, MU = 4, 4, 0.05, 0.9
ATOL = 2e-6


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((K, 5)).astype(np.float32),
            "b": np.ones((K, 2), np.float32)}


def _batches(p=P):
    return np.arange(p, dtype=np.float32) * 0.01


def _ref_grads(params, batch):
    g = jax.tree_util.tree_map(lambda x: 0.1 * x + batch, params)
    return sum(jnp.sum(v) for v in jax.tree_util.tree_leaves(g)), g


def _grads(params, batch):
    g = {k: 0.1 * v + batch["b"] for k, v in params.items()}
    return sum(v.sum() for v in g.values()), g


def _port(params):
    return {k: torch.from_numpy(v.copy()) for k, v in params.items()}


def _run(opt, params, rounds, p=P):
    params = _port(params)
    state = opt.init(params)
    for _ in range(rounds):
        params, state, _ = opt.round(state, params, _grads,
                                     {"b": torch.from_numpy(_batches(p))})
    return params, state


def _ref_run(opt, params, rounds, p=P):
    params = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(params)
    for _ in range(rounds):
        params, state, _ = opt.round(state, params, _ref_grads,
                                     jnp.asarray(_batches(p)))
    return params, state


def _close(got, want, atol=ATOL):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=atol, rtol=0)


def _comms(membership=None, ref_membership=None, topo="ring"):
    return (DenseComm(getattr(top, topo)(K), membership=membership,
                      device="cpu"),
            RDenseComm(getattr(r_top, topo)(K), membership=ref_membership))


def _pair(name, **kw):
    comm, rcomm = _comms()
    comp = kw.pop("compressor", None)
    ours = make_optimizer(name, comm, eta=ETA, mu=MU, p=P, overlap=True,
                          compressor=make_compressor(comp) if comp else None,
                          **kw)
    ref = r_make_optimizer(name, rcomm, eta=ETA, mu=MU, p=P, overlap=True,
                           compressor=(r_make_compressor(comp) if comp
                                       else None), **kw)
    return ours, ref


def _mixW(W, tree):
    return {k: (W @ v.reshape(K, -1)).reshape(v.shape)
            for k, v in tree.items()}


# ------------------------------------------------------------------ oracles
def _pd_oracle(W_at, params, rounds, p=P, gamma=1.0):
    """The reference tests' two-phase delayed-mixing walk (PD; CPD with the
    identity codec is the same walk, γ-scaled, buf ≡ x̂ ≡ x)."""
    x = {k: v.copy() for k, v in params.items()}
    m = {k: np.zeros_like(v) for k, v in x.items()}
    b = _batches(p)
    buf, have = None, False
    for rnd in range(rounds):
        if have:
            mx = _mixW(W_at(rnd - 1), buf)
            dx = {k: gamma * (mx[k] - buf[k]) for k in x}
        for i in range(p):
            for k in x:
                g = 0.1 * x[k] + float(b[i])
                m[k] = MU * m[k] + g
                x[k] = x[k] - ETA * m[k]
        if have:
            for k in x:
                x[k] = x[k] + dx[k]
        buf, have = {k: v.copy() for k, v in x.items()}, True
    return x


# --------------------------------------------------------- each family
@pytest.mark.parametrize("name,kw", [
    ("pd_sgdm", {}), ("mt_dsgdm", {}), ("qg_dsgdm", {}), ("pd_sgd", {}),
    ("cpd_sgdm", {"gamma": 0.4, "compressor": "identity"}),
    ("cpd_sgdm", {"gamma": 0.4, "compressor": "sign"})])
def test_overlap_tree_round_matches_reference(name, kw):
    """Three rounds of every family that overlaps, from the same params:
    params, the in-flight payload and its phase, and the family's own
    state (m, MT's c and buf_c, QG's x_prev, CPD's x̂)."""
    ours, ref = _pair(name, **kw)
    got, st = _run(ours, _np_params(), 3)
    want, sr = _ref_run(ref, _np_params(), 3)
    _close(got, want)
    assert int(st["mix"]["phase"]) == int(sr["mix"]["phase"]) == 1
    assert st["mix"]["phase"].dtype == torch.int32
    assert sorted(st["mix"]) == sorted(sr["mix"])
    for key in ("buf", "buf_c"):
        if key in sr["mix"]:
            _close(st["mix"][key], sr["mix"][key])
    for key in ("m", "c", "g_prev", "xprev", "xhat"):
        if key in sr:
            _close(st[key], sr[key])
    assert type(ours).overlap_delta_keys == type(ref).overlap_delta_keys
    assert ours.overlap_refreshes == ref.overlap_refreshes


def test_pd_overlap_matches_delayed_mixing_oracle():
    ours, _ = _pair("pd_sgdm")
    got, st = _run(ours, _np_params(), 3)
    W = np.asarray(ours.comm.effective_stale_matrix(0), np.float32)
    x = _pd_oracle(lambda r: W, _np_params(), 3)
    _close(got, x, atol=2e-5)
    _close(st["mix"]["buf"], x, atol=2e-5)   # the next in-flight payload


@pytest.mark.parametrize("name", ["pd_sgdm", "mt_dsgdm", "qg_dsgdm"])
def test_overlap_kernel_round_matches_tree_round(name):
    """The kernel layout (the stale mix through the gossip kernel's plain
    version, the landing through ``ops.delayed_mix_mat``, MT's drip through
    the (1, 1/p) mix) against the tree path, 4 rounds."""
    comm = DenseComm(top.ring(K), device="cpu")
    tree = make_optimizer(name, comm, eta=ETA, mu=MU, p=P, overlap=True)
    kern = make_optimizer(name, comm, eta=ETA, mu=MU, p=P, overlap=True,
                          use_kernel=True)
    pt, st = _run(tree, _np_params(), 4)
    pk, sk = _run(kern, _np_params(), 4)
    _close(pk, {k: v.numpy() for k, v in pt.items()})
    assert int(sk["mix"]["phase"]) == 1
    for key in ("buf", "buf_c"):
        if key in st["mix"]:
            _close(sk["mix"][key],
                   {k: v.numpy() for k, v in st["mix"][key].items()})
    for key in ("m", "c", "xprev"):
        if key in st:
            _close(sk[key], {k: v.numpy() for k, v in st[key].items()})


@pytest.mark.parametrize("name", ["pd_sgdm", "mt_dsgdm"])
def test_overlap_fused_matches_per_step(name):
    """``step`` (the per-step form: the correction formed every step from
    the in-flight payload, landed at the step that ends a round) walks the
    fused round's trajectory, and the reference's per-step walk."""
    ours, ref = _pair(name)
    params = _np_params()
    pr, sr = _port(params), ours.init(_port(params))
    ps, ss = _port(params), ours.init(_port(params))
    qs = {k: jnp.asarray(v) for k, v in params.items()}
    qss = ref.init(qs)
    b = _batches()
    for _ in range(2):
        pr, sr, _ = ours.round(sr, pr, _grads, {"b": torch.from_numpy(b)})
        for i in range(P):
            _, g = _grads(ps, {"b": torch.tensor(b[i])})
            ps, ss = ours.step(ss, ps, g)
            _, rg = _ref_grads(qs, jnp.asarray(b[i]))
            qs, qss = ref.step(qss, qs, rg)
    _close(ps, {k: v.numpy() for k, v in pr.items()}, atol=1e-6)
    _close(ps, qs)
    assert int(ss["mix"]["phase"]) == 1
    assert int(ss["step"]) == 2 * P


def test_per_step_form_without_overlap_gossips_at_round_ends():
    """``maybe_communicate`` gossips exactly when the step ends a round."""
    comm = DenseComm(top.ring(K), device="cpu")
    opt = make_optimizer("pd_sgdm", comm, eta=ETA, mu=MU, p=P)
    params = _port(_np_params())
    state = opt.init(params)
    fused, fstate, _ = opt.round(opt.init(params), params, _grads,
                                 {"b": torch.from_numpy(_batches())})
    for i in range(P):
        _, g = _grads(params, {"b": torch.tensor(_batches()[i])})
        params, state = opt.step(state, params, g)
        # evaluated after the local step advanced the counter
        assert bool(opt.is_comm_step(state)) == (i == P - 1)
    _close(params, {k: v.numpy() for k, v in fused.items()}, atol=1e-7)


# ------------------------------------------------------ membership: W̃
SCRIPT = r_chaos_script(K, 6, seed=7)


def _churn_comms():
    events = [(e.round, e.kind, e.worker) for e in SCRIPT]
    return _comms(top.membership_from_events(K, 6, events),
                  r_top.membership_from_events(K, 6, events))


def test_stale_matrices_match_reference_bit_for_bit():
    """Every round's stale matrix (payload round's topology, delivery
    round's liveness) in float64, the stacked f32 ``_Wov`` the comm selects
    on the device, and ``stale_mix`` at round 0, whose index r = −1 picks
    the cycle's last matrix as ``jnp.mod`` does, as an int and as a 0-d
    tensor."""
    comm, rcomm = _churn_comms()
    assert comm.round_cycle == rcomm.round_cycle == 6
    for r in range(-1, 2 * comm.round_cycle):
        np.testing.assert_array_equal(comm.effective_stale_matrix(r),
                                      rcomm.effective_stale_matrix(r))
    np.testing.assert_array_equal(comm._Wov.numpy(), np.asarray(rcomm._Wov))
    x = np.random.default_rng(3).standard_normal((K, 6)).astype(np.float32)
    want = np.asarray(rcomm.stale_mix({"a": jnp.asarray(x)}, r=-1)["a"])
    for r in (-1, torch.tensor(-1, dtype=torch.int32)):
        got = comm.stale_mix({"a": torch.from_numpy(x)}, r=r)["a"].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            got, comm._Wov[-1].numpy() @ x, rtol=0, atol=0)
    # without membership the stale mix is the mix
    plain = DenseComm(top.ring(K), device="cpu")
    np.testing.assert_array_equal(
        plain.stale_mix({"a": torch.from_numpy(x)}, r=0)["a"].numpy(),
        plain.mix({"a": torch.from_numpy(x)}, r=0)["a"].numpy())
    with pytest.raises(ValueError, match="round index"):
        comm.stale_mix({"a": torch.from_numpy(x)})


@pytest.mark.parametrize("use_kernel", [False, True])
def test_pd_overlap_membership_stale_mask(use_kernel):
    """A payload from a worker that died in flight is dropped, its row
    renormalized: 4 rounds against the reference and the oracle built from
    ``effective_stale_matrix``; the kernel layout takes ``W̃ @ x`` on the
    matrix."""
    comm, rcomm = _churn_comms()
    ours = make_optimizer("pd_sgdm", comm, eta=ETA, mu=MU, p=P, overlap=True,
                          use_kernel=use_kernel)
    ref = r_make_optimizer("pd_sgdm", rcomm, eta=ETA, mu=MU, p=P,
                           overlap=True)
    got, _ = _run(ours, _np_params(), 4)
    want, _ = _ref_run(ref, _np_params(), 4)
    _close(got, want)
    x = _pd_oracle(
        lambda r: np.asarray(comm.effective_stale_matrix(r), np.float32),
        _np_params(), 4)
    _close(got, x, atol=2e-5)


@pytest.mark.parametrize("name,comp", [("cpd_sgdm", "sign"),
                                       ("mt_dsgdm", None),
                                       ("qg_dsgdm", None)])
def test_overlap_under_membership_matches_reference(name, comp):
    """CPD's stale consensus with its commit masks, MT's drip and QG's fold
    under the churn script: 4 rounds against the reference."""
    comm, rcomm = _churn_comms()
    kw = {"gamma": 0.4} if name == "cpd_sgdm" else {}
    ours = make_optimizer(name, comm, eta=ETA, mu=MU, p=P, overlap=True,
                          compressor=make_compressor(comp) if comp else None,
                          **kw)
    ref = r_make_optimizer(name, rcomm, eta=ETA, mu=MU, p=P, overlap=True,
                           compressor=(r_make_compressor(comp) if comp
                                       else None), **kw)
    got, st = _run(ours, _np_params(), 4)
    want, sr = _ref_run(ref, _np_params(), 4)
    _close(got, want)
    for key in ("xhat", "c", "m"):
        if key in sr:
            _close(st[key], sr[key])


def test_warm_start_copies_the_in_flight_payload():
    """A revived worker takes its donor's whole state, the overlapped
    round's payload included (``state["mix"]``), as the reference's does."""
    ours, ref = _pair("mt_dsgdm")
    _, st = _run(ours, _np_params(), 2)
    _, sr = _ref_run(ref, _np_params(), 2)
    params = _port(_np_params(1))
    p2, s2 = warm_start_worker(params, st, joiner=1, donor=2)
    rp2, rs2 = r_elastic.warm_start_worker(
        {k: jnp.asarray(v) for k, v in _np_params(1).items()}, sr,
        joiner=1, donor=2)
    _close(p2, rp2, atol=0)
    for key in ("buf", "buf_c"):
        _close(s2["mix"][key], rs2["mix"][key])
        assert torch.equal(s2["mix"][key]["w"][1], st["mix"][key]["w"][2])
    assert int(s2["mix"]["phase"]) == 1


# ------------------------------------------------------------ the oracles
def test_mt_overlap_matches_drip_oracle():
    """MT drips the stale dc in p equal parts after each local step and
    lands dx at round end; the drip keeps mean_k(c) = mean_k(ĝ)."""
    ours, _ = _pair("mt_dsgdm")
    W = np.asarray(ours.comm.effective_stale_matrix(0), np.float32)
    got, st = _run(ours, _np_params(), 4)
    x = _np_params()
    m = {k: np.zeros_like(v) for k, v in x.items()}
    c = {k: np.zeros_like(v) for k, v in x.items()}
    gp = {k: np.zeros_like(v) for k, v in x.items()}
    b = _batches()
    buf, buf_c, have = None, None, False
    for _ in range(4):
        if have:
            mx, mc = _mixW(W, buf), _mixW(W, buf_c)
            dx = {k: mx[k] - buf[k] for k in x}
            dc = {k: mc[k] - buf_c[k] for k in x}
        for i in range(P):
            for k in x:
                g = 0.1 * x[k] + float(b[i])
                c[k] = c[k] + g - gp[k]
                m[k] = MU * m[k] + c[k]
                x[k] = x[k] - ETA * m[k]
                gp[k] = g
            if have:
                for k in x:
                    c[k] = c[k] + dc[k] / P
        if have:
            for k in x:
                x[k] = x[k] + dx[k]
        buf = {k: v.copy() for k, v in x.items()}
        buf_c = {k: v.copy() for k, v in c.items()}
        have = True
    _close(got, x, atol=3e-5)
    _close(st["c"], c, atol=3e-5)
    np.testing.assert_allclose(st["c"]["w"].numpy().mean(axis=0),
                               gp["w"].mean(axis=0), atol=3e-5)


def test_qg_overlap_matches_oracle():
    """QG lands the stale correction, then folds (x_prev − x)/(ηp)."""
    ours, _ = _pair("qg_dsgdm")
    W = np.asarray(ours.comm.effective_stale_matrix(0), np.float32)
    got, st = _run(ours, _np_params(), 4)
    x = _np_params()
    m = {k: np.zeros_like(v) for k, v in x.items()}
    xprev = {k: v.copy() for k, v in x.items()}
    b = _batches()
    buf, have = None, False
    for _ in range(4):
        if have:
            mx = _mixW(W, buf)
            dx = {k: mx[k] - buf[k] for k in x}
        for i in range(P):
            for k in x:
                g = 0.1 * x[k] + float(b[i])
                x[k] = x[k] - ETA * (g + MU * m[k])
        if have:
            for k in x:
                x[k] = x[k] + dx[k]
        for k in x:
            m[k] = MU * m[k] + (1 - MU) * (xprev[k] - x[k]) / (ETA * P)
            xprev[k] = x[k].copy()
        buf, have = {k: v.copy() for k, v in x.items()}, True
    _close(got, x, atol=3e-5)
    _close(st["m"], m, atol=3e-5)


def test_cpd_overlap_matches_identity_q_oracle():
    """CPD with the identity codec: x̂ tracks x, so the round is the PD
    walk with a γ-scaled stale correction, the payload cut from x̂."""
    ours, _ = _pair("cpd_sgdm", gamma=0.4, compressor="identity")
    W = np.asarray(ours.comm.effective_stale_matrix(0), np.float32)
    got, st = _run(ours, _np_params(), 4)
    x = _pd_oracle(lambda r: W, _np_params(), 4, gamma=0.4)
    _close(got, x, atol=3e-5)
    _close(st["xhat"], x, atol=3e-5)


# --------------------------------------------------------------- round 0
def _bits(t):
    return np.asarray(t, np.float32).view(np.int32)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_overlap_round0_is_gated_noop(use_kernel):
    """Round 0 has nothing in flight: the gate makes the correction an
    exact no-op while the exchange runs, so the round equals a pure local
    scan bit for bit (signs of zero too: −0.0 in the params survives the
    +0.0·gate correction only as the reference's arithmetic leaves it)."""
    params = _np_params()
    params["w"][0, :2] = -0.0
    comm = DenseComm(top.ring(K), device="cpu")
    opt = make_optimizer("pd_sgdm", comm, eta=ETA, mu=MU, p=P, overlap=True,
                         use_kernel=use_kernel)
    sync = make_optimizer("pd_sgdm", comm, eta=ETA, mu=MU, p=P,
                          use_kernel=use_kernel)
    b = {"b": torch.from_numpy(_batches())}
    got, st, _ = opt.round(opt.init(_port(params)), _port(params), _grads, b)
    want, _, _ = sync.round(sync.init(_port(params)), _port(params), _grads,
                            b, gossip=False)
    assert int(st["mix"]["phase"]) == 1
    ref = r_make_optimizer("pd_sgdm", RDenseComm(r_top.ring(K)), eta=ETA,
                           mu=MU, p=P, overlap=True)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rgot, _, _ = ref.round(ref.init(rp), rp, _ref_grads,
                           jnp.asarray(_batches()))
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
        # the reference's momentum chain may contract into FMAs: equal
        # where the local scan is
        np.testing.assert_allclose(got[k].numpy(), np.asarray(rgot[k]),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["pd_sgdm", "mt_dsgdm"])
def test_round0_correction_is_signed_zero_as_in_the_reference(name):
    """The gated correction itself, bit for bit: (W̃·buf − buf)·0 is ±0.0
    element by element as the reference forms it (MT's dc too)."""
    ours, ref = _pair(name)
    params = _np_params()
    params["w"][0, :2] = -0.0
    got = ours.overlap_begin(ours.init(_port(params)))
    want = ref.overlap_begin(ref.init({k: jnp.asarray(v)
                                       for k, v in params.items()}))
    assert sorted(got) == sorted(want)
    for key in want:
        for k in want[key]:
            assert not np.any(got[key][k].numpy())
            np.testing.assert_array_equal(_bits(got[key][k]),
                                          _bits(want[key][k]))


# ------------------------------------------------------- construction
def test_overlap_unsupported_combos_raise_as_the_reference():
    comm, rcomm = _comms()
    bad = [
        ("cpd_sgdm", dict(use_kernel=True)),
        ("mt_dsgdm", dict(compressor="sign")),
        ("c_sgdm", {}), ("d_sgd", {}), ("choco_sgd", {}),
    ]
    for name, kw in bad:
        comp = kw.pop("compressor", None)
        with pytest.raises(ValueError) as ours:
            make_optimizer(name, comm, overlap=True,
                           compressor=make_compressor(comp) if comp
                           else None, **kw)
        with pytest.raises(ValueError) as ref:
            r_make_optimizer(name, rcomm, overlap=True,
                             compressor=r_make_compressor(comp) if comp
                             else None, **kw)
        if name == "cpd_sgdm":
            assert str(ours.value) == str(ref.value)


def test_pd_sgd_overlap_is_momentum_free_pd_sgdm():
    comm, rcomm = _comms()
    ours = make_optimizer("pd_sgd", comm, eta=0.2, p=8, weight_decay=1e-4,
                          overlap=True)
    ref = r_make_optimizer("pd_sgd", rcomm, eta=0.2, p=8, weight_decay=1e-4,
                           overlap=True)
    assert type(ours) is PDSGDM
    for f in ("eta", "mu", "p", "weight_decay", "overlap", "use_kernel"):
        assert getattr(ours.config, f) == getattr(ref.config, f)


def test_overlap_bytes_per_round_unchanged():
    """One payload exchange a round, as without overlap: the bytes per
    round equal the reference's and the synchronous round's."""
    from repro_torch.convert import params_from_reference
    tree = {"w": np.zeros((1024 * 3 + 5,), np.float32),
            "b": np.zeros((7,), np.float32)}
    ptree = params_from_reference(tree, "cpu")
    comm, rcomm = _comms()
    for name in ("pd_sgdm", "mt_dsgdm", "qg_dsgdm", "cpd_sgdm"):
        for use_kernel in ((False,) if name == "cpd_sgdm" else (False, True)):
            got = make_optimizer(name, comm, overlap=True,
                                 use_kernel=use_kernel
                                 ).bytes_per_round_cycle(ptree)
            assert got == r_make_optimizer(
                name, rcomm, overlap=True,
                use_kernel=use_kernel).bytes_per_round_cycle(tree)
            assert got == make_optimizer(
                name, comm, use_kernel=use_kernel).bytes_per_round_cycle(ptree)
