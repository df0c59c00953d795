"""CPD-SGDM, CHOCO and MT-DSGDm's compressed tracking on the port's
sharded backend (``ShardedComm``) in eight gloo ranks on the CPU, held
against the reference's dense rounds on the same numpy inputs.

One module fixture spawns the ranks once and runs every family of
``FAMILIES`` (``tests/torch_sharded_ranks.py:codec_scenarios``; the ranks
import no JAX): three rounds of a least-squares model from one x0, each
rank its own batches.  Each test asserts on its slice:

* the params after the three rounds within 4.8e-7 of the reference's
  dense rounds (ROADMAP C.6's bar), and the bytes handed to ``isend``
  (counted by wrapping ``dist.batch_isend_irecv`` in each rank) equal to
  the reference's ``bytes_per_round_cycle`` per rank, or in the mean over
  the ranks under churn;
* rand-k's kept coordinates come from each package's own generator, so
  its family is held against the port's own dense rounds;
* a graph of more than one axis (the 2 × 4 torus) is refused: there the
  reference's stored-copy sum ``w₀·x̂ + Σ w·x̂_nbrs`` over the per-axis
  shifts is not ``W @ x̂`` (ROADMAP C.9);
* the replica contract: after every round, every rank's
  ``x̂_nbrs["ax{a}_sh{s:+d}"]`` has the bits of the x̂ of the rank it
  tracks, through the churn rounds too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import make_optimizer as r_make_optimizer  # noqa: E402
from repro.core import topology as r_top  # noqa: E402
from repro.core.compression import make_compressor as r_make_comp  # noqa: E402
from repro.core.cpdsgdm import CPDSGDM as RCPDSGDM  # noqa: E402
from repro.core.cpdsgdm import CPDSGDMConfig as RCPDSGDMConfig  # noqa: E402
from repro.core.gossip import DenseComm as RDense  # noqa: E402
from repro_torch.core import DenseComm, make_compressor, make_optimizer  # noqa: E402
from repro_torch.core import ring, torus  # noqa: E402
from repro_torch.core.gossip import ShardedComm  # noqa: E402
from repro_torch.launch.mesh import WorkerMesh  # noqa: E402
from repro_torch.launch.spawn import spawn_ranks  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402


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


K, P, ROUNDS = 8, 2, 3
WIDTH = 1100              # w (4, 1100): 5 kernel rows, the last partial
ROUND_BAR = 4.8e-7
MOVED_BAR = 8             # coded-state elements past the bar, per family
HYPER = dict(eta=0.05, mu=0.9, p=P, weight_decay=1e-4)
CPD = dict(HYPER, gamma=0.4)
SIGN = ("sign", {"block": 1024})
QSGD = ("qsgd", {"levels": 7, "block": 1024})
CHURN = ranks.CHURN

# label: (graph, optimizer, knobs); the compressor as (name, knobs)
FAMILIES = {
    "cpd_sign/ring/tree": ("ring", "cpd_sgdm", dict(CPD, compressor=SIGN)),
    "cpd_sign/ring/kernel": ("ring", "cpd_sgdm",
                             dict(CPD, compressor=SIGN, use_kernel=True)),
    "cpd_sign/exp/kernel": ("exp", "cpd_sgdm",
                            dict(CPD, compressor=SIGN, use_kernel=True)),
    "cpd_qsgd/ring/kernel": ("ring", "cpd_sgdm",
                             dict(CPD, compressor=QSGD, use_kernel=True)),
    "cpd_topk/ring/kernel": ("ring", "cpd_sgdm", dict(
        CPD, compressor=("topk", {"fraction": 0.1, "block": 1024}),
        use_kernel=True)),
    "cpd_sparse_sign/ring/kernel": ("ring", "cpd_sgdm", dict(
        CPD, compressor=("sparse+sign", {"max_rows": 2, "block": 1024}),
        use_kernel=True)),
    # a sign block other than the lane: the per-leaf wire at the boundary
    "cpd_sign64/ring/kernel": ("ring", "cpd_sgdm", dict(
        CPD, compressor=("sign", {"block": 64}), use_kernel=True)),
    "cpd_randk/ring/tree": ("ring", "cpd_sgdm", dict(
        CPD, compressor=("randk", {"fraction": 0.25}))),
    "cpd_unpacked/ring/tree": ("ring", "cpd_sgdm",
                               dict(CPD, compressor=SIGN, packed_wire=False)),
    "cpd_sign/churn/kernel": ("churn", "cpd_sgdm",
                              dict(CPD, compressor=SIGN, use_kernel=True)),
    "choco/ring/tree": ("ring", "choco_sgd", dict(
        eta=0.05, gamma=0.4, weight_decay=1e-4, compressor=SIGN)),
    "mt_sign/ring/kernel": ("ring", "mt_dsgdm",
                            dict(HYPER, compressor=SIGN, use_kernel=True)),
    "mt_sign/ring/tree": ("ring", "mt_dsgdm", dict(HYPER, compressor=SIGN)),
    "mt_qsgd/ring/kernel": ("ring", "mt_dsgdm",
                            dict(HYPER, compressor=QSGD, use_kernel=True)),
    "mt_qsgd/ring/tree": ("ring", "mt_dsgdm", dict(HYPER, compressor=QSGD)),
    "mt_sign/churn/tree": ("churn", "mt_dsgdm",
                           dict(HYPER, compressor=SIGN)),
}


def _inputs():
    rng = np.random.default_rng(1)
    f32 = np.float32
    w0 = rng.standard_normal((4, WIDTH)).astype(f32)
    return {
        "params": {"w": np.broadcast_to(w0, (K, 4, WIDTH)).copy(),
                   "b": np.zeros((K, WIDTH), f32)},
        "batches": {"x": rng.standard_normal((ROUNDS * P, K, 4, 4))
                    .astype(f32),
                    "y": rng.standard_normal((ROUNDS * P, K, 4, WIDTH))
                    .astype(f32)},
        "rounds": ROUNDS, "families": FAMILIES,
    }


@pytest.fixture(scope="module")
def run():
    inp = _inputs()
    res = spawn_ranks(ranks.codec_scenarios, K, (inp,), backend="gloo",
                      device="cpu")
    return inp, res


def _r_graph(kind):
    return {"ring": r_top.ring(K), "churn": r_top.ring(K),
            "exp": r_top.make_topology("exponential", (K,))}[kind]


def _r_opt(label, use_kernel=False):
    """The reference's optimizer of a family on the dense backend: its
    tree rounds (its codec kernels run in interpret mode either way), or
    with ``use_kernel`` for its byte model of the kernel layout."""
    kind, name, kw = FAMILIES[label]
    kw = dict(kw)
    spec = kw.pop("compressor")
    comp = r_make_comp(spec[0], **spec[1])
    comm = RDense(
        _r_graph(kind), membership=(
            r_top.membership_from_events(K, 3, CHURN) if kind == "churn"
            else None))
    if not kw.pop("packed_wire", True):
        kw.pop("use_kernel", None)
        return RCPDSGDM(RCPDSGDMConfig(packed_wire=False, **kw), comm, comp)
    kw["use_kernel"] = use_kernel and kw.get("use_kernel", False)
    return r_make_optimizer(name, comm, compressor=comp, **kw)


def _r_quad_grads(params, batch):
    def loss(p, b):
        r = b["x"] @ p["w"] + p["b"] - b["y"]
        return 0.5 * jnp.mean(r * r)
    losses, grads = jax.vmap(jax.value_and_grad(loss))(params, batch)
    return losses.mean(), grads


def _batches(inp, rnd, p):
    return {k: v[rnd * p:(rnd + 1) * p] for k, v in inp["batches"].items()}


def _stack_state(states):
    """Per-rank numpy states → the K-stacked state (the step as is)."""
    out = {}
    for k, v in states[0].items():
        if k == "xhat_nbrs":
            continue
        if isinstance(v, dict):
            out[k] = {n: np.concatenate([s[k][n] for s in states])
                      for n in v}
        else:
            out[k] = v
    return out


def _r_round(label, params, state, batches):
    """One reference dense round (rand-k: the port's own) from numpy
    ``params`` and ``state`` (None: the init of ``params``)."""
    if "randk" in label:
        kind, name, kw = FAMILIES[label]
        kw = dict(kw)
        spec = kw.pop("compressor")
        opt = make_optimizer(name, DenseComm(ring(K), device="cpu"),
                             compressor=make_compressor(spec[0], **spec[1]),
                             **kw)
        t = lambda tree: {k: (t(v) if isinstance(v, dict)
                              else torch.from_numpy(np.array(v)))
                          for k, v in tree.items()}
        tp = t(params)
        ts = opt.init(tp) if state is None else t(state)
        tp, ts, _ = opt.round(ts, tp, ranks._grads_fn(), t(batches))
        n = lambda tree: {k: (n(v) if isinstance(v, dict) else v.numpy())
                          for k, v in tree.items()}
        return n(tp), n(ts)
    opt = _r_opt(label)
    j = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    rp = j(params)
    rs = opt.init(rp) if state is None else j(state)
    rp, rs, _ = opt.round(rs, rp, _r_quad_grads, j(batches))
    n = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return n(rp), n(rs)


def _stacked(res, label, rnd=-1):
    """The K-stacked params and the per-rank states of round ``rnd``."""
    per_rank = [r[label]["rounds"][rnd] for r in res]
    params = {k: np.concatenate([p[k] for p, _ in per_rank])
              for k in per_rank[0][0]}
    return params, [s for _, s in per_rank]


def _one(tree):
    return {k: v[0] for k, v in tree.items()}


@pytest.mark.parametrize("label", list(FAMILIES))
def test_rounds_equal_dense(run, label):
    """Each of the three rounds, from the sharded state after the rounds
    before it, against the reference's dense round from that same state
    (rand-k: the port's own): params and m within the bar; the coded
    state (CPD's x̂, MT's c) within it but for the elements whose codec
    input lies within rounding of a decision edge (a sign near zero, a
    QSGD level boundary), each moved by at most twice the round's largest
    change of that state.  The isend bytes against the reference's
    cycle, exactly."""
    inp, res = run
    coded = "c" if FAMILIES[label][1] == "mt_dsgdm" else "xhat"
    p = _r_opt(label).config.p
    params, state = inp["params"], None
    moved = []
    for rnd in range(ROUNDS):
        want_p, want_s = _r_round(label, params, state,
                                  _batches(inp, rnd, p))
        got_p, states = _stacked(res, label, rnd)
        got_s = _stack_state(states)
        start = (state[coded] if state is not None else
                 {k: np.zeros_like(v) if coded == "c" else v
                  for k, v in inp["params"].items()})
        n_far = 0
        for k in got_p:
            np.testing.assert_allclose(got_p[k], want_p[k], rtol=0,
                                       atol=ROUND_BAR,
                                       err_msg=f"{label} round {rnd} {k}")
            np.testing.assert_allclose(got_s["m"][k], want_s["m"][k],
                                       rtol=0, atol=ROUND_BAR,
                                       err_msg=f"{label} round {rnd} m {k}")
            got_c, want_c = got_s[coded][k], np.asarray(want_s[coded][k])
            change = np.abs(want_c - start[k]).max()
            gap = np.abs(got_c - want_c)
            far = gap > ROUND_BAR
            assert (gap[far] <= 2 * change).all(), (label, rnd, k)
            n_far += int(far.sum())
        moved.append(n_far)
        params, state = got_p, got_s
    assert sum(moved) <= MOVED_BAR, (label, moved)
    cycle = _r_opt(label, use_kernel=True).bytes_per_round_cycle(
        _one(inp["params"]))
    want_b = sum(cycle[r % len(cycle)] for r in range(ROUNDS))
    sent = [r[label]["bytes"] for r in res]
    if "churn" in label:
        assert np.mean(sent) == pytest.approx(want_b, rel=0, abs=1e-9)
    else:
        assert sent == [want_b] * K


def _tracked(label, kind, states, key):
    """Per rank, the x̂ of the rank that ``key``'s copies track."""
    assert key.startswith("ax0_sh"), key
    sh = int(key[len("ax0_sh"):])
    return [states[(k + sh) % K]["xhat"] for k in range(K)]


@pytest.mark.parametrize("label", [lb for lb in FAMILIES
                                   if FAMILIES[lb][1] != "mt_dsgdm"])
def test_replica_contract(run, label):
    """After every round (the churn rounds with their skipped commits
    too) every copy has the bits of the x̂ it tracks."""
    _, res = run
    kind = FAMILIES[label][0]
    for rnd in range(ROUNDS):
        _, states = _stacked(res, label, rnd)
        keys = sorted(states[0]["xhat_nbrs"])
        assert len(keys) == _r_graph(kind).degree
        for key in keys:
            owners = _tracked(label, kind, states, key)
            for rank in range(K):
                for leaf, v in states[rank]["xhat_nbrs"][key].items():
                    np.testing.assert_array_equal(
                        v, owners[rank][leaf],
                        err_msg=f"{label} round {rnd} rank {rank} {key}")


# label: (optimizer, knobs) of what a sharded graph of two axes refuses
TORUS_REFUSED = {
    "cpd_sign/tree": ("cpd_sgdm", dict(CPD, compressor=SIGN)),
    "cpd_sign/kernel": ("cpd_sgdm",
                        dict(CPD, compressor=SIGN, use_kernel=True)),
    "choco": ("choco_sgd", dict(eta=0.05, gamma=0.4, compressor=SIGN)),
    "mt_sign/tree": ("mt_dsgdm", dict(HYPER, compressor=SIGN)),
    "mt_qsgd/kernel": ("mt_dsgdm",
                       dict(HYPER, compressor=QSGD, use_kernel=True)),
}


@pytest.mark.parametrize("label", list(TORUS_REFUSED))
def test_multi_axis_graph_refused(label):
    """On the 2 × 4 torus of a two-axis worker mesh (what the launcher
    builds for one) CPD-SGDM, CHOCO and MT with a codec refuse to build:
    their sum over the per-axis shifts' copies or payloads weighs the
    number of axes and misses W's diagonal neighbours (ROADMAP C.9).
    PD-SGDM and MT with a full-precision c mix through ``W`` and build."""
    comm = ShardedComm(torus((2, 4)), axis_names=("a", "b"), mesh=WorkerMesh(
        ("a", "b"), (2, 4), 0, torch.device("cpu"), "gloo",
        {"a": None, "b": None}))
    name, kw = TORUS_REFUSED[label]
    kw = dict(kw)
    spec = kw.pop("compressor")
    with pytest.raises(ValueError, match=r"one-axis shift graph.*C\.9"):
        make_optimizer(name, comm,
                       compressor=make_compressor(spec[0], **spec[1]), **kw)
    assert make_optimizer(name.replace("cpd_sgdm", "pd_sgdm").replace(
        "choco_sgd", "pd_sgdm"), comm, **HYPER).sharded
