"""Hierarchical two-level gossip and the bf16 wire in the port against the
reference, on the dense backend: the topologies and their schedule, the
factored round (exact in-node mean, inter-node factor, the bf16 point on
the slow wire), the bf16 wire of a flat graph on both layouts, the bytes
of every level, MT's doubling and C-SGDM's rejection; the claims of the
committed ``BENCH_pretrain.json``; and the kernel launches and bytes per
round of ``chip_smoke.py``'s six overlap, bf16 and hierarchical paths.

Matrices are numpy on both sides, built by the same float64 arithmetic, so
every W and inter factor is held bit for bit, as are the bytes.  A mix
sums in the order of its BLAS or reduction on each side, so mixes and
rounds are held to a few ulps (rtol 1e-6 / atol 1e-7 for one mix; atol
2e-6 after 3 rounds); the bf16 payload itself (the round trip of the f32
values, to nearest even on both sides) is held bit for bit.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import make_optimizer as r_make_optimizer  # noqa: E402
from repro.core.gossip import DenseComm as RDenseComm  # noqa: E402
from repro.core.gossip import hier_bytes_per_round as r_hier_bytes  # noqa: E402
from repro.core import topology as r_top  # noqa: E402
from repro.kernels import ops as r_kops  # noqa: E402
from repro.kernels import ref as r_kref  # noqa: E402
from repro_torch.core import DenseComm, make_optimizer  # noqa: E402
from repro_torch.core import topology as top  # noqa: E402
from repro_torch.core.gossip import (bf16_round_trip,  # noqa: E402
                                     hier_bytes_per_round)
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.gossip_mix import launch_count  # noqa: E402
from repro_torch.kernels.ops import KernelPlan  # noqa: E402
from repro_torch.kernels.ref import gossip_shift_ref  # noqa: E402


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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRIDS = [(2, 4, "ring"), (4, 2, "ring"), (8, 2, "exponential"),
         (3, 2, "complete"), (1, 4, "ring"), (4, 1, "ring")]
ETA, MU, P = 0.05, 0.9, 4


def _same_topology(ours, ref):
    assert ours.name == ref.name
    np.testing.assert_array_equal(ours.W, ref.W)
    assert ours.shifts == ref.shifts and ours.perms == ref.perms
    assert ours.axis_sizes == ref.axis_sizes
    assert ours.symmetric == ref.symmetric


# ---------------------------------------------------------------- topology
@pytest.mark.parametrize("n,m,inter", GRIDS)
def test_hierarchical_matches_reference(n, m, inter):
    ours = top.hierarchical(n, m, inter=inter)
    _same_topology(ours, r_top.hierarchical(n, m, inter=inter))
    ours.validate()
    np.testing.assert_array_equal(
        ours.W, np.kron(top.make_topology(inter, (n,)).W,
                        np.full((m, m), 1.0 / m)))
    assert top.hierarchical_inter_shifts(ours) == \
        r_top.hierarchical_inter_shifts(r_top.hierarchical(n, m, inter=inter))
    assert top.hierarchical_self_weight(ours) == \
        r_top.hierarchical_self_weight(r_top.hierarchical(n, m, inter=inter))
    np.testing.assert_array_equal(ours.structure_matrix() != 0, ours.W != 0)
    if inter == "ring":
        _same_topology(top.make_topology("hierarchical", (n, m)),
                       r_top.make_topology("hierarchical", (n, m)))


@pytest.mark.parametrize("grid", [(2, 4), (4, 2), (8, 2), (1, 4)])
def test_hier_one_peer_schedule_matches_reference(grid):
    ours = top.make_schedule("hier_one_peer", grid)
    ref = r_top.make_schedule("hier_one_peer", grid)
    assert ours.name == ref.name and ours.period == ref.period
    for a, b in zip(ours.topologies, ref.topologies):
        _same_topology(a, b)
    ours.validate()
    np.testing.assert_array_equal(ours.cycle_product(), ref.cycle_product())
    if grid[0] in (2, 4, 8):          # a power of two: the exact average
        K = grid[0] * grid[1]
        np.testing.assert_allclose(ours.cycle_product(),
                                   np.full((K, K), 1.0 / K), atol=1e-12)
    _same_topology(top.hierarchical_schedule(*grid).at(0),
                   r_top.hierarchical_schedule(*grid).at(0))


def test_constructor_validation_as_the_reference():
    for ours, ref in (
            (lambda: top.hierarchical(0, 4), lambda: r_top.hierarchical(0, 4)),
            (lambda: top.make_topology("hierarchical", (8,)),
             lambda: r_top.make_topology("hierarchical", (8,))),
            (lambda: top.make_schedule("hier_one_peer", (8,)),
             lambda: r_top.make_schedule("hier_one_peer", (8,)))):
        with pytest.raises(ValueError) as a:
            ours()
        with pytest.raises(ValueError) as b:
            ref()
        assert str(a.value) == str(b.value)


# ---------------------------------------------------------- dense rounds
def _x(K, d=7, seed=0):
    return np.random.default_rng(seed).standard_normal((K, d)).astype(
        np.float32)


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("graph", ["hier2x4", "hier4x2", "hier_sched",
                                   "ring8", "torus2x4"])
def test_dense_mix_matches_reference(graph, wire):
    """``DenseComm.mix`` of a hierarchical graph (its factored round, the
    stacked inter factors bit for bit) or of a flat one, on either wire,
    every round of a schedule."""
    build = {"hier2x4": lambda t: t.hierarchical(2, 4),
             "hier4x2": lambda t: t.hierarchical(4, 2),
             "hier_sched": lambda t: t.make_schedule("hier_one_peer", (4, 2)),
             "ring8": lambda t: t.ring(8),
             "torus2x4": lambda t: t.torus((2, 4))}[graph]
    ours = DenseComm(build(top), wire_dtype=wire, device="cpu")
    ref = RDenseComm(build(r_top), wire_dtype=wire)
    if graph.startswith("hier"):
        np.testing.assert_array_equal(ours._hier_R.numpy(),
                                      np.asarray(ref._hier_R))
        assert ours._hier_m == ref._hier_m
    else:
        assert ours._hier_R is None and ref._hier_R is None
    x = _x(8, seed=3)
    for r in range(ours.period):
        got = ours.mix({"a": torch.from_numpy(x)}, r=r)["a"].numpy()
        want = np.asarray(ref.mix({"a": jnp.asarray(x)}, r=r)["a"])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            got, ours.topology_at(r).W @ x.astype(np.float64),
            atol=(2e-2 if wire == "bfloat16" else 1e-5))
        # a 0-d device round index selects the same round
        np.testing.assert_array_equal(
            ours.mix({"a": torch.from_numpy(x)},
                     r=torch.tensor(r, dtype=torch.int32))["a"].numpy(), got)


def test_dense_hier_bf16_wire_matches_oracle():
    """bf16 sits on the inter wire only: node means exact in f32, the self
    term at full precision, the shipped neighbour means rounded."""
    t = top.hierarchical(2, 4)
    x = _x(8, seed=3)
    got = DenseComm(t, wire_dtype="bfloat16", device="cpu").mix(
        {"a": torch.from_numpy(x)})["a"].numpy()
    R = np.asarray(top.ring(2).W, np.float32)
    xa = x.reshape(2, 4, -1).mean(axis=1)
    wire = np.asarray(jnp.asarray(xa).astype(jnp.bfloat16).astype(
        jnp.float32))
    mixed = np.diag(R)[:, None] * xa + (R - np.diag(np.diag(R))) @ wire
    oracle = np.broadcast_to(mixed[:, None, :], (2, 4, x.shape[1]))
    np.testing.assert_allclose(got, oracle.reshape(8, -1), atol=1e-6)
    exact = DenseComm(t, device="cpu").mix({"a": torch.from_numpy(x)})
    err = np.abs(got - exact["a"].numpy()).max()
    assert 0 < err < 2e-2


def test_bf16_round_trip_matches_xla_bit_for_bit():
    """The wire payload: round to nearest even, as XLA's convert does
    (ties, subnormals, ±0.0, ±inf)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal(4096).astype(np.float32) * 3.0
    x[:8] = [0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40, 1.00390625,
             1.01171875]                         # two ties of bf16's ulp
    got = bf16_round_trip(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_dense_hier_all_active_membership_takes_the_masked_w():
    """Under membership a hierarchical graph mixes with the (masked) W, not
    the factored round, as in the reference; all active, the plain W."""
    t, rt = top.hierarchical(2, 2), r_top.hierarchical(2, 2)
    ms = top.full_membership(4)
    rms = r_top.full_membership(4)
    comm = DenseComm(t, membership=ms, device="cpu")
    assert comm._hier_R is None
    x = _x(4, seed=5)
    got = comm.stale_mix({"a": torch.from_numpy(x)}, r=0)["a"].numpy()
    want = np.asarray(RDenseComm(rt, membership=rms).stale_mix(
        {"a": jnp.asarray(x)}, r=0)["a"])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    plain = DenseComm(t, device="cpu").mix({"a": torch.from_numpy(x)})
    np.testing.assert_allclose(got, plain["a"].numpy(), atol=1e-6)


# ------------------------------------------------------- optimizer rounds
def _np_params(K, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((K, 5)).astype(np.float32),
            "b": np.ones((K, 2), np.float32)}


def _grads(params, batch):
    g = {k: 0.1 * v + batch["b"] for k, v in params.items()}
    return sum(v.sum() for v in g.values()), g


def _ref_grads(params, batch):
    g = jax.tree_util.tree_map(lambda x: 0.1 * x + batch, params)
    return sum(jnp.sum(v) for v in jax.tree_util.tree_leaves(g)), g


def _rounds(opt, params, rounds, ref=False):
    b = np.arange(P, dtype=np.float32) * 0.01
    if ref:
        params = {k: jnp.asarray(v) for k, v in params.items()}
        state = opt.init(params)
        for _ in range(rounds):
            params, state, _ = opt.round(state, params, _ref_grads,
                                         jnp.asarray(b))
        return {k: np.asarray(v) for k, v in params.items()}, state
    params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(params)
    for _ in range(rounds):
        params, state, _ = opt.round(state, params, _grads,
                                     {"b": torch.from_numpy(b)})
    return {k: v.numpy() for k, v in params.items()}, state


@pytest.mark.parametrize("name", ["pd_sgdm", "mt_dsgdm", "qg_dsgdm"])
@pytest.mark.parametrize("graph,wire", [
    ("hier", "float32"), ("hier", "bfloat16"), ("hier_sched", "float32"),
    ("ring", "bfloat16")])
def test_rounds_match_reference(name, graph, wire):
    """Three rounds (and MT's and QG's with overlap) on both layouts against
    the reference's tree round."""
    build = {"hier": lambda t: t.hierarchical(2, 4),
             "hier_sched": lambda t: t.make_schedule("hier_one_peer", (2, 4)),
             "ring": lambda t: t.ring(8)}[graph]
    overlap = name != "pd_sgdm"
    ref = r_make_optimizer(name, RDenseComm(build(r_top), wire_dtype=wire),
                           eta=ETA, mu=MU, p=P, overlap=overlap)
    want, _ = _rounds(ref, _np_params(8), 3, ref=True)
    for use_kernel in (False, True):
        ours = make_optimizer(name, DenseComm(build(top), wire_dtype=wire,
                                              device="cpu"),
                              eta=ETA, mu=MU, p=P, overlap=overlap,
                              use_kernel=use_kernel)
        got, _ = _rounds(ours, _np_params(8), 3)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=2e-6, rtol=0)


@pytest.mark.parametrize("graph", ["ring", "torus"])
def test_bf16_gossip_mat_matches_reference(graph, monkeypatch):
    """The kernel-layout bf16 step: per axis the self view from the f32
    matrix and the neighbour views from the payload's bf16 round trip, cut
    to the wire extent.  Bit for bit against the reference's
    ``_gossip_mat`` with the plain left-to-right sum in place of its
    Pallas kernel (its u16 bitcast pins XLA's placement of the cast, and
    changes no value)."""
    t, rt = {"ring": (top.ring(8), r_top.ring(8)),
             "torus": (top.torus((2, 4)), r_top.torus((2, 4)))}[graph]
    rng = np.random.default_rng(11)
    tree = {"w": rng.standard_normal((8, 40_000), dtype=np.float32),
            "b": rng.standard_normal((8, 7), dtype=np.float32)}
    plan = KernelPlan.for_tree({n: torch.from_numpy(v)
                                for n, v in tree.items()},
                               worker_dim=True, block_rows=64)
    rplan = r_kops.KernelPlan.for_tree(tree, worker_dim=True, block_rows=64)
    x = rng.standard_normal((8, plan.rows, 1024), dtype=np.float32)
    opt = make_optimizer("pd_sgdm", DenseComm(t, wire_dtype="bfloat16",
                                              device="cpu"), use_kernel=True)
    y = opt._gossip_mat(torch.from_numpy(x), 0, plan=plan).numpy()
    ropt = r_make_optimizer("pd_sgdm", RDenseComm(rt, wire_dtype="bfloat16"),
                            use_kernel=True, kernel_interpret=True)

    def plain_mix(mats, weights, interpret=False):
        rows = [m.reshape(-1, 1024) for m in mats]
        return r_kref.gossip_mix_ref(rows, weights).reshape(mats[0].shape)

    monkeypatch.setattr(r_kops, "gossip_mix_mat", plain_mix)
    yr = np.asarray(ropt._gossip_mat(jnp.asarray(x), 0, plan=rplan))
    np.testing.assert_array_equal(y.view(np.int32), yr.view(np.int32))
    f32 = make_optimizer("pd_sgdm", DenseComm(t, device="cpu"),
                         use_kernel=True)._gossip_mat(torch.from_numpy(x), 0,
                                                      plan=plan).numpy()
    assert 0 < np.abs(y - f32).max() < 2e-2


def test_shifted_mix_reads_neighbours_from_nbr():
    """``gossip_mix_shifted(..., nbr=)`` on the CPU (its plain version):
    the self view from x, every shifted view from nbr, rows from lim on
    zero — the sum written out with numpy's roll."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 6, 1024)).astype(np.float32)
    nbr = rng.standard_normal((8, 6, 1024)).astype(np.float32)
    ws = (1 / 3, 1 / 3, 1 / 3)
    got = kops.gossip_mix_shifted(torch.from_numpy(x), grid=(2, 4), axis=1,
                                  shifts=(0, 1, -1), weights=ws, lim=4,
                                  nbr=torch.from_numpy(nbr)).numpy()
    cut = nbr.copy()
    cut[:, 4:] = 0.0
    g = cut.reshape(2, 4, 6, 1024)
    views = [x] + [np.roll(g, -sh, axis=1).reshape(8, 6, 1024)
                   for sh in (1, -1)]
    w32 = [np.float32(w) for w in ws]
    want = w32[0] * views[0] + w32[1] * views[1] + w32[2] * views[2]
    np.testing.assert_array_equal(got, want)
    same = gossip_shift_ref(torch.from_numpy(x), (0, 1, -1), ws, grid=(2, 4),
                            axis=1, lim=4)
    np.testing.assert_array_equal(
        kops.gossip_mix_shifted(torch.from_numpy(x), grid=(2, 4), axis=1,
                                shifts=(0, 1, -1), weights=ws, lim=4,
                                nbr=torch.from_numpy(x)).numpy(),
        same.numpy())
    with pytest.raises(ValueError, match="nbr"):
        kops.gossip_mix_shifted(torch.from_numpy(x), grid=(2, 4), axis=1,
                                shifts=(0, 1), weights=(0.5, 0.5),
                                nbr=torch.from_numpy(nbr[:, :5].copy()))


# ---------------------------------------------------------- byte accounting
def _tree(sizes=(1024, 160)):
    return ({f"l{i}": torch.empty(n) for i, n in enumerate(sizes)},
            [jax.ShapeDtypeStruct((n,), jnp.float32) for n in sizes])


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("grid", [(2, 4), (4, 2), (8, 1), (1, 8)])
def test_hier_bytes_per_level_match_reference(grid, wire):
    ours_tree, ref_tree = _tree()
    got = hier_bytes_per_round(ours_tree, DenseComm(
        top.hierarchical(*grid), wire_dtype=wire, device="cpu"))
    want = r_hier_bytes(ref_tree, RDenseComm(r_top.hierarchical(*grid),
                                             wire_dtype=wire))
    assert got == want
    with pytest.raises(ValueError, match="not a hierarchical"):
        hier_bytes_per_round(ours_tree, DenseComm(top.ring(8),
                                                  device="cpu"))


def test_bf16_halves_the_inter_level_only():
    ours_tree, _ = _tree()
    f32 = hier_bytes_per_round(ours_tree, DenseComm(top.hierarchical(2, 4),
                                                    device="cpu"))
    bf16 = hier_bytes_per_round(ours_tree, DenseComm(
        top.hierarchical(2, 4), wire_dtype="bfloat16", device="cpu"))
    assert bf16["inter"] == f32["inter"] / 2
    assert bf16["intra_wire"] == f32["intra_wire"]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_optimizer_bytes_and_mt_doubling_match_reference(use_kernel):
    ours_tree, ref_tree = _tree((5000, 333, 7))
    for graph in (lambda t: t.hierarchical(2, 4),
                  lambda t: t.make_schedule("hier_one_peer", (4, 2))):
        for wire in ("float32", "bfloat16"):
            comm = DenseComm(graph(top), wire_dtype=wire, device="cpu")
            rcomm = RDenseComm(graph(r_top), wire_dtype=wire)
            pd = make_optimizer("pd_sgdm", comm, use_kernel=use_kernel)
            mt = make_optimizer("mt_dsgdm", comm, use_kernel=use_kernel)
            lv = pd.hier_bytes_per_level(ours_tree)
            assert lv == r_make_optimizer(
                "pd_sgdm", rcomm).hier_bytes_per_level(ref_tree)
            assert mt.hier_bytes_per_level(ours_tree) == \
                {k: 2 * v for k, v in lv.items()}
            for name, opt in (("pd_sgdm", pd), ("mt_dsgdm", mt)):
                assert opt.bytes_per_round_cycle(ours_tree) == \
                    r_make_optimizer(name, rcomm, use_kernel=use_kernel
                                     ).bytes_per_round_cycle(ref_tree)
            assert mt.bytes_per_comm_round(ours_tree) == 2 * lv["inter"]


def test_flat_ring_vs_hier_bf16_is_16x():
    ours_tree, _ = _tree()
    flat = make_optimizer("pd_sgdm", DenseComm(top.ring(8), device="cpu"))
    hier = make_optimizer("pd_sgdm", DenseComm(
        top.hierarchical(2, 4), wire_dtype="bfloat16", device="cpu"))
    assert flat.bytes_per_comm_round(ours_tree) \
        / hier.bytes_per_comm_round(ours_tree) == 16.0


def test_bf16_flat_wire_bytes_match_reference():
    """A flat graph on the bf16 wire ships 2 bytes an element, on the tree
    and on the kernel wire's used rows."""
    ours_tree, ref_tree = _tree((5000, 333, 7))
    for use_kernel in (False, True):
        ours = make_optimizer("pd_sgdm", DenseComm(
            top.ring(8), wire_dtype="bfloat16", device="cpu"),
            use_kernel=use_kernel)
        ref = r_make_optimizer("pd_sgdm", RDenseComm(
            r_top.ring(8), wire_dtype="bfloat16"), use_kernel=use_kernel)
        assert ours.bytes_per_round_cycle(ours_tree) == \
            ref.bytes_per_round_cycle(ref_tree)


def test_c_sgdm_rejects_hierarchical_as_the_reference():
    with pytest.raises(ValueError, match="centralized baseline") as ours:
        make_optimizer("c_sgdm", DenseComm(top.hierarchical(2, 4),
                                           device="cpu"))
    with pytest.raises(ValueError, match="centralized baseline"):
        r_make_optimizer("c_sgdm", RDenseComm(r_top.hierarchical(2, 4)))
    assert "hierarchical gossip does not apply" in str(ours.value)


def test_pretrain_comm_claims_from_the_committed_bench():
    """``benchmarks/pretrain_sweep.py``'s byte rows, priced as it prices
    them: one flat f32 leaf of the file's ``params`` count (on the meta
    device: accounting reads shapes only), PD-SGDM on ring(8) against
    ``hierarchical(2, 4)`` on the f32 and bf16 wires."""
    with open(os.path.join(ROOT, "benchmarks", "BENCH_pretrain.json")) as f:
        rows = {r["name"]: r["derived"] for r in json.load(f)["rows"]}
    n = int(rows["pretrain/comm_flat_ring"]["params"])
    assert n == 154_140_672
    params = {"w": torch.empty((n,), dtype=torch.float32, device="meta")}
    flat = make_optimizer("pd_sgdm", DenseComm(top.ring(8), device="cpu"),
                          p=4).bytes_per_comm_round(params)
    assert flat / 2 ** 20 == rows["pretrain/comm_flat_ring"]["mb_per_round"]
    inter = {}
    for wire, tag in (("float32", "f32"), ("bfloat16", "bf16")):
        opt = make_optimizer("pd_sgdm", DenseComm(
            top.hierarchical(2, 4), wire_dtype=wire, device="cpu"), p=4)
        lv = opt.hier_bytes_per_level(params)
        row = rows[f"pretrain/comm_hier_{tag}"]
        assert round(lv["inter"] / 2 ** 20, 4) == row["inter_mb"]
        assert round(lv["intra_wire"] / 2 ** 20, 4) == row["intra_mb"]
        inter[tag] = lv["inter"]
    assert (rows["pretrain/comm_hier_f32"]["inter_mb"],
            rows["pretrain/comm_hier_bf16"]["inter_mb"],
            rows["pretrain/comm_hier_f32"]["intra_mb"]) == (147.0, 73.5,
                                                            1764.0)
    claim = rows["pretrain/claim_inter_reduction"]
    assert flat / inter["f32"] == claim["inter_reduction_f32"] == 8.0
    assert flat / inter["bf16"] == claim["inter_reduction_bf16"] == 16.0
    assert claim["reduction_ok"] == 1.0


# --------------------------------------- chip_smoke.py's six new paths
STEPS, K = 14, 8
CHURN = [(0, "kill", 3), (1, "straggle", 6), (2, "revive", 3)]
# path: (optimizer, comm kwargs, overlap, momentum launches, gossip_mix
# launches, bytes per round over the cycle at ResNet-20 width 16)
PATHS = {
    "pd_sgdm_overlap": ("pd_sgdm", "ring", {}, True, 14, 7, (2_539_520,)),
    "mt_dsgdm_overlap": ("mt_dsgdm", "ring", {}, True, 14, 53,
                         (5_079_040,)),
    "qg_dsgdm_overlap": ("qg_dsgdm", "ring", {}, True, 14, 7, (2_539_520,)),
    "pd_sgdm_bf16": ("pd_sgdm", "ring", {"wire_dtype": "bfloat16"}, False,
                     14, 3, (1_269_760,)),
    "pd_sgdm_hier": ("pd_sgdm", "hier", {}, False, 14, 0, (272_282,)),
    "pd_sgdm_overlap_churn": ("pd_sgdm", "ring", {"churn": True}, True, 14,
                              3, (1_633_692, 1_089_128, 2_178_256)),
}


def _loss(params, batch):
    loss = sum(0.5 * ((v - batch["t"]) ** 2).sum() for v in params.values())
    return loss, {}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_chip_paths_launch_counts_and_bytes(path, monkeypatch):
    """The kernel launches a 14-step run (3 rounds and a 2-step tail) of
    each new ``chip_smoke.py`` path makes on the card, counted on the CPU by
    the calls of the kernel wrappers (each call of a mix of n inputs is
    ``launch_count(n)`` launches), and its bytes per round at ResNet-20
    width 16, equal to the reference's."""
    from repro.models import resnet as r_resnet
    from repro_torch.convert import params_from_reference
    from repro_torch.train.trainer import SimTrainer
    name, graph, ckw, overlap, want_m, want_g, want_bytes = PATHS[path]
    counts = {"momentum_update": 0, "gossip_mix": 0}

    def counted(fn, key, n_of):
        def wrapper(*args, **kwargs):
            counts[key] += n_of(args, kwargs)
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(kops, "momentum_update", counted(
        kops.momentum_update, "momentum_update", lambda a, k: 1))
    monkeypatch.setattr(kops, "gossip_mix", counted(
        kops.gossip_mix, "gossip_mix", lambda a, k: launch_count(len(a[0]))))
    monkeypatch.setattr(kops, "gossip_mix_shifted", counted(
        kops.gossip_mix_shifted, "gossip_mix",
        lambda a, k: launch_count(len(k["shifts"]))))
    ckw = dict(ckw)
    membership = (top.membership_from_events(K, 3, CHURN)
                  if ckw.pop("churn", False) else None)
    t = top.ring(K) if graph == "ring" else top.hierarchical(2, 4)
    opt = make_optimizer(name, DenseComm(t, membership=membership,
                                         device="cpu", **ckw),
                         eta=0.05, mu=0.9, p=P, weight_decay=1e-4,
                         use_kernel=True, overlap=overlap)
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.standard_normal((K, 40)).astype(
        np.float32)), "b": torch.zeros((K, 3))}
    _, state, hist = SimTrainer(_loss, opt, device="cpu").train(
        params, lambda s: {"t": torch.full((K,), 0.01 * s)}, STEPS,
        log_every=1)
    assert counts == {"momentum_update": want_m, "gossip_mix": want_g}
    assert int(state["step"]) == STEPS and len(hist.loss) == STEPS
    assert all(np.isfinite(hist.loss))
    rp = r_resnet.resnet20_init(jax.random.PRNGKey(0), width=16)
    rcomm_top = r_top.ring(K) if graph == "ring" else r_top.hierarchical(2, 4)
    rms = (r_top.membership_from_events(K, 3, CHURN) if membership is not None
           else None)
    ref = r_make_optimizer(name, RDenseComm(rcomm_top, membership=rms, **ckw),
                           use_kernel=True, overlap=overlap)
    got = opt.bytes_per_round_cycle(params_from_reference(
        jax.tree_util.tree_map(np.asarray, rp), "cpu"))
    assert got == ref.bytes_per_round_cycle(rp) == want_bytes
