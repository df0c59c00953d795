"""The port's sparse-rows wire against the reference's: the row gather and
scatter wrappers, the touched-row selection, the sparse codec with its
inner f32, sign and QSGD codecs, CPD-SGDM on the sparse wire, and the Zipf
embedding stream.

On the CPU each kernel wrapper runs its plain PyTorch version; it is held
against the Pallas kernels in interpret mode and against the JAX oracles
``repro.kernels.ref.row_gather_ref``/``row_scatter_ref``.  Bars:

* gather, scatter, selection, payloads and bytes: exact (the kernels only
  move rows; the selection sums its row norms in one fixed tree on both
  sides and breaks ties by the lowest row on both);
* decodes: exact, but for the QSGD inner codec, whose last multiply XLA
  may contract into the scatter's add (1 ulp; tests/test_kernels.py:394);
* CPD-SGDM rounds against the reference: params and x̂ within the bars of
  tests/test_torch_cpdsgdm.py (rtol 1e-3 / atol 1e-4), measured at most
  4.8e-7 apart; kernel path against the port's own tree path within rtol 1e-6 /
  atol 1e-7 (they differ only in the consensus product's shape); the
  per-leaf codec wire against the kernel wire bit for bit.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compression as r_comp  # noqa: E402
from repro.core import wire as r_wire  # noqa: E402
from repro.core.cpdsgdm import CPDSGDM as RCPDSGDM  # noqa: E402
from repro.core.cpdsgdm import CPDSGDMConfig as RCPDSGDMConfig  # noqa: E402
from repro.core.gossip import DenseComm as RDenseComm  # noqa: E402
from repro.core.topology import ring as r_ring  # noqa: E402
from repro.data import synthetic as r_syn  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402
from repro.kernels.ops import KernelPlan as RPlan  # noqa: E402
from repro.kernels.row_gather import (row_gather_pallas,  # noqa: E402
                                      row_scatter_pallas)
from repro_torch.core import (CPDSGDM, CPDSGDMConfig, DenseComm,  # noqa: E402
                              SparseRowsCompressor, make_compressor, ring)
from repro_torch.core import wire  # noqa: E402
from repro_torch.data.synthetic import (EmbedStreamCfg,  # noqa: E402
                                        embed_batch, touched_row_mask)
from repro_torch.kernels import LANE, ops  # noqa: E402
from repro_torch.kernels import row_gather as rg  # noqa: E402


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


K, P = 4, 4
INNERS = ["f32", "sign", "qsgd"]


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _ulps(a, b) -> int:
    ia, ib = (_bits(v).astype(np.int64) for v in (a, b))
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


def _rows(rows, seed):
    rng = np.random.default_rng(seed)
    x = (1.7 * rng.standard_normal((rows, LANE))).astype(np.float32)
    x[1, ::4] = -0.0
    return x


def test_row_gather_and_scatter_match_reference():
    """Counts-aware gather and the scatter against the oracles and the
    Pallas kernels, bit for bit: masked lanes +0.0, kept −0.0 kept, a
    −0.0 payload value lands as +0.0."""
    rows = 8
    x = _rows(rows, 0)
    idx = np.array([1, 4, 7], np.int32)
    counts = np.array([LANE, 13, LANE, LANE, 500, LANE, LANE, 1], np.float32)
    before = (rg.row_gather.launches, rg.row_scatter.launches)
    for c in (counts, None):
        got = ops.row_gather(torch.from_numpy(x), torch.from_numpy(idx),
                             None if c is None else torch.from_numpy(c))
        want = r_ref.row_gather_ref(jnp.asarray(x), jnp.asarray(idx),
                                    None if c is None else jnp.asarray(c))
        kern = row_gather_pallas(jnp.asarray(x), jnp.asarray(idx),
                                 None if c is None else jnp.asarray(c),
                                 interpret=True)
        assert got.shape == (3, LANE)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(got), _bits(kern))
    assert np.signbit(got.numpy()[0, ::4]).all()       # −0.0 moved as is
    vals = got.clone()
    vals[:, ::3] = -0.0
    out = ops.row_scatter(torch.from_numpy(idx), vals, rows=rows)
    want = r_ref.row_scatter_ref(jnp.asarray(idx), jnp.asarray(vals.numpy()),
                                 rows=rows)
    kern = row_scatter_pallas(jnp.asarray(idx), jnp.asarray(vals.numpy()),
                              rows=rows, interpret=True)
    assert out.shape == (rows, LANE)
    np.testing.assert_array_equal(_bits(out), _bits(want))
    np.testing.assert_array_equal(_bits(out), _bits(kern))
    zeros = out.numpy()[out.numpy() == 0]
    assert zeros.size and not np.signbit(zeros).any()
    assert (rg.row_gather.launches, rg.row_scatter.launches) == before


def test_row_wrappers_take_the_worker_dim_in_one_call():
    """(K, rows, LANE) with (K, S) indices and counts per worker or tiled:
    each worker's rows equal the reference's per-worker launch."""
    k, rows, s = 3, 6, 2
    x = np.stack([_rows(rows, 10 + i) for i in range(k)])
    rng = np.random.default_rng(3)
    idx = np.stack([np.sort(rng.choice(rows, s, replace=False))
                    for _ in range(k)]).astype(np.int32)
    counts = np.full((rows,), LANE, np.float32)
    counts[idx[0, 0]] = 37.0
    tx, ti = torch.from_numpy(x), torch.from_numpy(idx)
    g = ops.row_gather(tx, ti, torch.from_numpy(counts))
    g2 = ops.row_gather(tx, ti, torch.from_numpy(np.tile(counts, k)))
    assert g.shape == (k, s, LANE) and torch.equal(g, g2)
    sc = ops.row_scatter(ti, g, rows=rows)
    assert sc.shape == (k, rows, LANE)
    for i in range(k):
        np.testing.assert_array_equal(_bits(g[i]), _bits(row_gather_pallas(
            jnp.asarray(x[i]), jnp.asarray(idx[i]), jnp.asarray(counts),
            interpret=True)))
        np.testing.assert_array_equal(_bits(sc[i]), _bits(
            r_ref.row_scatter_ref(jnp.asarray(idx[i]),
                                  jnp.asarray(g[i].numpy()), rows=rows)))


def test_row_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((2, 6, LANE))
    idx = torch.tensor([[0, 2], [1, 5]], dtype=torch.int32)
    with pytest.raises(TypeError):
        rg.row_gather(x, idx.long())
    with pytest.raises(ValueError):
        rg.row_gather(x, idx, torch.full((6, 1), float(LANE)))   # untiled
    with pytest.raises(ValueError):
        rg.row_gather(x[0], idx)
    g = rg.row_gather(x, idx)
    with pytest.raises(ValueError):
        rg.row_scatter(torch.tensor([[2, 0], [1, 5]], dtype=torch.int32), g,
                       rows=6)                     # unsorted: plain checks
    with pytest.raises(ValueError):
        rg.row_scatter(idx, g, rows=0)


# NaN with a payload, +inf, −inf, −0.0 and the subnormal 5·2⁻¹⁴⁹, as bits
_SPECIAL = np.array([0x7FC00123, 0x7F800000, -0x800000, -2 ** 31, 5],
                    np.int32).view(np.float32)


@pytest.mark.parametrize("with_counts", [True, False])
@pytest.mark.parametrize("s", [1, 5, 65])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_row_gather_edge_shapes_match_reference(k, s, with_counts):
    """The gather's edge shapes, bit for bit against the JAX oracle and the
    Pallas kernel in interpret mode (one worker at a time, as the reference
    launches it): K workers of 333 rows, S rows each (no multiple of a
    per-block row count), counts 0, 1, 17, 1023 and 1024 tiled over the
    workers, NaN, ±inf, −0.0 and a subnormal in lanes that a count ≥ 17
    keeps and in the last lanes, which only 1024 keeps; repeated
    indices."""
    rows = 333
    rng = np.random.default_rng(100 * k + s)
    x = rng.standard_normal((k, rows, LANE)).astype(np.float32)
    x[:, :, 3:8] = _SPECIAL
    x[:, :, LANE - 5:] = _SPECIAL
    counts = rng.choice(np.array([0, 1, 17, LANE - 1, LANE], np.float32),
                        k * rows)
    idx = rng.integers(0, rows, (k, s)).astype(np.int32)
    if s > 1:
        idx[:, -1] = idx[:, 0]
        counts[idx[:, 0] + rows * np.arange(k)] = LANE   # specials kept
    c = counts if with_counts else None
    got = ops.row_gather(torch.from_numpy(x), torch.from_numpy(idx),
                         None if c is None else torch.from_numpy(c))
    assert got.shape == (k, s, LANE)
    for i in range(k):
        ci = None if c is None else jnp.asarray(c[i * rows:(i + 1) * rows])
        want = r_ref.row_gather_ref(jnp.asarray(x[i]), jnp.asarray(idx[i]),
                                    ci)
        kern = row_gather_pallas(jnp.asarray(x[i]), jnp.asarray(idx[i]), ci,
                                 interpret=True)
        np.testing.assert_array_equal(_bits(got[i]), _bits(want))
        np.testing.assert_array_equal(_bits(got[i]), _bits(kern))
    if s > 1:
        np.testing.assert_array_equal(_bits(got[:, -1]), _bits(got[:, 0]))
        np.testing.assert_array_equal(_bits(got[:, 0, 3:8]),
                                      np.broadcast_to(_bits(_SPECIAL),
                                                      (k, 5)))


def _sparse_tree():
    """Leaves whose rows are touched, untouched and partly touched, so the
    budgets take zero-norm rows and ties decide which."""
    rng = np.random.default_rng(5)
    w1 = rng.standard_normal((K, 5 * LANE)).astype(np.float32)
    w1[:, LANE:3 * LANE] = 0.0                   # rows 1-2 untouched
    w2 = np.zeros((K, 4 * LANE + 9), np.float32)
    w2[:, 2 * LANE + 3] = 1.0                    # one touched row of 5
    w2[1, LANE + 7] = -2.0
    w3 = rng.standard_normal((K, 7)).astype(np.float32)
    w3[2] = 0.0
    return {"w1": w1, "w2": w2, "w3": w3}


@pytest.mark.parametrize("max_rows", [1, 2, 3, 64])
def test_plan_select_matches_reference_with_zero_norm_ties(max_rows):
    tree = _sparse_tree()
    codec = wire.make_codec(SparseRowsCompressor(max_rows=max_rows))
    rcodec = r_wire.make_codec(r_comp.SparseRowsCompressor(max_rows=max_rows))
    ptree = {k: torch.from_numpy(v) for k, v in tree.items()}
    plan = ops.KernelPlan.for_tree(ptree, worker_dim=True)
    rplan = RPlan.for_tree({k: jnp.asarray(v) for k, v in tree.items()},
                           worker_dim=True)
    mat = plan.flatten(ptree)
    idx = codec.plan_select(mat, plan)
    ridx = rcodec.plan_select(jnp.asarray(mat.numpy()), rplan)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    assert idx.shape == (K, codec.plan_budget(plan)) and \
        codec.plan_budget(plan) == rcodec.plan_budget(rplan)
    assert bool((idx[:, 1:] > idx[:, :-1]).all())
    # the per-leaf selector on each worker's whole matrix: mostly zero
    # rows, so ties decide nearly every pick
    for k in range(K):
        np.testing.assert_array_equal(
            wire.sparse_row_select(mat[k], max_rows).numpy(),
            np.asarray(r_wire.sparse_row_select(jnp.asarray(mat[k].numpy()),
                                                max_rows)))


def _leaf(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[: flat.size // 3] = 0.0                 # untouched rows
    flat[::7] = -0.0
    return x


LEAF_SHAPES = [(3,), (LANE + 1,), (3, 3, 16, 16), (5 * LANE + 7,)]


@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("max_rows", [2, 64])
def test_sparse_codec_matches_reference(inner, max_rows):
    pc = SparseRowsCompressor(max_rows=max_rows, inner=inner)
    rc = r_comp.SparseRowsCompressor(max_rows=max_rows, inner=inner)
    codec, rcodec = wire.make_codec(pc), r_wire.make_codec(rc)
    assert codec.rows_supported == rcodec.rows_supported
    assert pc.wire_bits_per_element() == rc.wire_bits_per_element()
    for i, shape in enumerate(LEAF_SHAPES):
        x = _leaf(shape, i)
        n = x.size
        assert codec.wire_bytes(n) == rcodec.wire_bytes(n)
        assert codec.budget(n) == rcodec.budget(n)
        assert pc.delta_lower_bound(n) == rc.delta_lower_bound(n)
        payload = codec.pack(torch.from_numpy(x))
        rpayload = rcodec.pack(jnp.asarray(x))
        assert sorted(payload) == sorted(rpayload)
        assert wire.payload_nbytes(payload) == codec.wire_bytes(n)
        for k, v in payload.items():
            want = np.asarray(rpayload[k])
            assert v.shape == want.shape, k
            if v.is_floating_point():
                np.testing.assert_array_equal(_bits(v), _bits(want))
            else:
                np.testing.assert_array_equal(v.numpy(), want)
        got = codec.unpack(payload, n, shape, torch.float32)
        want = rcodec.unpack(rpayload, n, shape, jnp.float32)
        assert tuple(got.shape) == shape
        assert _ulps(got, want) <= (1 if inner == "qsgd" else 0)


@pytest.mark.parametrize("inner", INNERS)
def test_sparse_matrix_path_equals_per_leaf_path(inner):
    """rows_pack of the stacked matrix with the counts tiled over the
    workers (as the optimizer passes them) equals the per-leaf packs, the
    row indices offset by each leaf's row start; the gathered counts are
    read at each worker's own rows."""
    codec = wire.make_codec(SparseRowsCompressor(max_rows=2, inner=inner))
    tree = {f"l{i}": torch.from_numpy(np.stack([_leaf(s, 10 * i + k)
                                                 for k in range(K)]))
            for i, s in enumerate(LEAF_SHAPES)}
    plan = ops.KernelPlan.for_tree(tree, worker_dim=True)
    mat = plan.flatten(tree)
    tiled = ops.tile_counts(plan.row_counts(), plan.rows, (K,))
    payload = codec.rows_pack(mat, counts=tiled, plan=plan)
    again = codec.rows_pack(mat, counts=plan.row_counts(), plan=plan)
    for key in payload:
        assert torch.equal(payload[key], again[key])
    q = plan.unflatten(codec.rows_unpack(payload, plan=plan))
    at = 0
    for name, slot in zip(plan.names, plan.slots):
        b = codec.budget(slot.size)
        for k in range(K):
            mine = codec.pack(tree[name][k])
            assert torch.equal(payload["rowidx"][k, at:at + b],
                               mine["rowidx"] + slot.row_start)
            for key, v in mine.items():
                if key != "rowidx":
                    assert torch.equal(payload[key][k, at:at + b], v), key
            want = codec.unpack(mine, slot.size, slot.shape, torch.float32)
            np.testing.assert_array_equal(_bits(q[name][k]), _bits(want))
        at += b
    assert codec.rows_wire(payload, plan).keys() == payload.keys()
    shipped = wire.payload_nbytes(codec.rows_wire(payload, plan))
    assert shipped == K * sum(codec.wire_bytes(s.size) for s in plan.slots)


def test_bytes_per_comm_round_on_the_embedding_table():
    """The 65,536 × 64 f32 table of benchmarks/embedding_wire.py: 64 rows
    of 1024 plus their i32 indices to 2 ring neighbours, 524,800 B, the
    reference's number (and BENCH_embedding.json's round_sparse)."""
    comp = SparseRowsCompressor(max_rows=64)
    opt = CPDSGDM(CPDSGDMConfig(use_kernel=True), DenseComm(ring(K),
                                                            device="cpu"),
                  comp)
    table = {"table": torch.empty((65536, 64), device="meta")}
    assert opt.bytes_per_comm_round(table) == 524_800 == 2 * 64 * (4 + 4096)
    assert opt.kernel_comm_supported
    ropt = RCPDSGDM(RCPDSGDMConfig(use_kernel=True), RDenseComm(r_ring(K)),
                    r_comp.SparseRowsCompressor(max_rows=64))
    assert ropt.bytes_per_comm_round(
        {"table": jax.ShapeDtypeStruct((65536, 64), jnp.float32)}) == 524_800
    for name in ("sparse", "sparse_rows", "sparse+sign", "sparse+qsgd"):
        ours, theirs = make_compressor(name, max_rows=8), \
            r_comp.make_compressor(name, max_rows=8)
        assert (ours.inner, ours.max_rows) == (theirs.inner, theirs.max_rows)
        assert wire.make_codec(ours).wire_bytes(65536 * 64) == \
            r_wire.make_codec(theirs).wire_bytes(65536 * 64)


# ------------------------------------------------------- CPD-SGDM rounds
def _problem():
    """2 rounds of the quadratic of tests/test_kernels.py:_run_rounds:
    loss 0.5·Σ(l − c)² with c from the batch, so every gradient is smooth;
    leaf w1 has 3 kernel rows, so max_rows = 2 selects."""
    rng = np.random.default_rng(0)
    params = {"w1": rng.standard_normal((K, 33, 65)).astype(np.float32),
              "w2": rng.standard_normal((K, 7)).astype(np.float32),
              "w3": rng.standard_normal((K, 2, 5, 11)).astype(np.float32)}
    batches = [rng.standard_normal((P, K, 2, 3)).astype(np.float32)
               for _ in range(2)]
    return params, batches


def _torch_grads(params, batch):
    c = batch["b"][:, 0, 0]
    grads = {k: v - c.reshape((-1,) + (1,) * (v.dim() - 1))
             for k, v in params.items()}
    loss = sum(0.5 * (g ** 2).sum() for g in grads.values()) / c.shape[0]
    return loss, grads


def _jax_grads(params, batch):
    c = batch[:, 0, 0]
    grads = {k: v - c.reshape((-1,) + (1,) * (v.ndim - 1))
             for k, v in params.items()}
    loss = sum(0.5 * jnp.sum(g ** 2) for g in grads.values()) / c.shape[0]
    return loss, grads


HYPER = dict(eta=0.05, mu=0.9, p=P, gamma=0.4, weight_decay=1e-4)


def _port_rounds(inner, use_kernel=True, per_leaf=False):
    params, batches = _problem()
    opt = CPDSGDM(CPDSGDMConfig(use_kernel=use_kernel, **HYPER),
                  DenseComm(ring(K), device="cpu"),
                  SparseRowsCompressor(max_rows=2, inner=inner))
    if per_leaf:
        opt._kernel_wire = lambda: False
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    state = opt.init(p)
    for b in batches:
        p, state, _ = opt.round(state, p, _torch_grads,
                                {"b": torch.from_numpy(b)})
    return opt, p, state


@functools.lru_cache(maxsize=None)
def _ref_rounds(inner):
    params, batches = _problem()
    opt = RCPDSGDM(RCPDSGDMConfig(use_kernel=True, **HYPER),
                   RDenseComm(r_ring(K)),
                   r_comp.SparseRowsCompressor(max_rows=2, inner=inner))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    round_fn = jax.jit(lambda s, pp, bs: opt.round(s, pp, _jax_grads, bs))
    for b in batches:
        p, state, _ = round_fn(state, p, jnp.asarray(b))
    return ({k: np.asarray(v) for k, v in p.items()},
            {k: np.asarray(v) for k, v in state["xhat"].items()})


@pytest.mark.parametrize("inner", ["f32", "sign"])
def test_cpd_sparse_rounds_match_reference(inner):
    """Two kernel rounds of both packages (the reference's Pallas row
    kernels in interpret mode) on the smooth problem: the same rows ship,
    params and x̂ within rtol 1e-3 / atol 1e-4 (measured: at most 4.8e-7
    apart, f32 and sign inner alike, from the momentum and consensus
    products, which each package rounds in its own order)."""
    opt, params, state = _port_rounds(inner)
    assert opt.kernel_comm_supported
    rparams, rxhat = _ref_rounds(inner)
    for name in rparams:
        np.testing.assert_allclose(params[name].numpy(), rparams[name],
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(state["xhat"][name].numpy(), rxhat[name],
                                   rtol=1e-3, atol=1e-4)
        assert np.abs(params[name].numpy() - rparams[name]).max() < 1e-5


@pytest.mark.parametrize("inner", INNERS)
def test_cpd_sparse_kernel_path_equals_tree_path(inner):
    """The port's kernel round against its tree round (kernel wire from the
    tree) and against the per-leaf codec round: the same rows and values;
    only the consensus product's shape differs, held to rtol 1e-6 /
    atol 1e-7 (measured on the CPU: bit-identical)."""
    _, pk, sk = _port_rounds(inner, use_kernel=True)
    for per_leaf in (False, True):
        _, pt, st = _port_rounds(inner, use_kernel=False, per_leaf=per_leaf)
        for name in pk:
            np.testing.assert_allclose(pk[name].numpy(), pt[name].numpy(),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(sk["xhat"][name].numpy(),
                                       st["xhat"][name].numpy(),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("inner", INNERS)
def test_sparse_payload_wire_equals_kernel_wire(inner):
    """The per-leaf codec wire and the kernel wire on the same drift give
    the same x̂, bit for bit."""
    params, _ = _problem()
    opt = CPDSGDM(CPDSGDMConfig(**HYPER), DenseComm(ring(K), device="cpu"),
                  SparseRowsCompressor(max_rows=2, inner=inner))
    diff = {k: torch.from_numpy(v) for k, v in params.items()}
    xhat = {k: torch.from_numpy(0.5 * v) for k, v in params.items()}
    by_rows, by_leaf = {}, {}
    opt._comm_kernel_wire(by_rows, xhat, diff)
    opt._comm_payload_wire(by_leaf, xhat, diff, 0)
    for name in xhat:
        assert torch.equal(by_rows["xhat"][name], by_leaf["xhat"][name])


# ------------------------------------------------------- embedding stream
def test_embed_batch_deterministic_and_power_law():
    cfg = EmbedStreamCfg(n_rows=4096, dim=32, batch=64, n_workers=4, seed=5,
                         zipf_a=1.2)
    b1, b2 = embed_batch(cfg, 3, "cpu"), embed_batch(cfg, 3, "cpu")
    assert torch.equal(b1["ids"], b2["ids"])
    assert torch.equal(b1["targets"], b2["targets"])
    assert not torch.equal(b1["ids"], embed_batch(cfg, 4, "cpu")["ids"])
    ids = b1["ids"].numpy()
    assert ids.shape == (4, 64) and b1["targets"].shape == (4, 64)
    assert ids.min() >= 0 and ids.max() < cfg.n_rows
    # the Zipf head: the hottest row takes far more than the uniform share
    _, counts = np.unique(ids, return_counts=True)
    assert counts.max() >= 20
    # the same fields as the reference's stream
    rcfg = r_syn.EmbedStreamCfg(n_rows=4096, dim=32, batch=64, n_workers=4,
                                seed=5, zipf_a=1.2)
    assert [f.name for f in cfg.__dataclass_fields__.values()] == \
        [f.name for f in rcfg.__dataclass_fields__.values()]


def test_touched_row_mask_matches_reference():
    """On the reference's own ids: the same rows, as many as distinct ids."""
    rcfg = r_syn.EmbedStreamCfg(n_rows=4096, dim=32, batch=64, n_workers=4,
                                seed=5)
    rids = np.array(r_syn.embed_batch(rcfg, 3)["ids"])
    mask = touched_row_mask(torch.from_numpy(rids).long(), 4096)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(r_syn.touched_row_mask(jnp.asarray(rids),
                                                        4096)))
    assert int(mask.sum()) == len(np.unique(rids)) < 0.1 * 4096
