"""The port's top-k wire against the reference's: the select and scatter
wrappers, the matrix wrappers, the top-k codec and its dispatch.

On the CPU each kernel wrapper runs its plain PyTorch version; it is held
against the Pallas kernels in interpret mode, as tests/test_kernels.py runs
them, and against the JAX oracle ``repro.core.wire.topk_rows``.  Bars, all
exact:

* indices: equal, tie order included (|x| descending, ties to the lowest
  index), on rows of a few values where ties abound;
* selected values: equal to the oracle bit for bit (both keep a selected
  −0.0 as read); equal to the Pallas kernel as numbers, because the kernel
  forms each value as a sum over the row and turns a selected −0.0 into
  +0.0 (``np.array_equal`` treats ±0 as equal);
* scatters and decodes: bit for bit (each adds the slots to +0.0), on
  the select's payloads and on payloads that repeat a column;
* the radix select's hard rows (a tie run across the W-th place,
  subnormals, ±inf, equal |x|): as above, but where XLA on the CPU
  flushes subnormals (see :func:`test_topk_edge_rows_match_reference`);
* bytes and the kernel-wire dispatch: equal.

The CUDA kernels are held bit for bit against the same plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compression as r_comp  # noqa: E402
from repro.core import wire as r_wire  # noqa: E402
from repro.core.cpdsgdm import CPDSGDM as RCPDSGDM  # noqa: E402
from repro.core.cpdsgdm import CPDSGDMConfig as RCPDSGDMConfig  # noqa: E402
from repro.core.gossip import DenseComm as RDenseComm  # noqa: E402
from repro.core.topology import ring as r_ring  # noqa: E402
from repro.kernels import topk_select as r_tk  # noqa: E402
from repro_torch.core import (CPDSGDM, CPDSGDMConfig, DenseComm,  # noqa: E402
                              TopKCompressor, ring)
from repro_torch.core import wire  # noqa: E402
from repro_torch.kernels import LANE, ops  # noqa: E402
from repro_torch.kernels import topk_select as tk  # noqa: E402
from repro_torch.kernels.ref import topk_width  # noqa: E402


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


FRACTIONS = [0.001, 0.01, 0.1, 0.125]          # W = 2, 11, 103, 128
LEAF_SHAPES = [(3,), (LANE + 1,), (3, 3, 16, 16), (2 * LANE + 7,)]


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _topk_rows(rows=r_tk.BLOCK_ROWS, seed=0):
    """Random rows with the select's edge cases: counts 0, 1, 17 and full;
    an all-zero and an all −0.0 row; rows of a few values, so ties abound;
    −0.0 among a row's largest entries."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, LANE)).astype(np.float32)
    counts = np.full((rows, 1), float(LANE), np.float32)
    for r, n in ((1, 0), (2, 17), (3, 1), (rows - 1, 0)):
        x[r, n:] = 0.0
        counts[r] = n
    x[4] = 0.0
    x[5] = -0.0
    x[6] = np.round(x[6] * 2.0) / 2.0
    x[7] = np.sign(x[7])
    x[8, ::3] = -0.0
    x[9, :700] = 0.0
    x[9, 900:] = -0.0
    x[10] = np.resize(np.array([1.0, -1.0, 0.5, -0.0], np.float32), LANE)
    return x, counts


@pytest.mark.parametrize("fraction", FRACTIONS)
def test_topk_select_and_scatter_match_reference(fraction):
    x, counts = _topk_rows(seed=int(fraction * 1000))
    before = (tk.topk_select.launches, tk.topk_scatter.launches)
    idx, vals = tk.topk_select(torch.from_numpy(x), torch.from_numpy(counts),
                               fraction=fraction)
    w = topk_width(fraction, LANE)
    assert idx.shape == vals.shape == (r_tk.BLOCK_ROWS, w)
    assert idx.dtype == torch.int32 and w <= tk.MAX_WIDTH
    oi, ov = r_wire.topk_rows(jnp.asarray(x), jnp.asarray(counts),
                              fraction=fraction)
    ki, kv = r_tk.topk_select_pallas(jnp.asarray(x), jnp.asarray(counts),
                                     fraction=fraction, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(oi))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ki))
    np.testing.assert_array_equal(_bits(vals), _bits(ov))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(kv))
    # active slots follow ceil(f32(f)·count): none on the count-0 rows
    assert not vals[1].any() and not idx[1].any()
    # the scatter of each package's payload, bit for bit
    out = tk.topk_scatter(idx, vals)
    np.testing.assert_array_equal(
        _bits(out), _bits(r_wire.topk_rows_unpack(oi, ov, LANE)))
    np.testing.assert_array_equal(
        _bits(out), _bits(r_tk.topk_scatter_pallas(ki, kv, interpret=True)))
    assert not np.signbit(out.numpy()[out.numpy() == 0]).any()
    assert (tk.topk_select.launches, tk.topk_scatter.launches) == before


def _edge_rows(kind, fraction, seed=0, rows=r_tk.BLOCK_ROWS):
    """Rows of one hard case for a radix select, counts 1, 1023 and 0 on
    rows 0-2 (zero tails, as the plan pads them) and full counts after:

    * ``straddle``: W − 5 distinct large |x|, then a run of 12 equal |x|
      of random signs across the W-th place, over small noise;
    * ``subnormal``: every entry subnormal, of random sign (the keys differ
      only in the low digits);
    * ``inf``: normal rows with 0-6 entries of ±inf (ties among them at W);
    * ``equal``: every |x| equal (the contended case)."""
    rng = np.random.default_rng(seed)
    w = topk_width(fraction, LANE)
    x = np.empty((rows, LANE), np.float32)
    for r in range(rows):
        if kind == "straddle":
            x[r] = rng.uniform(0.0, 0.5, LANE)
            cols = rng.permutation(LANE)
            big = max(w - 5, 0)
            x[r, cols[:big]] = 10.0 + np.arange(big)
            x[r, cols[big:big + 12]] = 5.0 * rng.choice([-1.0, 1.0], 12)
        elif kind == "subnormal":
            bits = (rng.integers(1, 1 << 12, LANE).astype(np.uint32)
                    | (rng.integers(0, 2, LANE).astype(np.uint32) << 31))
            x[r] = bits.view(np.float32)
        elif kind == "inf":
            x[r] = rng.standard_normal(LANE)
            n = r % 7
            x[r, rng.choice(LANE, n, replace=False)] = rng.choice(
                [-np.inf, np.inf], n)
        else:
            x[r] = 0.75 * rng.choice([-1.0, 1.0], LANE)
    counts = np.full((rows, 1), float(LANE), np.float32)
    for r, n in ((0, 1), (1, LANE - 1), (2, 0)):
        x[r, n:] = 0.0
        counts[r] = n
    return x, counts


def _flush(a):
    """Subnormals to zero of the same sign, as XLA on the CPU reads them."""
    a = np.array(a, np.float32)
    sub = (np.abs(a) < np.finfo(np.float32).tiny) & (a != 0)
    a[sub] = np.copysign(0.0, a[sub])
    return a


@pytest.mark.parametrize("fraction", FRACTIONS)
@pytest.mark.parametrize("kind", ["straddle", "subnormal", "inf", "equal"])
def test_topk_edge_rows_match_reference(kind, fraction):
    """The plain select and scatter against the oracle and the Pallas
    kernels on the radix select's hard rows: indices exact, tie order
    included, values bit for bit against the oracle.  XLA on the CPU
    flushes subnormals to zero of the same sign (the TPU has none, and the
    card's scatter_add flushes them too), so on subnormal rows the Pallas
    select is held against the plain select of the flushed rows, the
    plain scatter against numpy's exact sum, and the JAX scatters against
    the plain scatter of the flushed payload."""
    x, counts = _edge_rows(kind, fraction, seed=int(fraction * 1000))
    idx, vals = tk.topk_select(torch.from_numpy(x), torch.from_numpy(counts),
                               fraction=fraction)
    oi, ov = r_wire.topk_rows(jnp.asarray(x), jnp.asarray(counts),
                              fraction=fraction)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(oi))
    np.testing.assert_array_equal(_bits(vals), _bits(ov))
    assert not idx[2].any() and not vals[2].any()     # count 0
    assert int((vals[0] != 0).sum()) <= 1             # count 1: one slot
    flushed = kind == "subnormal"
    xk = _flush(x) if flushed else x
    ki, kv = r_tk.topk_select_pallas(jnp.asarray(x), jnp.asarray(counts),
                                     fraction=fraction, interpret=True)
    pi, pv = tk.topk_select(torch.from_numpy(xk), torch.from_numpy(counts),
                            fraction=fraction)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ki))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(kv))
    out = tk.topk_scatter(idx, vals)
    exact = np.zeros(x.shape, np.float32)
    np.add.at(exact, (np.arange(x.shape[0])[:, None], idx.numpy()),
              vals.numpy())
    np.testing.assert_array_equal(_bits(out), _bits(exact))
    payload = torch.from_numpy(_flush(vals.numpy())) if flushed else vals
    np.testing.assert_array_equal(
        _bits(tk.topk_scatter(idx, payload)),
        _bits(r_wire.topk_rows_unpack(oi, ov, LANE)))
    np.testing.assert_array_equal(
        _bits(tk.topk_scatter(pi, pv)),
        _bits(r_tk.topk_scatter_pallas(ki, kv, interpret=True)))


@pytest.mark.parametrize("fraction", FRACTIONS)
def test_topk_scatter_repeated_columns_matches_reference(fraction):
    """A payload whose nonzero slots name a column more than once (the
    select never emits one; the scatter's contract holds for any): small
    integers, so every order of the adds gives the same sum; ±0.0 slots
    and (0, 0.0) placeholders among them.  Bit for bit against the
    oracle's scatter-add and the Pallas kernel."""
    rng = np.random.default_rng(11)
    w = topk_width(fraction, LANE)
    rows = r_tk.BLOCK_ROWS
    idx = rng.integers(0, LANE, (rows, w)).astype(np.int32)
    idx[:, -1] = idx[:, 0]
    idx[::2, : w // 2] = idx[::2, w - w // 2:]
    vals = rng.integers(-8, 9, (rows, w)).astype(np.float32)
    vals[1::3, 0] = -0.0
    idx[3], vals[3] = 0, 0.0                          # a dead row
    out = tk.topk_scatter(torch.from_numpy(idx), torch.from_numpy(vals))
    np.testing.assert_array_equal(
        _bits(out), _bits(r_wire.topk_rows_unpack(jnp.asarray(idx),
                                                  jnp.asarray(vals), LANE)))
    np.testing.assert_array_equal(
        _bits(out), _bits(r_tk.topk_scatter_pallas(
            jnp.asarray(idx), jnp.asarray(vals), interpret=True)))
    assert not np.signbit(out.numpy()[out.numpy() == 0]).any()
    assert not out[3].any()


def test_k_active_rounds_the_product_in_f32():
    """f32(0.1)·10 rounds to exactly 1.0 in f32 (1 active slot) where the
    float64 product 1.0000000149 would give 2: the port takes the f32
    product, as the reference's ``jnp.float32(fraction) * counts``."""
    x = np.arange(1, LANE + 1, dtype=np.float32)[None].repeat(2, 0)
    counts = np.array([[10.0], [11.0]], np.float32)
    idx, vals = tk.topk_select(torch.from_numpy(x), torch.from_numpy(counts),
                               fraction=0.1)
    oi, _ = r_wire.topk_rows(jnp.asarray(x), jnp.asarray(counts),
                             fraction=0.1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(oi))
    assert int((vals[0] != 0).sum()) == 1 and int((vals[1] != 0).sum()) == 2


def test_topk_matrix_wrappers_take_lead_dims_and_tiled_counts():
    """(K, rows, LANE) runs as one (K·rows, LANE) call; per-worker counts
    are tiled, tiled counts taken as they are; None means full rows."""
    K, rows = 2, 256
    xs = [_topk_rows(rows, seed)[0] for seed in (1, 2)]
    x = torch.from_numpy(np.stack(xs))
    counts = torch.from_numpy(_topk_rows(rows, 1)[1])
    a = ops.topk_pack(x, counts, fraction=0.1)
    b = ops.topk_pack(x, ops.tile_counts(counts, rows, (K,)), fraction=0.1)
    flat = tk.topk_select(x.reshape(-1, LANE), counts.repeat(K, 1),
                          fraction=0.1)
    for u, v, f in zip(a, b, flat):
        assert u.shape == (K, rows, 103)
        assert torch.equal(u, v) and torch.equal(u.reshape(-1, 103), f)
    q = ops.topk_unpack(*a)
    assert q.shape == (K, rows, LANE)
    assert torch.equal(q.reshape(-1, LANE), tk.topk_scatter(*flat))
    full = ops.topk_pack(x, None, fraction=0.1)
    assert torch.equal(full[0], ops.topk_pack(
        x, torch.full((rows, 1), float(LANE)), fraction=0.1)[0])


def test_topk_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((256, LANE))
    c = torch.full((256, 1), float(LANE))
    with pytest.raises(ValueError):
        tk.topk_select(x, c, fraction=0.2)            # W = 205 > MAX_WIDTH
    with pytest.raises(ValueError):
        tk.topk_select(x, c, fraction=0.0)
    with pytest.raises(ValueError):
        tk.topk_select(x, c[:128], fraction=0.1)
    with pytest.raises(TypeError):
        tk.topk_select(x.double(), c, fraction=0.1)
    idx, vals = tk.topk_select(x, c, fraction=0.1)
    with pytest.raises(TypeError):
        tk.topk_scatter(idx.long(), vals)
    with pytest.raises(ValueError):
        tk.topk_scatter(idx, vals[:, :50])
    with pytest.raises(ValueError):
        tk.topk_scatter(torch.zeros((4, 129), dtype=torch.int32),
                        torch.zeros((4, 129)))


def _leaf(shape, seed):
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal(shape) * 4.0).astype(np.float32) / 4.0
    x.reshape(-1)[::7] = -0.0
    return x


@pytest.mark.parametrize("fraction,block", [(0.1, LANE), (0.01, LANE),
                                            (0.1, 64), (0.3, LANE)])
def test_topk_codec_matches_reference(fraction, block):
    """Per-leaf payload, decode and bytes of the codec against the
    reference's, on tie-heavy leaves (values on a grid of 1/4)."""
    pc = TopKCompressor(fraction=fraction, block=block)
    rc = r_comp.TopKCompressor(fraction=fraction, block=block)
    codec, rcodec = wire.make_codec(pc), r_wire.make_codec(rc)
    assert (codec.name, codec.block, codec.width) == \
        (rcodec.name, rcodec.block, rcodec.width)
    assert codec.rows_supported == rcodec.rows_supported
    assert pc.wire_bits_per_element() == rc.wire_bits_per_element()
    for i, shape in enumerate(LEAF_SHAPES):
        x = _leaf(shape, i)
        n = x.size
        assert codec.wire_bytes(n) == rcodec.wire_bytes(n)
        assert pc.delta_lower_bound(n) == rc.delta_lower_bound(n)
        payload = codec.pack(torch.from_numpy(x))
        rpayload = rcodec.pack(jnp.asarray(x))
        assert sorted(payload) == sorted(rpayload) == ["idx", "vals"]
        assert wire.payload_nbytes(payload) == codec.wire_bytes(n)
        np.testing.assert_array_equal(payload["idx"].numpy(),
                                      np.asarray(rpayload["idx"]))
        np.testing.assert_array_equal(_bits(payload["vals"]),
                                      _bits(rpayload["vals"]))
        got = codec.unpack(payload, n, shape, torch.float32)
        want = rcodec.unpack(rpayload, n, shape, jnp.float32)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(pc.apply(torch.from_numpy(x))),
                                      _bits(rc.apply(jnp.asarray(x))))


def test_topk_matrix_path_equals_per_leaf_path():
    """One rows pack of the stacked drift matrix equals the per-leaf,
    per-worker packs exactly: the kernel rows are the per-leaf blocks."""
    K = 3
    codec = wire.make_codec(TopKCompressor(fraction=0.1))
    tree = {f"l{i}": torch.from_numpy(np.stack([_leaf(s, 10 * i + k)
                                                 for k in range(K)]))
            for i, s in enumerate(LEAF_SHAPES)}
    plan = ops.KernelPlan.for_tree(tree, worker_dim=True)
    payload = codec.rows_pack(plan.flatten(tree), counts=plan.row_counts(),
                              plan=plan)
    q = plan.unflatten(codec.rows_unpack(payload, plan=plan))
    for name, slot in zip(plan.names, plan.slots):
        rows = slice(slot.row_start, slot.row_start + slot.n_rows)
        for k in range(K):
            mine = codec.pack(tree[name][k])
            for key, v in mine.items():
                assert torch.equal(payload[key][k, rows], v), (name, key)
            want = codec.unpack(mine, slot.size, slot.shape, torch.float32)
            np.testing.assert_array_equal(_bits(q[name][k]), _bits(want))
    shipped = wire.payload_nbytes(codec.rows_wire(payload, plan))
    assert shipped == K * sum(codec.wire_bytes(s.size) for s in plan.slots)


@pytest.mark.parametrize("fraction", [0.01, 0.1, 0.125, 0.126, 0.2])
def test_kernel_wire_dispatch_matches_reference(fraction):
    """W ≤ MAX_WIDTH takes the kernel wire, wider payloads the per-leaf
    codec, in both packages; MAX_WIDTH and BLOCK_ROWS are the reference's."""
    assert (tk.MAX_WIDTH, tk.BLOCK_ROWS) == (r_tk.MAX_WIDTH, r_tk.BLOCK_ROWS)
    assert ops.PLAN_BLOCK_ROWS % tk.BLOCK_ROWS == 0
    opt = CPDSGDM(CPDSGDMConfig(use_kernel=True), DenseComm(ring(4),
                                                            device="cpu"),
                  TopKCompressor(fraction=fraction))
    ropt = RCPDSGDM(RCPDSGDMConfig(use_kernel=True), RDenseComm(r_ring(4)),
                    r_comp.TopKCompressor(fraction=fraction))
    assert opt.codec.rows_supported == ropt.codec.rows_supported
    assert opt.kernel_comm_supported == ropt.kernel_comm_supported
    assert opt.kernel_comm_supported == (topk_width(fraction, LANE) <= 128)
