"""The port's compressors, wire codecs and codec kernels against the
reference's.

On the CPU each kernel wrapper runs its plain PyTorch version; it is held
against the Pallas kernel in interpret mode, as tests/test_kernels.py runs
it, and against the JAX oracles.  Bars:

* sign bits, QSGD levels and norms, and every unpack given equal inputs:
  exact (bit patterns, signs of zero included);
* sign scales: the port sums |x| in one fixed tree order
  (``repro_torch.kernels.ref.tree_sum``), the reference with ``jnp.sum``,
  whose order it does not pin.  Measured: 4 ulps of the scale at most
  on the 256- and 512-row matrices here, 2 on the ragged per-leaf blocks;
  held to 8;
* bytes: exact.

The CUDA kernels are held bit for bit against the same plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compression as r_comp  # noqa: E402
from repro.core import wire as r_wire  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402
from repro.kernels.qsgd_quant import (qsgd_dequant_pallas,  # noqa: E402
                                      qsgd_quant_pallas)
from repro.kernels.sign_compress import (sign_pack_pallas,  # noqa: E402
                                         sign_unpack_pallas)
from repro_torch.core import compression as comp  # noqa: E402
from repro_torch.core import wire  # noqa: E402
from repro_torch.kernels import LANE, ops  # noqa: E402
from repro_torch.kernels.qsgd_quant import qsgd_dequant, qsgd_quant  # noqa: E402
from repro_torch.kernels.sign_compress import sign_pack, sign_unpack  # noqa: E402


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


SCALE_ULPS = 8
LEAF_SHAPES = [(3,), (LANE + 1,), (3, 3, 16, 16), (2 * LANE + 7,)]
_COUNTERS = (sign_pack, sign_unpack, qsgd_quant, qsgd_dequant)


def _launches():
    return tuple(f.launches for f in _COUNTERS)


def ulps(a, b) -> int:
    """Largest distance between two f32 arrays in units in the last
    place (ordered integer view)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


def assert_bits_equal(a, b):
    """Equal f32 bit patterns: values and signs of zero."""
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _sign_rows(rows, seed):
    """Rows with counts 0 (zero rows), partial and full, −0.0 entries and
    all-zero rows that still count as full."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, LANE)).astype(np.float32)
    counts = np.full((rows, 1), float(LANE), np.float32)
    for r, n in ((1, 0), (2, 17), (3, 1), (4, LANE - 1), (rows - 1, 0)):
        x[r, n:] = 0.0
        counts[r] = n
    x[5] = 0.0                          # zero row, full count
    x[6] = -0.0                         # negative zeros pack as 1
    x[7, ::3] = -0.0
    return x, counts


@pytest.mark.parametrize("rows", [256, 512])
def test_sign_kernels_match_pallas(rows):
    x, counts = _sign_rows(rows, rows)
    before = _launches()
    packed, scales = sign_pack(torch.from_numpy(x), torch.from_numpy(counts))
    kp, ks = sign_pack_pallas(jnp.asarray(x), jnp.asarray(counts),
                              interpret=True)
    rp, rs = r_ref.sign_pack_rows_ref(jnp.asarray(x), jnp.asarray(counts))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(kp))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(rp))
    assert scales.shape == (rows, 1)
    assert ulps(scales.numpy(), ks) <= SCALE_ULPS
    assert ulps(scales.numpy(), rs) <= SCALE_ULPS
    assert np.all(scales.numpy()[counts[:, 0] == 0] == 0.0)
    assert packed.numpy()[6].tolist() == [255] * (LANE // 8)
    # unpack: exact given the same bits and scales
    out = sign_unpack(torch.from_numpy(np.array(kp)),
                      torch.from_numpy(np.array(ks)))
    assert_bits_equal(out.numpy(), sign_unpack_pallas(kp, ks, interpret=True))
    assert_bits_equal(out.numpy(), r_ref.sign_unpack_ref(kp, ks))
    assert _launches() == before                  # CPU: plain versions


def _qsgd_rows(levels, rows=256, seed=0):
    """Random rows plus rows whose x·qscale land exactly on .5: with
    norm = s the scale is s/s = 1, so x = k + 0.5 is a rounding tie."""
    rng = np.random.default_rng(seed + levels)
    x = rng.standard_normal((rows, LANE)).astype(np.float32)
    s = float(levels)
    ties = np.arange(-s + 0.5, s, 1.0, dtype=np.float32)
    x[1] = np.resize(ties, LANE)
    x[1, 0] = s                                   # sets norm = s
    x[2] = -x[1]
    x[3] = 0.0                                    # norm 0: decodes to +0
    x[4] = -0.0
    x[5, 100:] = 0.0                              # a tail row
    return x


@pytest.mark.parametrize("levels", [1, 7, 127])
def test_qsgd_kernels_match_pallas(levels):
    x = _qsgd_rows(levels)
    before = _launches()
    packed, norms = qsgd_quant(torch.from_numpy(x), levels=levels)
    kp, kn = qsgd_quant_pallas(jnp.asarray(x), levels=levels, interpret=True)
    wp, wn = r_wire.qsgd_rows(jnp.asarray(x), levels=levels)
    bits = r_wire.qsgd_bits(levels)
    assert packed.shape == (256, LANE * bits // 8) and norms.shape == (256, 1)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(kp))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(wp))
    assert_bits_equal(norms.numpy(), kn)
    assert_bits_equal(norms.numpy()[:, 0], wn)
    assert float(norms[1]) == levels                  # the tie rows are live
    out = qsgd_dequant(packed, norms, levels=levels)
    assert_bits_equal(out.numpy(),
                      qsgd_dequant_pallas(kp, kn, levels=levels,
                                          interpret=True))
    assert_bits_equal(out.numpy(),
                      r_wire.qsgd_rows_unpack(wp, wn, levels=levels,
                                              block=LANE))
    assert np.all(out.numpy()[3:5].view(np.int32) == 0)   # exact +0
    assert _launches() == before


def _leaf(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[::7] = -0.0
    return x


def _codec_pair(kind, block):
    if kind == "sign":
        return r_comp.SignCompressor(block=block), \
            comp.SignCompressor(block=block)
    if kind == "qsgd":
        return r_comp.QSGDCompressor(levels=7, block=block), \
            comp.QSGDCompressor(levels=7, block=block)
    return r_comp.IdentityCompressor(), comp.IdentityCompressor()


@pytest.mark.parametrize("kind,block", [("sign", LANE), ("sign", 64),
                                        ("qsgd", LANE), ("qsgd", 64),
                                        ("identity", LANE)])
def test_per_leaf_codecs_match_reference(kind, block):
    rc, pc = _codec_pair(kind, block)
    rcodec, codec = r_wire.make_codec(rc), wire.make_codec(pc)
    assert codec.name == rcodec.name and codec.block == rcodec.block
    assert codec.rows_supported == rcodec.rows_supported
    for i, shape in enumerate(LEAF_SHAPES):
        x = _leaf(shape, i)
        n = x.size
        assert codec.wire_bytes(n) == rcodec.wire_bytes(n)
        assert pc.wire_bytes(torch.from_numpy(x)) == rc.wire_bytes(
            jnp.asarray(x))
        payload = codec.pack(torch.from_numpy(x))
        rpayload = rcodec.pack(jnp.asarray(x))
        assert sorted(payload) == sorted(rpayload)
        assert wire.payload_nbytes(payload) == r_wire.payload_nbytes(
            rpayload) == codec.wire_bytes(n)
        for k, v in payload.items():
            want = np.asarray(rpayload[k])
            assert v.shape == want.shape, k
            if k == "scales":
                assert ulps(v.numpy(), want) <= SCALE_ULPS
            elif v.is_floating_point():
                assert_bits_equal(v.numpy(), want)
            else:
                np.testing.assert_array_equal(v.numpy(), want)
        # unpack of the reference's own payload: exact
        got = codec.unpack({k: torch.from_numpy(np.array(v))
                            for k, v in rpayload.items()}, n, shape,
                           torch.float32)
        want = rcodec.unpack(rpayload, n, shape, jnp.float32)
        assert tuple(got.shape) == shape
        assert_bits_equal(got.numpy(), want)
        # apply = unpack ∘ pack, against the reference's apply
        q = pc.apply(torch.from_numpy(x))
        rq = np.asarray(rc.apply(jnp.asarray(x)))
        if kind == "sign":
            assert ulps(q.numpy(), rq) <= SCALE_ULPS
        else:
            assert_bits_equal(q.numpy(), rq)


@pytest.mark.parametrize("kind", ["sign", "qsgd"])
def test_matrix_path_equals_per_leaf_path(kind):
    """The kernel layout's rows are the per-leaf blocks, so one rows pack
    of the stacked drift matrix equals the per-leaf, per-worker packs
    exactly, payload and decode alike (the sign scale sums in one tree
    order on both)."""
    K = 3
    codec = wire.make_codec(_codec_pair(kind, LANE)[1])
    tree = {f"l{i}": torch.from_numpy(np.stack([_leaf(s, 10 * i + k)
                                                 for k in range(K)]))
            for i, s in enumerate(LEAF_SHAPES)}
    plan = ops.KernelPlan.for_tree(tree, worker_dim=True)
    mat = plan.flatten(tree)
    before = _launches()
    payload = codec.rows_pack(mat, counts=plan.row_counts(), plan=plan)
    q = plan.unflatten(codec.rows_unpack(payload, plan=plan))
    assert _launches() == before
    for name, slot in zip(plan.names, plan.slots):
        leaf = tree[name]
        rows = slice(slot.row_start, slot.row_start + slot.n_rows)
        for k in range(K):
            mine = codec.pack(leaf[k])
            for key, v in mine.items():
                got = payload[key][k, rows]
                assert torch.equal(got.reshape(v.shape), v), (name, key)
            want = codec.unpack(mine, slot.size, slot.shape, torch.float32)
            assert_bits_equal(q[name][k].numpy(), want.numpy())
    # what ships is the used-rows extent: accounted ≡ shipped
    shipped = wire.payload_nbytes(codec.rows_wire(payload, plan))
    assert shipped == K * sum(codec.wire_bytes(s.size) for s in plan.slots)
    back = codec.rows_unwire(codec.rows_wire(payload, plan), plan)
    for key, v in back.items():
        assert v.shape == payload[key].shape
        u = plan.used_rows
        assert torch.equal(v[:, :u], payload[key][:, :u])


def test_mat_wrappers_take_tiled_counts():
    """(K, rows, LANE) runs as one (K·rows, LANE) call; counts of one
    worker are tiled, counts already tiled are taken as they are, and any
    other length is refused."""
    K, rows = 2, 256
    x = torch.from_numpy(np.stack([_sign_rows(rows, s)[0] for s in (1, 2)]))
    counts = torch.from_numpy(_sign_rows(rows, 1)[1])
    a = ops.sign_pack(x, counts)
    b = ops.sign_pack(x, ops.tile_counts(counts, rows, (K,)))
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert a[0].shape == (K, rows, LANE // 8) and a[1].shape == (K, rows, 1)
    flat = sign_pack(x.reshape(-1, LANE), counts.repeat(K, 1))
    assert torch.equal(a[0].reshape(-1, LANE // 8), flat[0])
    assert torch.equal(ops.sign_unpack(*a).reshape(-1, LANE),
                       sign_unpack(*flat))
    with pytest.raises(ValueError):
        ops.tile_counts(counts[:100], rows, (K,))
    p, n = ops.qsgd_pack(x, levels=7)
    assert p.shape == (K, rows, LANE // 2)
    assert torch.equal(ops.qsgd_unpack(p, n, levels=7).reshape(-1, LANE),
                       qsgd_dequant(*qsgd_quant(x.reshape(-1, LANE),
                                                levels=7), levels=7))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((256, LANE))
    c = torch.full((256, 1), float(LANE))
    with pytest.raises(ValueError):
        sign_pack(x, c[:128])                        # counts rows ≠ x rows
    with pytest.raises(TypeError):
        sign_pack(x, c.double())
    with pytest.raises(ValueError):
        sign_pack(torch.zeros((0, LANE)), c[:0])
    with pytest.raises(ValueError):
        sign_pack(x, torch.full((256, 2), float(LANE))[:, :1])   # strided
    p, s = sign_pack(x, c)
    with pytest.raises(ValueError):
        sign_unpack(p[:, :64], s)
    with pytest.raises(TypeError):
        sign_unpack(p.to(torch.int32), s)
    with pytest.raises(ValueError):
        qsgd_quant(x, levels=0)
    with pytest.raises(ValueError):
        qsgd_quant(x, levels=128)                    # needs > 8 bits
    q, n = qsgd_quant(x, levels=7)
    with pytest.raises(ValueError):
        qsgd_dequant(q, n, levels=127)               # 8-bit width expected
    with pytest.raises(ValueError):
        qsgd_dequant(q, n[:10], levels=7)


def test_wire_bytes_bits_and_refusals():
    for n in (1, 7, LANE, LANE + 1, 272_282):
        for block in (64, LANE):
            assert comp.sign_wire_bytes(n, block) == \
                r_comp.sign_wire_bytes(n, block)
    for levels in range(1, 128):
        assert wire.qsgd_bits(levels) == r_wire.qsgd_bits(levels)
    with pytest.raises(ValueError):
        wire.qsgd_bits(128)
    for pc, rc in ((comp.SignCompressor(), r_comp.SignCompressor()),
                   (comp.SignCompressor(block=64),
                    r_comp.SignCompressor(block=64)),
                   (comp.QSGDCompressor(levels=1),
                    r_comp.QSGDCompressor(levels=1)),
                   (comp.QSGDCompressor(), r_comp.QSGDCompressor())):
        assert pc.wire_bits_per_element() == rc.wire_bits_per_element()
        for d in (10, 5000):
            assert pc.delta_lower_bound(d) == rc.delta_lower_bound(d)
    assert comp.IdentityCompressor().wire_bits_per_element(
        torch.bfloat16) == 16.0
    # every name the reference's factory takes now builds, to the same
    # operator and codec (the refusals of the earlier slices are gone)
    for name, kw in (("identity", {}), ("none", {}), ("full", {}),
                     ("sign", {"block": 64}), ("topk", {"fraction": 0.1}),
                     ("randk", {"fraction": 0.05}), ("qsgd", {"levels": 3}),
                     ("sparse", {"max_rows": 8}), ("sparse_rows", {}),
                     ("sparse+sign", {"max_rows": 2}),
                     ("sparse+qsgd", {"levels": 1})):
        ours, theirs = comp.make_compressor(name, **kw), \
            r_comp.make_compressor(name, **kw)
        assert type(ours).__name__ == type(theirs).__name__
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        codec, rcodec = wire.make_codec(ours), r_wire.make_codec(theirs)
        assert type(codec).__name__ == type(rcodec).__name__
        assert codec.rows_supported == rcodec.rows_supported
        assert ours.wire_bits_per_element() == theirs.wire_bits_per_element()
        for d in (3, 10, 5000, 272_282):
            assert ours.delta_lower_bound(d) == theirs.delta_lower_bound(d)
            assert codec.wire_bytes(d) == rcodec.wire_bytes(d)
    with pytest.raises(ValueError):
        comp.make_compressor("gzip")
    assert comp.make_compressor("qsgd", levels=3) == \
        comp.QSGDCompressor(levels=3)
    with pytest.raises(TypeError):
        wire.make_codec(object())

    @dataclasses.dataclass(frozen=True)
    class TopK(comp.Compressor):
        name: str = "topk"

    with pytest.raises(TypeError):               # a custom operator: no codec
        wire.make_codec(TopK())


def test_randk_value_path_with_the_reference_indices():
    """Rand-k's coordinates come from each package's own generator, so the
    value path is held with the reference's indices injected as the key:
    the payload values and both decodes (full payload, and the wire
    payload whose indices the receiver re-derives) equal the reference's,
    bit for bit.  k(n) and the bytes equal the reference's."""
    from repro.core.wire import wire_key as r_wire_key
    pc, rc = comp.RandKCompressor(fraction=0.05), \
        r_comp.RandKCompressor(fraction=0.05)
    codec, rcodec = wire.make_codec(pc), r_wire.make_codec(rc)
    assert codec.keyed and not wire.make_codec(comp.SignCompressor()).keyed
    for i, shape in enumerate(LEAF_SHAPES):
        x = _leaf(shape, i)
        n = x.size
        assert codec.k(n) == rcodec.k(n)
        assert codec.wire_bytes(n) == rcodec.wire_bytes(n) == 4 * codec.k(n)
        rkey = r_wire_key(3, i)
        rpayload = rcodec.pack(jnp.asarray(x), rkey)
        key = torch.from_numpy(np.array(rpayload["idx"])).long()
        payload = codec.pack(torch.from_numpy(x), key)
        assert torch.equal(payload["idx"], key)
        assert_bits_equal(payload["vals"].numpy(), rpayload["vals"])
        want = rcodec.unpack(rpayload, n, shape, jnp.float32)
        assert_bits_equal(codec.unpack(payload, n, shape,
                                       torch.float32).numpy(), want)
        shipped = codec.wire(payload)
        assert list(shipped) == ["vals"]
        assert wire.payload_nbytes(shipped) == codec.wire_bytes(n)
        assert_bits_equal(codec.unpack(shipped, n, shape, torch.float32,
                                       key=key).numpy(), want)


def test_randk_key_is_shared_by_every_worker():
    """The key names the leaf and the round, never the worker: on the
    per-leaf wire every worker keeps the same k coordinates, derived once
    per leaf per round (the same for the round's key on every call, other
    for another leaf or round), and none ships."""
    from repro_torch.core import CPDSGDM, CPDSGDMConfig, DenseComm, ring
    codec = wire.make_codec(comp.RandKCompressor(fraction=0.1))
    n = 3 * LANE + 5
    a = codec.derive_idx(wire.wire_key(2, 1), n)
    assert torch.equal(a, codec.derive_idx(wire.wire_key(2, 1), n))
    assert torch.equal(a, codec.derive_idx(wire.WireKey(1, 2), n))
    assert a.shape == (codec.k(n),) and len(set(a.tolist())) == codec.k(n)
    assert not torch.equal(a, codec.derive_idx(wire.wire_key(3, 1), n))
    assert not torch.equal(a, codec.derive_idx(wire.wire_key(2, 0), n))
    K = 4
    opt = CPDSGDM(CPDSGDMConfig(), DenseComm(ring(K), device="cpu"),
                  comp.RandKCompressor(fraction=0.1))
    rng = np.random.default_rng(0)
    diff = {"b": torch.from_numpy(rng.standard_normal((K, 7)).astype(
                np.float32) + 3.0),
            "w": torch.from_numpy(rng.standard_normal((K, 3, n)).astype(
                np.float32) + 3.0)}
    xhat = {k: torch.zeros_like(v) for k, v in diff.items()}
    out = {}
    opt._comm_payload_wire(out, xhat, diff, torch.tensor(5))
    for i, name in enumerate(("b", "w")):          # the reference leaf order
        kept = out["xhat"][name].reshape(K, -1) != 0
        assert bool((kept == kept[0]).all())
        m = diff[name][0].numel()
        assert int(kept[0].sum()) == codec.k(m)
        idx = codec.derive_idx(wire.wire_key(5, i), m)
        assert bool(kept[0][idx].all())
    params = {k: v[0] for k, v in diff.items()}
    assert opt.bytes_per_comm_round(params) == 2 * 4 * sum(
        codec.k(v.numel()) for v in params.values())
    q = opt._apply_Q(diff, torch.tensor(5))       # packed_wire=False path
    for name in diff:
        assert torch.equal(q[name], out["xhat"][name])


def test_contraction_holds():
    """Q is a δ-contraction with the stated δ (Definition 1)."""
    x = torch.from_numpy(_leaf((3, LANE + 5), 3))
    for c in (comp.SignCompressor(), comp.QSGDCompressor(levels=7),
              comp.QSGDCompressor(levels=1), comp.IdentityCompressor(),
              comp.TopKCompressor(fraction=0.1),
              comp.TopKCompressor(fraction=0.01, block=64),
              comp.SparseRowsCompressor(max_rows=2),
              comp.SparseRowsCompressor(max_rows=1, inner="sign"),
              comp.SparseRowsCompressor(max_rows=2, inner="qsgd")):
        ratio = float(comp.contraction_ratio(x, c.apply(x)))
        assert ratio <= 1.0 - c.delta_lower_bound(x.numel()) + 1e-6
