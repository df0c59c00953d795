"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and nvcc: it carries the ``cuda``
marker and skips without a card.  The file imports neither JAX nor the
reference package, so it runs on a GPU machine that has neither:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The kernels pin their rounding (``__fmul_rn``/``__fadd_rn``, the sign
scale's sum order, ``rintf``), so each must equal its plain version bit for
bit, signs of zero included.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import LANE  # noqa: E402
from repro_torch.kernels.gossip_mix import (gossip_mix,  # noqa: E402
                                            gossip_mix_shifted, launch_count)
from repro_torch.kernels.momentum import momentum_update  # noqa: E402
from repro_torch.kernels.qsgd_quant import qsgd_dequant, qsgd_quant  # noqa: E402
from repro_torch.kernels.ref import (gossip_mix_ref,  # noqa: E402
                                     gossip_shift_ref, momentum_update_ref, qsgd_rows_ref,
                                     qsgd_rows_unpack_ref, row_gather_ref,
                                     row_scatter_ref, sign_pack_rows_ref,
                                     sign_unpack_ref, topk_rows_ref,
                                     topk_rows_unpack_ref)
from repro_torch.kernels.row_gather import row_gather, row_scatter  # noqa: E402
from repro_torch.kernels.sign_compress import sign_pack, sign_unpack  # noqa: E402
from repro_torch.kernels.topk_select import topk_scatter, topk_select  # noqa: E402


def _mats(seed, n, rows):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, LANE), dtype=np.float32)
            for _ in range(n)]


@pytest.mark.cuda
def test_cuda_kernels_bit_exact_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    for rows in (4096, 333):               # the main path's rows; ragged
        x, m, g = (torch.from_numpy(a).to(dev) for a in _mats(rows, 3, rows))
        lr = torch.tensor(0.05, device=dev)
        for nesterov in (False, True):
            before = momentum_update.launches
            got = momentum_update(x, m, g, lr, mu=0.9, wd=1e-4,
                                  nesterov=nesterov)
            want = momentum_update_ref(x, m, g, lr, mu=0.9, wd=1e-4,
                                       nesterov=nesterov)
            torch.cuda.synchronize()
            assert momentum_update.launches == before + 1
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        ws = (1 / 3, 1 / 3, 1 / 3)
        before = gossip_mix.launches
        y = gossip_mix([x, m, g], weights=ws)
        torch.cuda.synchronize()
        assert gossip_mix.launches == before + 1
        assert torch.equal(y, gossip_mix_ref([x, m, g], ws))
    xs = [torch.from_numpy(a).to(dev) for a in _mats(8, 8, 333)]
    for n in range(1, 9):
        ws = tuple(0.1 + 0.05 * j for j in range(n))
        assert torch.equal(gossip_mix(xs[:n], weights=ws),
                           gossip_mix_ref(xs[:n], ws))
    with pytest.raises(ValueError):
        momentum_update(x, m, g.t().contiguous().t(), lr, mu=0.9)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9, 17, 32, 33])
def test_gossip_mix_chains_past_eight_inputs_on_card(n):
    """One launch takes up to 32 inputs (the exponential graph's 9 at
    K = 16 in one); past 32 the wrapper chains launches, each later one
    taking the partial sum with weight 1.0: 2 launches at n = 33; bit for
    bit against one left-to-right sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    xs = [torch.from_numpy(a).to(dev) for a in _mats(n, n, 333)]
    ws = tuple(0.01 + 0.005 * j for j in range(n))
    before = gossip_mix.launches
    y = gossip_mix(xs, weights=ws)
    torch.cuda.synchronize()
    assert gossip_mix.launches - before == launch_count(n) == \
        (1 if n <= 32 else 2)
    assert _same_bits(y, gossip_mix_ref(xs, ws))


@pytest.mark.cuda
@pytest.mark.parametrize("graph,rows,lim", [
    ("ring", 512, 310), ("exp16", 512, 310), ("torus", 512, 310),
    ("ring", 333, 201), ("exp16", 333, 333)])
def test_gossip_mix_shifted_bit_exact_on_card(graph, rows, lim):
    """The shifted-view mix of a static shift graph, one launch per axis,
    equals the plain cut, roll, re-pad and sum bit for bit in both
    designs (the tile the kernel picks, and the stream design forced),
    signs of zero included: the ring and exponential(16) at ResNet-20's
    310 used rows of 512, a 2 × 4 torus, ragged rows, and no cut."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core import exponential, ring, torus
    top = {"ring": ring(8), "exp16": exponential(16),
           "torus": torus((2, 4))}[graph]
    dev = torch.device("cuda")
    rng = np.random.default_rng(rows + lim)
    x = torch.from_numpy(rng.standard_normal(
        (top.n_workers, rows, LANE), dtype=np.float32)).to(dev)
    x[0, lim - 1, :8] = -0.0
    if lim < rows:
        x[0, lim, :8] = -0.0       # −0.0 in the self view, padded neighbours
    per_axis = {}
    for (ax, sh, w) in top.shifts:
        per_axis.setdefault(ax, []).append((sh, w))
    want = x
    for ax in sorted(per_axis):
        shifts, ws = zip(*per_axis[ax])
        want = gossip_shift_ref(want, shifts, ws, grid=top.axis_sizes,
                                axis=ax, lim=lim)
    for force_stream in (False, True):
        before = gossip_mix.launches
        y = x
        for ax in sorted(per_axis):
            shifts, ws = zip(*per_axis[ax])
            y = gossip_mix_shifted(y, grid=top.axis_sizes, axis=ax,
                                   shifts=shifts, weights=ws, lim=lim,
                                   _force_stream=force_stream)
        torch.cuda.synchronize()
        assert gossip_mix.launches - before == len(per_axis)
        assert _same_bits(y, want), force_stream


@pytest.mark.cuda
@pytest.mark.parametrize("graph,rows,lim", [
    ("ring", 512, 310), ("torus", 512, 310), ("ring", 333, 201)])
def test_gossip_mix_shifted_nbr_bit_exact_on_card(graph, rows, lim):
    """The bf16 wire's shifted mix: per axis the self view read from x and
    the neighbour views from ``nbr``, the f32 round trip of the axis's bf16
    payload (views of two matrices: the stream design), equals the plain
    version bit for bit, signs of zero included, one launch per axis."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core import ring, torus
    from repro_torch.core.gossip import bf16_round_trip
    top = {"ring": ring(8), "torus": torus((2, 4))}[graph]
    dev = torch.device("cuda")
    rng = np.random.default_rng(rows + lim + 1)
    x = torch.from_numpy(rng.standard_normal(
        (top.n_workers, rows, LANE), dtype=np.float32)).to(dev)
    x[0, lim - 1, :8] = -0.0
    per_axis = {}
    for (ax, sh, w) in top.shifts:
        per_axis.setdefault(ax, []).append((sh, w))
    before = gossip_mix.launches
    y = want = x
    for ax in sorted(per_axis):
        shifts, ws = zip(*per_axis[ax])
        want = gossip_shift_ref(want, shifts, ws, grid=top.axis_sizes,
                                axis=ax, lim=lim, nbr=bf16_round_trip(want))
        y = gossip_mix_shifted(y, grid=top.axis_sizes, axis=ax,
                               shifts=shifts, weights=ws, lim=lim,
                               nbr=bf16_round_trip(y))
    torch.cuda.synchronize()
    assert gossip_mix.launches - before == len(per_axis)
    assert _same_bits(y, want)
    f32 = gossip_mix_shifted(x, grid=top.axis_sizes, axis=0,
                             shifts=[sh for sh, _ in per_axis[0]],
                             weights=[w for _, w in per_axis[0]], lim=lim)
    assert not _same_bits(f32, gossip_mix_shifted(
        x, grid=top.axis_sizes, axis=0,
        shifts=[sh for sh, _ in per_axis[0]],
        weights=[w for _, w in per_axis[0]], lim=lim,
        nbr=bf16_round_trip(x)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 512), (3, 333)])
def test_delayed_mix_and_drip_bit_exact_on_card(shape):
    """The overlapped round's landing ``ops.delayed_mix_mat`` (x + dx,
    weights (1, 1)) and MT's drip (c + dc/p, weights (1, 1/p)) on the
    kernel layout: one launch each, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    k, rows = shape
    a, b = (torch.from_numpy(m.reshape(k, rows, LANE)).to(dev)
            for m in _mats(k * rows, 2, k * rows))
    b[0, 0, :4] = -0.0
    for fn, ws in ((lambda: ops.delayed_mix_mat(a, b), (1.0, 1.0)),
                   (lambda: ops.gossip_mix_mat((a, b), (1.0, 1.0 / 4)),
                    (1.0, 1.0 / 4))):
        before = gossip_mix.launches
        y = fn()
        torch.cuda.synchronize()
        assert gossip_mix.launches == before + 1
        want = gossip_mix_ref([a.reshape(-1, LANE), b.reshape(-1, LANE)], ws)
        assert _same_bits(y, want.reshape(a.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("ws", [(1.0, 1e-4), (1.0, 1.0, -1.0)])
@pytest.mark.parametrize("rows", [4096, 333])
def test_gossip_mix_tracking_weights_bit_exact_on_card(ws, rows):
    """MT-DSGDm's two tracking AXPYs on distinct matrices, ĝ = 1·g + λ·x
    and c + ĝ − ĝ_prev, at the main path's (4096, 1024) and at 333 rows:
    one launch, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    ins = [torch.from_numpy(a).to(dev) for a in _mats(rows, len(ws), rows)]
    before = gossip_mix.launches
    y = gossip_mix(ins, weights=ws)
    torch.cuda.synchronize()
    assert gossip_mix.launches == before + 1
    assert _same_bits(y, gossip_mix_ref(ins, ws))


@pytest.mark.cuda
def test_kernel_round_on_card_matches_tree_round():
    """One PD-SGDM round of ResNet-20 (width 4, K = 8 ring, batch 2) on the
    card: p momentum launches and one gossip launch, and the params within
    atol 1e-4 / rtol 1e-3 of the tree round, which launches no kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core import DenseComm, make_optimizer, ring
    from repro_torch.data.synthetic import ClassStreamCfg, class_batch
    from repro_torch.models.resnet import resnet20_init, resnet20_loss
    from repro_torch.train.trainer import SimTrainer
    K, P = 8, 4
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        init = resnet20_init(torch.Generator().manual_seed(0), width=4)
        params = {k: v.unsqueeze(0).repeat((K,) + (1,) * v.dim())
                  for k, v in init.items()}
        cfg = ClassStreamCfg(batch=2, n_workers=K)
        out, launches = {}, {}
        for use_kernel in (True, False):
            opt = make_optimizer("pd_sgdm", DenseComm(ring(K)), p=P, eta=0.1,
                                 mu=0.9, weight_decay=1e-4,
                                 use_kernel=use_kernel)
            before = (momentum_update.launches, gossip_mix.launches)
            out[use_kernel], _, _ = SimTrainer(resnet20_loss, opt).train(
                params, lambda t: class_batch(cfg, t), P)
            launches[use_kernel] = (momentum_update.launches - before[0],
                                    gossip_mix.launches - before[1])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = flags
    assert launches == {True: (P, 1), False: (0, 0)}
    for name, want in out[False].items():
        assert torch.allclose(out[True][name], want, rtol=1e-3, atol=1e-4), name


def _same_bits(a, b) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _codec_rows(rows, seed):
    """Random rows with the edge cases of the codecs: counts 0, partial and
    full, zero rows, −0.0 entries and QSGD rounding ties."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, LANE), dtype=np.float32)
    counts = np.full((rows, 1), float(LANE), np.float32)
    for r, n in ((1, 0), (2, 17), (3, 1), (rows - 1, 0)):
        x[r, n:] = 0.0
        counts[r] = n
    x[4] = 0.0
    x[5] = -0.0
    x[6, ::3] = -0.0
    x[7] = np.resize(np.arange(-6.5, 7.0, 1.0, dtype=np.float32), LANE)
    x[7, 0] = 7.0                      # norm 7 = s at levels 7: exact ties
    return x, counts


@pytest.mark.cuda
def test_codec_kernels_bit_exact_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    for rows in (4096, 333):
        x, counts = (torch.from_numpy(a).to(dev) for a in _codec_rows(rows,
                                                                       rows))
        before = (sign_pack.launches, sign_unpack.launches)
        got = sign_pack(x, counts)
        want = sign_pack_rows_ref(x, counts)
        assert all(_same_bits(a, b) for a, b in zip(got, want))
        y = sign_unpack(*got)
        torch.cuda.synchronize()
        assert _same_bits(y, sign_unpack_ref(*got))
        assert (sign_pack.launches, sign_unpack.launches) == \
            (before[0] + 1, before[1] + 1)
        for levels in (1, 7, 127):
            before = (qsgd_quant.launches, qsgd_dequant.launches)
            got = qsgd_quant(x, levels=levels)
            want = qsgd_rows_ref(x, levels)
            assert all(_same_bits(a, b) for a, b in zip(got, want))
            y = qsgd_dequant(*got, levels=levels)
            torch.cuda.synchronize()
            assert _same_bits(y, qsgd_rows_unpack_ref(*got, levels))
            assert (qsgd_quant.launches, qsgd_dequant.launches) == \
                (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError):
        sign_pack(x, counts.cpu())                # counts on another device


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sign", "qsgd"])
def test_cpd_kernel_round_on_card_matches_tree_round(kind):
    """One CPD-SGDM round of ResNet-20 (width 4, K = 8 ring, batch 2) on the
    card.  The kernel round launches p momentum kernels, one codec pack and
    one unpack and no gossip kernel; the tree round packs through the same
    codec kernels.  Params within atol 1e-4 / rtol 1e-3; x̂ too, except
    where the two consensus products put the drift on opposite sides of a
    sign or a QSGD tie, which moves x̂ by one quantum there (at most
    2·max|drift|) in a handful of elements."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core import (DenseComm, QSGDCompressor, SignCompressor,
                                  make_optimizer, ring)
    from repro_torch.data.synthetic import ClassStreamCfg, class_batch
    from repro_torch.models.resnet import resnet20_init, resnet20_loss
    from repro_torch.train.trainer import SimTrainer
    K, P = 8, 4
    comp = SignCompressor() if kind == "sign" else QSGDCompressor(levels=7)
    pack, unpack = ((sign_pack, sign_unpack) if kind == "sign"
                    else (qsgd_quant, qsgd_dequant))
    counters = (momentum_update, gossip_mix, pack, unpack)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        init = resnet20_init(torch.Generator().manual_seed(0), width=4)
        params = {k: v.unsqueeze(0).repeat((K,) + (1,) * v.dim())
                  for k, v in init.items()}
        cfg = ClassStreamCfg(batch=2, n_workers=K)
        out, launches = {}, {}
        for use_kernel in (True, False):
            opt = make_optimizer("cpd_sgdm", DenseComm(ring(K)), p=P, eta=0.1,
                                 mu=0.9, weight_decay=1e-4, gamma=0.4,
                                 compressor=comp, use_kernel=use_kernel)
            before = [f.launches for f in counters]
            got, state, _ = SimTrainer(resnet20_loss, opt).train(
                params, lambda t: class_batch(cfg, t), P)
            out[use_kernel] = (got, state["xhat"])
            launches[use_kernel] = tuple(f.launches - b
                                         for f, b in zip(counters, before))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    assert launches == {True: (P, 0, 1, 1), False: (0, 0, 1, 1)}
    (pk, hk), (pt, ht) = out[True], out[False]
    drift = max(float((pt[n] - params[n]).abs().max()) for n in pt)
    for name, want in pt.items():
        assert torch.allclose(pk[name], want, rtol=1e-3, atol=1e-4), name
        near = torch.isclose(hk[name], ht[name], rtol=1e-3, atol=1e-4)
        gap = (hk[name] - ht[name]).abs()
        assert int((~near).sum()) <= 8, name
        assert bool((gap[~near] <= 2 * drift).all()), name


def _topk_rows(rows, seed):
    """The codec edge cases plus top-k's own: rows quantized to a few
    values (ties everywhere), an all −0.0 row and −0.0 among the largest."""
    x, counts = _codec_rows(rows, seed)
    x[8] = np.round(x[8] * 2.0) / 2.0
    x[9] = np.sign(x[9])
    x[10, :200] = -0.0
    x[10, 200:] = 0.0
    x[11, :700] = 0.0
    x[11, 900:] = -0.0
    return x, counts


@pytest.mark.cuda
def test_topk_and_row_kernels_bit_exact_on_card():
    """topk_select/topk_scatter at W = 2, 11, 103, 128 and row_gather/
    row_scatter with a (K, S) lead and ragged counts, each against its
    plain version bit for bit (indices exact, f32 by bit pattern)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    for rows in (4096, 333):
        x, counts = (torch.from_numpy(a).to(dev)
                     for a in _topk_rows(rows, rows))
        for fraction in (0.001, 0.01, 0.1, 0.125):
            before = (topk_select.launches, topk_scatter.launches)
            idx, vals = topk_select(x, counts, fraction=fraction)
            want = topk_rows_ref(x, counts, fraction=fraction)
            assert _same_bits(idx, want[0]) and _same_bits(vals, want[1])
            y = topk_scatter(idx, vals)
            torch.cuda.synchronize()
            assert _same_bits(y, topk_rows_unpack_ref(idx, vals, LANE))
            assert (topk_select.launches, topk_scatter.launches) == \
                (before[0] + 1, before[1] + 1)
        idx, vals = topk_select(x, None, fraction=0.1)
        assert _same_bits(vals, topk_rows_ref(x, None, fraction=0.1)[1])
    rng = np.random.default_rng(7)
    for k, rows, s in ((4, 4096, 64), (3, 333, 5)):
        x = torch.from_numpy(rng.standard_normal((k, rows, LANE),
                                                 dtype=np.float32)).to(dev)
        x[:, 1] = -0.0
        counts = torch.full((k * rows, 1), float(LANE), device=dev)
        counts[1::7] = 17.0
        counts[2::11] = 0.0
        # distinct sorted rows per worker, the −0.0 row 1 among them
        idx = torch.from_numpy(np.stack([
            np.sort(np.append(rng.choice(np.arange(2, rows), s - 1,
                                         replace=False), 1))
            for _ in range(k)]).astype(np.int32)).to(dev)
        before = (row_gather.launches, row_scatter.launches)
        for c in (counts, None):
            g = row_gather(x, idx, c)
            assert _same_bits(g, row_gather_ref(x, idx, c))
        g[:, :, ::5] = -0.0
        y = row_scatter(idx, g, rows=rows)
        torch.cuda.synchronize()
        assert _same_bits(y, row_scatter_ref(idx, g, rows=rows))
        assert (row_gather.launches, row_scatter.launches) == \
            (before[0] + 2, before[1] + 1)
    with pytest.raises(ValueError):
        topk_select(x[0], None, fraction=0.2)        # W = 205 > MAX_WIDTH
    with pytest.raises(ValueError):
        row_gather(x, idx, counts.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("k,rows,s", [(1, 333, 1), (3, 333, 5), (8, 333, 65),
                                      (4, 4096, 1024)])
def test_row_gather_bit_exact_on_edge_shapes(k, rows, s):
    """The gather at its edge shapes (one row a block, as the main path's
    256 rows go) and at S = 1,024 (several rows a block), with counts 0,
    1, 17, 1023 and 1024 and without counts, NaN (with a payload), ±inf,
    −0.0 and a subnormal in kept lanes and repeated indices, against its
    plain version bit for bit; one launch a call; an index out of range
    gives a zero row."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(10 * k + s)
    special = np.array([0x7FC00123, 0x7F800000, -0x800000, -2 ** 31, 5],
                       np.int32).view(np.float32)
    x = rng.standard_normal((k, rows, LANE), dtype=np.float32)
    x[:, :, 3:8] = special
    x[:, :, LANE - 5:] = special
    counts = rng.choice(np.array([0, 1, 17, LANE - 1, LANE], np.float32),
                        (k * rows, 1))
    idx = rng.integers(0, rows, (k, s)).astype(np.int32)
    if s > 1:
        idx[:, -1] = idx[:, 0]
    x, counts, idx = (torch.from_numpy(a).to(dev) for a in (x, counts, idx))
    for c in (counts, None):
        before = row_gather.launches
        g = row_gather(x, idx, c)
        torch.cuda.synchronize()
        assert row_gather.launches == before + 1
        assert _same_bits(g, row_gather_ref(x, idx, c))
    bad = idx.clone()
    bad[0, 0] = -1
    bad[-1, -1] = rows
    for c in (counts, None):
        g = row_gather(x, bad, c)
        want = row_gather_ref(x, bad.clamp(0, rows - 1), c)
        want[0, 0] = 0.0
        want[-1, -1] = 0.0
        torch.cuda.synchronize()
        assert _same_bits(g, want)


def _topk_edge_rows(kind, width, seed, rows=256):
    """The radix select's hard rows (as tests/test_torch_topk.py builds
    them for the CPU): a run of 12 equal |x| across the W-th place,
    subnormals, ±inf and NaN, equal |x|; counts 1, 1023 and 0 on rows
    0-2."""
    rng = np.random.default_rng(seed)
    x = np.empty((rows, LANE), np.float32)
    for r in range(rows):
        if kind == "straddle":
            x[r] = rng.uniform(0.0, 0.5, LANE)
            cols = rng.permutation(LANE)
            big = max(width - 5, 0)
            x[r, cols[:big]] = 10.0 + np.arange(big)
            x[r, cols[big:big + 12]] = 5.0 * rng.choice([-1.0, 1.0], 12)
        elif kind == "subnormal":
            bits = (rng.integers(1, 1 << 12, LANE).astype(np.uint32)
                    | (rng.integers(0, 2, LANE).astype(np.uint32) << 31))
            x[r] = bits.view(np.float32)
        elif kind in ("inf", "nan"):
            x[r] = rng.standard_normal(LANE)
            n = r % 7
            x[r, rng.choice(LANE, n, replace=False)] = rng.choice(
                [-np.inf, np.inf] if kind == "inf" else [-np.nan, np.nan], n)
        else:
            x[r] = 0.75 * rng.choice([-1.0, 1.0], LANE)
    counts = np.full((rows, 1), float(LANE), np.float32)
    for r, n in ((0, 1), (1, LANE - 1), (2, 0)):
        x[r, n:] = 0.0
        counts[r] = n
    return x, counts


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["straddle", "subnormal", "inf", "nan",
                                  "equal"])
def test_topk_kernels_bit_exact_on_edge_rows(kind):
    """The radix select and the slot scatter on their hard rows at W = 2,
    11, 103 and 128, and the scatter on payloads that repeat a column
    (small integers: every order of the adds gives one sum), each against
    its plain version on the card bit for bit.  The plain scatter's
    atomicAdd flushes subnormals, and so does the kernel.  NaN rows go
    through the select only."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    for fraction in (0.001, 0.01, 0.1, 0.125):
        width = max(1, int(np.ceil(fraction * LANE)))
        x, counts = (torch.from_numpy(a).to(dev)
                     for a in _topk_edge_rows(kind, width, width))
        idx, vals = topk_select(x, counts, fraction=fraction)
        want = topk_rows_ref(x, counts, fraction=fraction)
        assert _same_bits(idx, want[0]) and _same_bits(vals, want[1])
        if kind != "nan":
            y = topk_scatter(idx, vals)
            assert _same_bits(y, topk_rows_unpack_ref(idx, vals, LANE))
        rng = np.random.default_rng(width)
        ri = rng.integers(0, LANE, (256, width)).astype(np.int32)
        ri[:, -1] = ri[:, 0]
        ri[::2, : width // 2] = ri[::2, width - width // 2:]
        rv = rng.integers(-8, 9, (256, width)).astype(np.float32)
        rv[1::3, 0] = -0.0
        ri, rv = torch.from_numpy(ri).to(dev), torch.from_numpy(rv).to(dev)
        y = topk_scatter(ri, rv)
        assert _same_bits(y, topk_rows_unpack_ref(ri, rv, LANE))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["topk", "sparse"])
def test_cpd_kernel_round_on_card_matches_per_leaf_round(kind):
    """One CPD-SGDM round on the card with the top-k wire (ResNet-20 width
    4, K = 8 ring, f = 0.1, γ = 0.2) or the sparse-rows wire (a 4096 × 64
    embedding table, K = 4 ring, 64 rows), the kernel round against the
    per-leaf codec round, which launches no codec kernel.  Params within
    atol 1e-4 / rtol 1e-3; x̂ too, except where the two consensus products
    move a near-tie of the selection, in a handful of elements (each by at
    most 2·max|drift|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core import (CPDSGDM, CPDSGDMConfig, DenseComm,
                                  SparseRowsCompressor, TopKCompressor, ring)
    from repro_torch.data.synthetic import (ClassStreamCfg, EmbedStreamCfg,
                                            class_batch, embed_batch)
    from repro_torch.models.resnet import resnet20_init, resnet20_loss
    from repro_torch.train.trainer import SimTrainer
    P = 4
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    if kind == "topk":
        K = 8
        cfg = CPDSGDMConfig(eta=0.1, mu=0.9, p=P, weight_decay=1e-4,
                            gamma=0.2)
        comp = TopKCompressor(fraction=0.1)
        pack, unpack = topk_select, topk_scatter
        init = resnet20_init(torch.Generator().manual_seed(0), width=4)
        params = {k: v.unsqueeze(0).repeat((K,) + (1,) * v.dim())
                  for k, v in init.items()}
        data = ClassStreamCfg(batch=2, n_workers=K)
    else:
        K = 4
        cfg = CPDSGDMConfig(eta=0.05, mu=0.9, p=P, gamma=0.4)
        comp = SparseRowsCompressor(max_rows=64)
        pack, unpack = row_gather, row_scatter
        gen = torch.Generator(device="cuda").manual_seed(1)
        params = {"table": torch.randn((K, 4096, 64), generator=gen,
                                       device="cuda") * 0.1}
        data = EmbedStreamCfg(n_rows=4096, dim=64, batch=64, n_workers=K)
        ids = torch.stack([embed_batch(data, t)["ids"] for t in range(P)])

        def grads_fn(p, batch):
            g = torch.zeros_like(p["table"])
            k = torch.arange(K, device="cuda")[:, None].expand_as(batch["ids"])
            g.index_put_((k, batch["ids"]), torch.tensor(0.01, device="cuda"),
                         accumulate=True)
            return torch.zeros((), device="cuda"), {"table": g}
    counters = (momentum_update, gossip_mix, pack, unpack)
    try:
        out, launches = {}, {}
        for use_kernel in (True, False):
            opt = CPDSGDM(dataclasses.replace(cfg, use_kernel=use_kernel),
                          DenseComm(ring(K)), comp)
            if not use_kernel:
                opt._kernel_wire = lambda: False    # the per-leaf codec
            before = [f.launches for f in counters]
            if kind == "topk":
                got, state, _ = SimTrainer(resnet20_loss, opt).train(
                    params, lambda t: class_batch(data, t), P)
            else:
                got, state, _ = opt.round(opt.init(params), params, grads_fn,
                                          {"ids": ids})
            out[use_kernel] = (got, state["xhat"])
            launches[use_kernel] = tuple(f.launches - b
                                         for f, b in zip(counters, before))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    assert launches == {True: (P, 0, 1, 1), False: (0, 0, 0, 0)}
    (pk, hk), (pt, ht) = out[True], out[False]
    drift = max(float((pt[n] - params[n]).abs().max()) for n in pt)
    for name, want in pt.items():
        assert torch.allclose(pk[name], want, rtol=1e-3, atol=1e-4), name
        near = torch.isclose(hk[name], ht[name], rtol=1e-3, atol=1e-4)
        gap = (hk[name] - ht[name]).abs()
        assert int((~near).sum()) <= 8, name
        assert bool((gap[~near] <= 2 * drift).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mt_dsgdm", "qg_dsgdm"])
def test_tracking_kernel_round_on_card_matches_cpu_round(name):
    """One MT-DSGDm and one QG-DSGDm kernel round on the card (p = 4, K = 4
    ring, weight decay 1e-4) over a multi-leaf tree whose leaves end
    mid-row, against the plain round on the CPU from the same inputs:
    params, m and the tracking state within atol 2e-5 (the tracking tests'
    bar).  MT launches 2 mixes and 1 momentum update a step and 2 mixes a
    round (x and c); QG 1 momentum update a step and 1 mix a round."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core import DenseComm, make_optimizer, ring
    k, p = 4, 4
    rng = np.random.default_rng(0)
    leaves = {"w1": rng.standard_normal((k, 33, 65), dtype=np.float32),
              "w2": rng.standard_normal((k, 7), dtype=np.float32),
              "w3": rng.standard_normal((k, 2, 5, 11), dtype=np.float32)}
    targets = rng.standard_normal((p, k), dtype=np.float32)

    def grads_fn(pp, batch):
        def g(x):
            return x - batch["t"].reshape((k,) + (1,) * (x.dim() - 1))
        return torch.zeros((), device=batch["t"].device), \
            {n: g(x) for n, x in pp.items()}

    out, launches = {}, {}
    for dev in ("cuda", "cpu"):
        opt = make_optimizer(name, DenseComm(ring(k), device=dev), eta=0.05,
                             mu=0.9, p=p, weight_decay=1e-4,
                             use_kernel=dev == "cuda")
        params = {n: torch.from_numpy(v).to(dev) for n, v in leaves.items()}
        before = (momentum_update.launches, gossip_mix.launches)
        got, state, _ = opt.round(opt.init(params), params, grads_fn,
                                  {"t": torch.from_numpy(targets).to(dev)})
        torch.cuda.synchronize()
        launches[dev] = (momentum_update.launches - before[0],
                         gossip_mix.launches - before[1])
        out[dev] = {"x": got, **{key: state[key] for key in
                                 ("m", "c", "g_prev", "xprev")
                                 if key in state}}
    mixes = 2 * p + 2 if name == "mt_dsgdm" else 1
    assert launches == {"cuda": (p, mixes), "cpu": (0, 0)}
    assert out["cuda"].keys() == out["cpu"].keys()
    for key, tree in out["cpu"].items():
        for n, want in tree.items():
            np.testing.assert_allclose(out["cuda"][key][n].cpu().numpy(),
                                       want.numpy(), atol=2e-5,
                                       err_msg=f"{key}/{n}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cpd_sgdm", "mt_dsgdm"])
def test_churn_rounds_on_card_match_cpu_rounds(name):
    """CPD-SGDM and MT-DSGDm with the sign wire under the churn script of
    ``chip_smoke.py`` (K = 8 ring; round 0 kills worker 3, round 1 also
    stalls worker 6, round 2 revives 3), its three rounds on the card on
    the kernel layout against the plain rounds on the CPU from the same
    inputs (p = 4, a multi-leaf tree whose leaves end mid-row).  CPD packs
    on the tree at the round boundary through the sign kernels (1 pack and
    1 unpack a round), MT mixes its quantized correction through the
    per-leaf codec (no sign launch).  Params, m and c within atol 2e-5;
    x̂ too, but for elements whose drift sits within rounding of a sign
    flip (at most 8, each by at most 2·max|drift|).  On the card, x̂ of the
    dead worker 3 and of its neighbours 2 and 4, which cannot commit, stays
    bit for bit at x₀ through rounds 0 and 1; MT's straggler 6 keeps its
    raw c in round 1, not its own Q(c), whose 2,145 entries of ``w1`` (3
    sign blocks) would take at most 3 magnitudes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core import (DenseComm, SignCompressor, make_optimizer,
                                  membership_from_events, ring)
    k, p = 8, 4
    ms = membership_from_events(k, 3, [(0, "kill", 3), (1, "straggle", 6),
                                       (2, "revive", 3)])
    rng = np.random.default_rng(2)
    init = rng.standard_normal((1, 33, 65), dtype=np.float32)
    leaves = {"w1": np.repeat(init, k, axis=0),
              "w2": rng.standard_normal((k, 7), dtype=np.float32)}
    targets = rng.standard_normal((3, p, k), dtype=np.float32)

    def grads_fn(pp, batch):
        def g(x):
            return x - batch["t"].reshape((k,) + (1,) * (x.dim() - 1))
        return torch.zeros((), device=batch["t"].device), \
            {n: g(x) for n, x in pp.items()}

    out, launches, frozen, c6 = {}, {}, [], None
    for dev in ("cuda", "cpu"):
        kw = ({"gamma": 0.4} if name == "cpd_sgdm" else
              {"compressor": SignCompressor()})
        opt = make_optimizer(name, DenseComm(ring(k), membership=ms,
                                             device=dev),
                             eta=0.05, mu=0.9, p=p, weight_decay=1e-4,
                             use_kernel=dev == "cuda", **kw)
        params = {n: torch.from_numpy(v).to(dev) for n, v in leaves.items()}
        state = opt.init(params)
        counters = (momentum_update, gossip_mix, sign_pack, sign_unpack)
        before = [f.launches for f in counters]
        for r in range(3):
            params, state, _ = opt.round(
                state, params, grads_fn,
                {"t": torch.from_numpy(targets[r]).to(dev)})
            if dev == "cuda" and name == "cpd_sgdm" and r < 2:
                frozen.append(all(torch.equal(state["xhat"]["w1"][w],
                                              torch.from_numpy(init[0])
                                              .to(dev)) for w in (2, 3, 4)))
            if dev == "cuda" and name == "mt_dsgdm" and r == 1:
                c6 = state["c"]["w1"][6].clone()
        torch.cuda.synchronize()
        launches[dev] = tuple(f.launches - b for f, b in zip(counters,
                                                            before))
        out[dev] = {"x": params, **{key: state[key] for key in
                                    ("m", "c", "xhat") if key in state}}
    codec = 3 if name == "cpd_sgdm" else 0
    mixes = 0 if name == "cpd_sgdm" else 2 * 3 * p
    assert launches == {"cuda": (3 * p, mixes, codec, codec),
                        "cpu": (0, 0, 0, 0)}
    if name == "cpd_sgdm":
        assert frozen == [True, True]
    else:
        assert torch.unique(c6.abs()).numel() > 3
    drift = max(float((out["cpu"]["x"][n] - torch.from_numpy(v)).abs().max())
                for n, v in leaves.items())
    for key, tree in out["cpu"].items():
        for n, want in tree.items():
            got = out["cuda"][key][n].cpu()
            if key != "xhat":
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           atol=2e-5, err_msg=f"{key}/{n}")
                continue
            far = ~torch.isclose(got, want, rtol=1e-3, atol=1e-4)
            assert int(far.sum()) <= 8, n
            assert bool(((got - want).abs()[far] <= 2 * drift).all()), n


@pytest.mark.cuda
def test_tiny_lm_loss_and_grads_on_card_match_cpu():
    """The quickstart's tiny LM: loss and gradients on the card, TF32 off,
    against the same on the CPU from the same params and batch (the
    matmuls and reductions sum in other orders: rtol 1e-5 on the loss,
    each gradient leaf within 1e-4 of the largest gradient's max norm)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.configs.base import ModelCfg
    from repro_torch.data.synthetic import LMStreamCfg, lm_batch
    from repro_torch.models import make_model
    model = make_model(ModelCfg(name="tiny-lm", arch_type="dense",
                                n_layers=2, d_model=64, n_heads=4,
                                n_kv_heads=2, d_ff=128, vocab=256))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {k: v[0] for k, v in lm_batch(
        LMStreamCfg(vocab=256, seq_len=32, batch=4, n_workers=1), 0,
        device="cpu").items()}
    fn = torch.func.grad_and_value(lambda p, b: model.loss(p, b)[0])
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g_cpu, l_cpu = fn(params, batch)
        g_gpu, l_gpu = fn({k: v.cuda() for k, v in params.items()},
                          {k: v.cuda() for k, v in batch.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    np.testing.assert_allclose(float(l_gpu), float(l_cpu), rtol=1e-5)
    scale = max(float(v.abs().max()) for v in g_cpu.values())
    for k, v in g_cpu.items():
        np.testing.assert_allclose(g_gpu[k].cpu().numpy(), v.numpy(),
                                   atol=1e-4 * scale, rtol=0)


@pytest.mark.cuda
def test_kernels_bit_exact_past_two_to_the_31_elements():
    """``momentum_update`` and ``gossip_mix`` (distinct matrices, and the
    shifted views of an 8-worker ring) on (2,150,400, 1024) f32 operands:
    2.2e9 elements, 8.8 GB a matrix, past 2³² bytes and past 2³¹
    elements, held bit for bit against their plain versions row block by
    row block (about 45 GB on the card at the peak)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rows, block, k = 2_150_400, 1 << 17, 8
    gen = torch.Generator(device="cuda").manual_seed(31)
    x, m, g = (torch.randn((rows, LANE), generator=gen, device="cuda")
               for _ in range(3))
    assert x.numel() > 2 ** 31 and x.numel() * 4 > 2 ** 32
    lr = torch.tensor(0.25, device="cuda")
    xo, mo = momentum_update(x, m, g, lr, mu=0.9, wd=1e-4)
    for r in range(0, rows, block):
        sl = slice(r, r + block)
        wx, wm = momentum_update_ref(x[sl], m[sl], g[sl], lr, mu=0.9,
                                     wd=1e-4)
        assert torch.equal(xo[sl], wx) and torch.equal(mo[sl], wm), r
    del xo, mo
    ws = (1 / 3, 1 / 3, 1 / 3)
    y = gossip_mix([x, m, g], weights=ws)
    for r in range(0, rows, block):
        sl = slice(r, r + block)
        assert torch.equal(y[sl], gossip_mix_ref([x[sl], m[sl], g[sl]],
                                                 ws)), r
    del y, m, g
    x3 = x.view(k, rows // k, LANE)
    shifts = (0, 1, -1)
    y = gossip_mix_shifted(x3, grid=(k,), axis=0, shifts=shifts, weights=ws)
    per = rows // k
    for w in range(k):
        for r in range(0, per, block):
            sl = slice(r, r + block)
            views = [x3[(w + sh) % k, sl] for sh in shifts]
            assert torch.equal(y[w, sl], gossip_mix_ref(views, ws)), (w, r)


@pytest.mark.cuda
def test_momentum_update_inplace_bit_exact_past_two_to_the_31_elements():
    """``momentum_update(..., inplace=True)`` on a matrix (the C entry
    ``momentum_update_leaves_f32`` with the one-entry table)
    writes over x and m exactly what the out-of-place launch returns, and
    so its plain version: at the main path's (4096, 1024) and a ragged 333
    rows, plain and Nesterov, and on (2,150,400, 1024) f32 operands, past
    2³¹ elements and 2³² bytes, row block by row block (about 45 GB on the
    card at the peak).  Each form counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    lr = torch.tensor(0.25, device=dev)
    for rows in (4096, 333):
        x, m, g = (torch.from_numpy(a).to(dev) for a in _mats(rows, 3, rows))
        for nesterov in (False, True):
            want = momentum_update_ref(x, m, g, lr, mu=0.9, wd=1e-4,
                                       nesterov=nesterov)
            xi, mi = x.clone(), m.clone()
            before = momentum_update.launches
            got = momentum_update(xi, mi, g, lr, mu=0.9, wd=1e-4,
                                  nesterov=nesterov, inplace=True)
            torch.cuda.synchronize()
            assert momentum_update.launches == before + 1
            assert got[0] is xi and got[1] is mi
            assert torch.equal(xi, want[0]) and torch.equal(mi, want[1])
    rows, block = 2_150_400, 1 << 17
    gen = torch.Generator(device="cuda").manual_seed(32)
    x, m, g = (torch.randn((rows, LANE), generator=gen, device="cuda")
               for _ in range(3))
    assert x.numel() > 2 ** 31 and x.numel() * 4 > 2 ** 32
    xo, mo = momentum_update(x, m, g, lr, mu=0.9, wd=1e-4)
    momentum_update(x, m, g, lr, mu=0.9, wd=1e-4, inplace=True)
    torch.cuda.synchronize()
    for r in range(0, rows, block):
        sl = slice(r, r + block)
        assert torch.equal(x[sl], xo[sl]) and torch.equal(m[sl], mo[sl]), r


def _full_width_tree(arch, k, gen):
    """Random worker-stacked leaves of ``arch`` at its published widths,
    one layer, f32, and their ``KernelPlan``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.ops import KernelPlan
    from repro_torch.models import make_model
    model = make_model(dataclasses.replace(
        get_config(arch).model, n_layers=1, param_dtype="float32",
        compute_dtype="float32"))
    tree = {n: torch.randn((k,) + tuple(s), generator=gen, device="cuda")
            for n, s in model.param_shapes().items()}
    return tree, KernelPlan.for_tree(tree, worker_dim=True)


def _leaf_counters():
    return (momentum_update.launches, momentum_update.leaf_reads,
            momentum_update.leaf_copies)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-1.3b"])
def test_momentum_leaf_table_bit_exact_at_full_width_leaf_shapes(arch):
    """The in-place launch reading the gradient's leaves where they lie
    (``ops.Leaves``, PD-SGDM's local step) writes over x and m exactly
    what flattening the gradient and launching on the matrix writes, at
    the model's full-width leaf shapes, K = 8 (OLMo-1B: 8 leaves, every
    one whole rows; Mamba2-1.3B: 12, some ending mid-row, and an
    alignment tail past ``used_rows``), plain and Nesterov.  One leaf is
    handed over transposed (not contiguous): it is copied first and
    counted in ``leaf_copies``, the rest in ``leaf_reads``; one launch a
    step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import ops as kops
    gen = torch.Generator(device="cuda").manual_seed(33)
    tree, plan = _full_width_tree(arch, 8, gen)
    name = next(n for n in plan.names
                if tree[n].dim() == 3 and min(tree[n].shape[1:]) > 1)
    tree[name] = tree[name].transpose(1, 2).contiguous().transpose(1, 2)
    assert not tree[name].is_contiguous()
    lr = torch.tensor(0.25, device="cuda")
    for nesterov in (False, True):
        x, m = (torch.randn((8, plan.rows, LANE), generator=gen,
                            device="cuda") for _ in range(2))
        xm, mm = x.clone(), m.clone()
        g = plan.flatten(tree)
        kops.momentum_update_mat(xm, mm, g, mu=0.9, lr=lr, weight_decay=1e-4,
                                 nesterov=nesterov, inplace=True)
        del g
        before = _leaf_counters()
        got = kops.momentum_update_mat(x, m, kops.Leaves(plan, tree), mu=0.9,
                                       lr=lr, weight_decay=1e-4,
                                       nesterov=nesterov, inplace=True)
        torch.cuda.synchronize()
        assert got[0] is x and got[1] is m
        n = len(plan.names)
        assert tuple(a - b for a, b in zip(_leaf_counters(), before)) == (
            1, n - 1, 1)
        assert _same_bits(x, xm) and _same_bits(m, mm), (arch, nesterov)
        del x, m, xm, mm


@pytest.mark.cuda
@pytest.mark.parametrize("n_leaves", [64, 65])
def test_momentum_leaf_table_past_one_struct_bit_exact(n_leaves):
    """One launch's table holds 64 leaves: a tree of 64 is read through
    it, a tree of 65 is flattened first (no leaf read), and
    ``momentum_update`` refuses a table of 65; either way one launch a
    step, bit for bit what the matrix launch writes: ragged leaves (sizes
    4 to 5,000, some not a multiple of 4 and so copied first), K = 3,
    plain and Nesterov.  A table that starts past row 0 reads 0 there, as
    its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.momentum import leaf_table
    from repro_torch.kernels.ref import leaf_matrix_ref
    rng = np.random.default_rng(n_leaves)
    sizes = rng.integers(4, 5000, size=n_leaves)
    sizes[::7] = 4 * (sizes[::7] // 4)
    gen = torch.Generator(device="cuda").manual_seed(n_leaves)
    tree = {f"l{j:03d}": torch.randn((3, int(s)), generator=gen,
                                      device="cuda")
            for j, s in enumerate(sizes)}
    plan = kops.KernelPlan.for_tree(tree, worker_dim=True)
    lr = torch.tensor(0.05, device="cuda")
    for nesterov in (False, True):
        x, m = (torch.randn((3, plan.rows, LANE), generator=gen,
                            device="cuda") for _ in range(2))
        xm, mm = x.clone(), m.clone()
        kops.momentum_update_mat(xm, mm, plan.flatten(tree), mu=0.9, lr=lr,
                                 weight_decay=1e-4, nesterov=nesterov,
                                 inplace=True)
        before = _leaf_counters()
        kops.momentum_update_mat(x, m, kops.Leaves(plan, tree), mu=0.9,
                                 lr=lr, weight_decay=1e-4, nesterov=nesterov,
                                 inplace=True)
        torch.cuda.synchronize()
        copies = int((sizes % 4 != 0).sum()) if n_leaves <= 64 else 0
        reads = n_leaves - copies if n_leaves <= 64 else 0
        assert tuple(a - b for a, b in zip(_leaf_counters(), before)) == (
            1, reads, copies)
        assert _same_bits(x, xm) and _same_bits(m, mm), nesterov
    if n_leaves > 64:
        with pytest.raises(ValueError, match="more than one launch holds"):
            momentum_update(x.view(-1, LANE), m.view(-1, LANE),
                            plan.leaf_table(tree), lr, mu=0.9, inplace=True)
    # rows before the table's first leaf read 0
    leaves = [torch.randn((2, 3000), generator=gen, device="cuda")
              for _ in range(2)]
    table = leaf_table(leaves, (5, 9), workers=2, rows=16)
    x, m = (torch.randn((32, LANE), generator=gen, device="cuda")
            for _ in range(2))
    want = momentum_update(x, m, leaf_matrix_ref(table).view(-1, LANE), lr,
                           mu=0.9, wd=1e-4)
    momentum_update(x, m, table, lr, mu=0.9, wd=1e-4, inplace=True)
    torch.cuda.synchronize()
    assert _same_bits(x, want[0]) and _same_bits(m, want[1])
