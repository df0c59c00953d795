"""The port's kernel wrappers against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version.  It is held against
the JAX oracle in ``repro.kernels.ref`` (eager jnp, one rounded op at a
time) bit for bit, and against the Pallas kernel in interpret mode, as
tests/test_kernels.py runs it, to 1 ulp per term: XLA on the CPU contracts
``μ·m + g`` and ``acc + w·x`` into FMAs, which the port never does.  Under
cancellation that gap is large relative to the result (measured: 48,155
ulps of m' where μ·m ≈ −g), so it is measured in ulps of the terms: of the
largest operand per mul-add XLA may contract for momentum (measured gaps:
m' 1 ulp, or 2 with weight decay; x' at most 2), of Σ|wᵢ·xᵢ| per added term
for the mix (measured 1, 2, 2 and 3 ulps at n = 2, 3, 5 and 8).  The CUDA
kernels themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as r_ops  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402
from repro.kernels.gossip_mix import gossip_mix as r_gossip_mix  # noqa: E402
from repro.kernels.momentum import momentum_update as r_momentum  # noqa: E402
from repro_torch.kernels import LANE, build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.core import DenseComm, exponential, ring, torus  # noqa: E402
from repro_torch.kernels.gossip_mix import (gossip_mix,  # noqa: E402
                                            gossip_mix_shifted)
from repro_torch.kernels.ref import (gossip_mix_ref,  # noqa: E402
                                     gossip_shift_ref)
from repro_torch.kernels.momentum import momentum_update  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ulp_gap(ours, theirs, scale) -> float:
    """Largest elementwise |ours − theirs| in f32 ulps of ``scale``."""
    ours = np.asarray(ours, np.float32)
    theirs = np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape
    scale = np.maximum(np.abs(np.asarray(scale, np.float32)),
                       np.maximum(np.abs(ours), np.abs(theirs)))
    return float(np.max(np.abs(ours.astype(np.float64) - theirs)
                        / np.spacing(scale)))


def _mats(seed, n, rows):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, LANE), dtype=np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("rows", [256, 512])
@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_matches_pallas_kernel(rows, wd, nesterov):
    x, m, g = _mats(rows + int(nesterov), 3, rows)
    lr = 0.05
    before = momentum_update.launches
    xn, mn = momentum_update(torch.from_numpy(x), torch.from_numpy(m),
                             torch.from_numpy(g), torch.tensor(lr),
                             mu=0.9, wd=wd, nesterov=nesterov)
    assert momentum_update.launches == before      # CPU: plain version
    xk, mk = r_momentum(jnp.asarray(x), jnp.asarray(m), jnp.asarray(g), lr,
                        mu=0.9, wd=wd, nesterov=nesterov, interpret=True)
    xr, mr = r_ref.momentum_update_ref(jnp.asarray(x), jnp.asarray(m),
                                       jnp.asarray(g), jnp.float32(lr),
                                       mu=0.9, wd=wd, nesterov=nesterov)
    np.testing.assert_array_equal(xn.numpy(), np.asarray(xr))
    np.testing.assert_array_equal(mn.numpy(), np.asarray(mr))
    largest = np.maximum(np.maximum(np.abs(x), np.abs(m)), np.abs(g))
    fmas_m = 1 + (wd != 0.0)                  # g + wd·x, μ·m + g'
    fmas_x = fmas_m + 1 + nesterov            # g' + μ·m', x − lr·d
    assert ulp_gap(mn.numpy(), mk, largest) <= fmas_m
    assert ulp_gap(xn.numpy(), xk, largest) <= fmas_x


@pytest.mark.parametrize("n", [1, 2, 3, 5, 9, 17, 33])
def test_gossip_mix_matches_pallas_kernel(n):
    """Bit for bit against the reference's left-to-right sum, and within
    n − 1 ulps of the Pallas kernel in interpret mode, where XLA may fuse a
    product and a sum.  Past 8 inputs the wrapper chains launches (on the
    CPU, plain versions), each later one taking the partial sum with
    weight 1.0: the equality holds through the chain."""
    xs = _mats(10 + n, n, 256)
    weights = tuple(float(w) for w in np.linspace(0.1, 0.5, n))
    before = gossip_mix.launches
    y = gossip_mix([torch.from_numpy(x) for x in xs], weights=weights)
    assert gossip_mix.launches == before
    yk = r_gossip_mix(tuple(jnp.asarray(x) for x in xs), weights=weights,
                      interpret=True)
    yr = r_ref.gossip_mix_ref([jnp.asarray(x) for x in xs], weights)
    np.testing.assert_array_equal(y.numpy(), np.asarray(yr))
    magnitude = sum(np.abs(np.float32(w) * x) for w, x in zip(weights, xs))
    assert ulp_gap(y.numpy(), yk, magnitude) <= max(n - 1, 0)


@pytest.mark.parametrize("graph,axis", [("ring", 0), ("torus", 0),
                                        ("torus", 1), ("exp16", 0)])
@pytest.mark.parametrize("lim", [5, 16])
@pytest.mark.parametrize("signs", ["ring", "negative"])
def test_gossip_shift_ref_is_the_roll_pad_composition(graph, axis, lim,
                                                      signs):
    """The plain version of the shifted-view mix is the composition it
    replaces on the kernel path, bit for bit (signs of zero included):
    each neighbour view cut to the wire extent, rolled over the worker
    grid by ``DenseComm._roll``, re-padded with zero rows, then
    ``gossip_mix_ref`` in ``shifts`` order; the self view uncut.  −0.0 in
    the self view meets the padded neighbour rows' +0.0 there (weights of
    the graph, and weights that make each zero product −0.0).  The
    wrapper, on a CPU tensor, runs exactly that and counts no launch."""
    top = {"ring": ring(8), "torus": torus((2, 4)),
           "exp16": exponential(16)}[graph]
    comm = DenseComm(top, device="cpu")
    views = [(sh, w) for (ax, sh, w) in top.shifts if ax == axis]
    shifts = tuple(sh for sh, _ in views)
    ws = tuple(w if signs == "ring" or sh == 0 else -w for sh, w in views)
    rows = 16
    rng = np.random.default_rng(len(shifts) + lim)
    x = torch.from_numpy(rng.standard_normal((top.n_workers, rows, LANE),
                                             dtype=np.float32))
    x[:, lim:, :4] = -0.0
    want = gossip_mix_ref(
        [x if sh == 0 else torch.nn.functional.pad(
            comm._roll(x[:, :lim], axis, sh), (0, 0, 0, rows - lim))
         for sh in shifts], ws)
    got = gossip_shift_ref(x, shifts, ws, grid=top.axis_sizes, axis=axis,
                           lim=lim)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if lim < rows:
        zero = want[:, lim:, :4]
        assert bool((zero == 0).all())
        assert bool(torch.signbit(zero).all()) == (signs == "negative")
    before = gossip_mix.launches
    y = gossip_mix_shifted(x, grid=top.axis_sizes, axis=axis, shifts=shifts,
                           weights=ws, lim=lim)
    assert gossip_mix.launches == before
    assert torch.equal(y.view(torch.int32), want.view(torch.int32))


def test_gossip_mix_shifted_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((8, 16, LANE))
    ok = dict(grid=(8,), axis=0, shifts=(0, 1, -1), weights=(0.5, 0.25, 0.25))
    assert gossip_mix_shifted(x, **ok).shape == x.shape
    with pytest.raises(ValueError):                 # grid is not K
        gossip_mix_shifted(x, **{**ok, "grid": (2, 2)})
    with pytest.raises(ValueError):                 # no such axis
        gossip_mix_shifted(x, **{**ok, "axis": 1})
    with pytest.raises(ValueError):                 # a weight short
        gossip_mix_shifted(x, **{**ok, "weights": (0.5, 0.5)})
    with pytest.raises(ValueError):                 # no views
        gossip_mix_shifted(x, **{**ok, "shifts": (), "weights": ()})
    with pytest.raises(ValueError):                 # no worker dim
        gossip_mix_shifted(x[0], **ok)
    with pytest.raises(ValueError):                 # not contiguous
        gossip_mix_shifted(x.transpose(0, 1).contiguous().transpose(0, 1),
                           **ok)
    with pytest.raises(TypeError):
        gossip_mix_shifted(x.double(), **ok)
    with pytest.raises(ValueError):
        gossip_mix_shifted(x, lim=-1, **ok)


def test_mat_wrappers_fold_worker_dims():
    """(K, rows, 1024) operands run as one (K·rows, 1024) call, as the
    reference's ``_rows2d`` does."""
    x, m, g = (a.reshape(2, 256, LANE) for a in _mats(7, 3, 512))
    lr = torch.tensor(0.1)
    xn, mn = ops.momentum_update_mat(torch.from_numpy(x), torch.from_numpy(m),
                                     torch.from_numpy(g), mu=0.9, lr=lr,
                                     weight_decay=1e-4)
    xr, mr = r_ops.momentum_update_mat(jnp.asarray(x), jnp.asarray(m),
                                       jnp.asarray(g), mu=0.9, lr=0.1,
                                       weight_decay=1e-4, interpret=True)
    assert xn.shape == (2, 256, LANE)
    largest = np.maximum(np.maximum(np.abs(x), np.abs(m)), np.abs(g))
    assert ulp_gap(mn.numpy(), mr, largest) <= 2      # as above, with wd
    assert ulp_gap(xn.numpy(), xr, largest) <= 3
    d = ops.delayed_mix_mat(torch.from_numpy(x), torch.from_numpy(g))
    dr = r_ops.delayed_mix_mat(jnp.asarray(x), jnp.asarray(g), interpret=True)
    np.testing.assert_array_equal(d.numpy(), np.asarray(dr))   # x + g: exact


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((256, LANE))
    lr = torch.tensor(0.1)
    with pytest.raises(TypeError):
        momentum_update(x.double(), x, x, lr, mu=0.9)
    with pytest.raises(ValueError):
        momentum_update(torch.zeros((256, LANE // 2)), x, x, lr, mu=0.9)
    with pytest.raises(ValueError):
        momentum_update(x, torch.zeros((512, LANE)), x, lr, mu=0.9)
    with pytest.raises(ValueError):
        momentum_update(x, x, torch.zeros((LANE, 256)).t(), lr, mu=0.9)
    with pytest.raises(TypeError):
        momentum_update(x, x, x, 0.1, mu=0.9)
    with pytest.raises(TypeError):
        momentum_update(x, x, x, lr.double(), mu=0.9)
    with pytest.raises(ValueError):
        gossip_mix([], weights=())
    with pytest.raises(ValueError):
        gossip_mix([x] * 9, weights=(0.1,) * 8)
    with pytest.raises(ValueError):
        gossip_mix([x, x], weights=(0.5,))
    with pytest.raises(TypeError):
        gossip_mix([x, x.half()], weights=(0.5, 0.5))


def test_kernel_sources_and_build_dir():
    """Every kernel has a hand-written source that pins its rounding and
    names the TPU kernel it replaces; the build lands in an ignored dir.
    The row gather and scatter multiply nothing (the scatter's one add is
    pinned), so only they lack ``__fmul_rn``."""
    assert set(build.SOURCES) >= {"momentum", "gossip_mix", "sign_compress",
                                  "qsgd_quant", "topk_select", "row_gather"}
    for name in build.SOURCES:
        src = (build.CSRC / f"{name}.cu").read_text()
        assert "__fadd_rn" in src
        assert "__fmul_rn" in src or name == "row_gather"
        assert f"src/repro/kernels/{name}.py" in src
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    rel = os.path.relpath(build.BUILD_DIR, REPO)
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = {line.strip().rstrip("/") for line in f}
    assert rel in ignored
