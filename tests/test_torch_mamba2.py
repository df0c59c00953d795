"""The port's Mamba-2 SSD mixer (``repro_torch.models.mamba2``) against the
reference's, from the same numpy params and inputs, and against a plain
sequential recurrence.

Params come from the reference's ``mamba2_init`` (an exact copy through
numpy), the inputs from a seeded numpy draw.  The mixer is smooth, so the
bars are f32 bars: XLA:CPU and PyTorch sum the matmuls, the cumsum and
the norms in other orders, a few ulps each.

* outputs against the reference: atol 1e-5, rtol 1e-5, as
  ``tests/test_torch_models.py`` holds the layers;
* the chunked SSD against the sequential scan ``S ← S·exp(dt·A) +
  dt·B⊗x``, ``y = C·S + D·x`` (the same conv, gate and projections around
  it), both f32: max |Δy| within 1e-5 of max |y| (the two sum the decays
  in other orders);
* gradients: each leaf within 1e-5 of the largest gradient's max norm;
  ``softplus`` differs from ``jax.nn.softplus`` only above 20, by f32
  rounding (``F.softplus`` returns its input there).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as r_smoke  # noqa: E402
from repro.kernels.ops import KernelPlan as RPlan  # noqa: E402
from repro.models import make_model as r_make_model  # noqa: E402
from repro.models import mamba2 as r_mamba  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels.ops import KernelPlan  # noqa: E402
from repro_torch.models import make_model, mamba2  # noqa: E402
from repro_torch.models.layers import dense, rmsnorm  # noqa: E402

ATOL = RTOL = 1e-5
GRAD_FRAC = 1e-5
SEQ_FRAC = 1e-5
CHUNK = 8
DIMS = dict(d_model=32, d_state=8, headdim=8, expand=2, chunk=CHUNK)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensor ops (the suite
    runs several test processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**kw):
    return (r_mamba.Mamba2Cfg(**dict(DIMS, **kw)),
            mamba2.Mamba2Cfg(**dict(DIMS, **kw)))


def _params(rcfg, seed=0):
    p = jax.tree_util.tree_map(
        np.array, r_mamba.mamba2_init(jax.random.PRNGKey(seed), rcfg,
                                      jnp.float32))
    rng = np.random.default_rng(seed + 100)   # non-trivial conv_b, dt_bias,
    for k in ("conv_b", "dt_bias", "D"):      # D and norm, so each is held
        p[k] = p[k] + 0.3 * rng.standard_normal(p[k].shape,
                                                dtype=np.float32)
    p["norm"]["scale"] = 1.0 + 0.3 * rng.standard_normal(
        p["norm"]["scale"].shape, dtype=np.float32)
    return p


def _t(tree):
    return ({k: _t(v) for k, v in tree.items()} if isinstance(tree, dict)
            else torch.from_numpy(np.array(tree)))


def _u(shape, seed=1):
    return 0.5 * np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
@pytest.mark.parametrize("groups", [1, 2])
def test_mamba2_apply_matches_reference(n_chunks, groups):
    """1, 2 and 4 chunks (the recurrence across chunks runs 0, 1 and 3
    times), one and two B/C groups."""
    rcfg, cfg = _cfgs(n_groups=groups)
    p = _params(rcfg)
    u = _u((2, CHUNK * n_chunks, 32), seed=n_chunks)
    want = r_mamba.mamba2_apply(p, u, rcfg)
    got = mamba2.mamba2_apply(_t(p), torch.from_numpy(u), cfg)
    assert got.shape == u.shape and got.dtype == torch.float32
    _close(got, want)


def _sequential(p, u, cfg):
    """The mixer with its SSD as the plain scan over positions, in f32:
    ``S ← S·exp(dt·A) + dt·B⊗x``, ``y = C·S + D·x``; the same conv, gate,
    norm and projections as the chunked form."""
    f32 = torch.float32
    bsz, s, _ = u.shape
    z, xBC, dt_raw = mamba2._split_zxbcdt(cfg, dense(p["in_proj"], u))
    xBC = mamba2._causal_conv(xBC, p["conv_w"], p["conv_b"])
    x, B, C = mamba2._split_xbc(cfg, xBC, bsz, s)
    dt = torch.nn.functional.softplus(dt_raw.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    S = torch.zeros((bsz, cfg.n_heads, cfg.d_state, cfg.headdim))
    ys = []
    for t in range(s):
        S = (S * torch.exp(dt[:, t] * A)[:, :, None, None]
             + dt[:, t, :, None, None] * B[:, t, :, :, None]
             * x[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", C[:, t], S)
                  + p["D"][:, None] * x[:, t])
    y = torch.stack(ys, 1).reshape(bsz, s, cfg.d_inner)
    y = rmsnorm(p["norm"], y * torch.nn.functional.silu(z))
    return dense(p["out_proj"], y)


@pytest.mark.parametrize("n_chunks", [2, 4])
def test_chunked_ssd_equals_sequential_recurrence(n_chunks):
    rcfg, cfg = _cfgs()
    p = _t(_params(rcfg, seed=2))
    u = torch.from_numpy(_u((2, CHUNK * n_chunks, 32), seed=3))
    got = mamba2.mamba2_apply(p, u, cfg)
    want = _sequential(p, u, cfg)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= SEQ_FRAC * scale
    # a later input moves no earlier output (causal conv and scan)
    u2 = u.clone()
    u2[:, CHUNK + 3:] += 1.0
    again = mamba2.mamba2_apply(p, u2, cfg)
    assert torch.equal(again[:, :CHUNK + 3], got[:, :CHUNK + 3])


def test_grads_under_vmap_match_reference_per_worker():
    """Every leaf's gradient of ``Σ y·r`` for K = 2 stacked workers through
    ``torch.func.vmap(grad)``, over 2 chunks, against the reference's per
    worker."""
    rcfg, cfg = _cfgs()
    ps = [_params(rcfg, seed=s) for s in (4, 5)]
    us = [_u((2, 2 * CHUNK, 32), seed=s) for s in (6, 7)]
    r = _u((2, 2 * CHUNK, 32), seed=8)

    def rloss(p, u):
        return jnp.sum(r_mamba.mamba2_apply(p, u, rcfg) * r)

    def loss(p, u):
        return torch.sum(mamba2.mamba2_apply(p, u, cfg)
                         * torch.from_numpy(r))

    stacked = jax.tree_util.tree_map(lambda a, b: np.stack([a, b]), *ps)
    grads = torch.func.vmap(torch.func.grad(loss))(
        _t(stacked), torch.from_numpy(np.stack(us)))
    rgrad = jax.jit(jax.grad(rloss))
    for w in range(2):
        want = params_from_reference(jax.tree_util.tree_map(
            np.array, rgrad(ps[w], us[w])), "cpu")
        got = params_from_reference(jax.tree_util.tree_map(
            lambda t: t[w].numpy(), grads), "cpu")
        assert list(got) == list(want) == [
            "A_log", "D", "conv_b", "conv_w", "dt_bias", "in_proj.w",
            "norm.scale", "out_proj.w"]
        scale = max(float(v.abs().max()) for v in want.values())
        for k in want:
            _close(got[k], want[k].numpy(), atol=GRAD_FRAC * scale, rtol=0)


def test_grads_finite_where_the_decay_overflows_above_the_diagonal():
    """With steps that decay hard (dt ≈ 12 on every head, A down to −16)
    ``exp(cum_q − cum_j)`` above the diagonal is far past f32's range:
    masking after the ``exp`` would put ``inf · 0 = NaN`` in the gradient.
    The port masks first, so every gradient is finite, and equals the
    reference's."""
    rcfg, cfg = _cfgs()
    p = _params(rcfg, seed=9)
    p["dt_bias"] = np.full_like(p["dt_bias"], 12.0)
    u = _u((1, 4 * CHUNK, 32), seed=10)
    tp = _t(p)
    leaves = [tp[k] for k in ("A_log", "dt_bias", "conv_w")] + [
        tp["in_proj"]["w"]]
    for t in leaves:
        t.requires_grad_(True)
    y = mamba2.mamba2_apply(tp, torch.from_numpy(u), cfg)
    grads = torch.autograd.grad(y.square().sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    rg = jax.jit(jax.grad(lambda q: jnp.sum(
        r_mamba.mamba2_apply(q, u, rcfg) ** 2)))(p)
    want = [rg["A_log"], rg["dt_bias"], rg["conv_w"], rg["in_proj"]["w"]]
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(grads, want):
        _close(g, w, atol=GRAD_FRAC * scale, rtol=0)


@pytest.mark.parametrize("s", [2, CHUNK, 3 * CHUNK])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_return_state_matches_reference(s, dtype):
    """``mamba2_apply(return_state=True)``: the final SSM state (f32
    whatever the compute dtype) and the last k − 1 = 3 raw conv inputs,
    left-padded with zeros at s = 2, against the reference's; in bf16 the
    inputs and params are the same bf16 values on both sides, the bar
    bf16's (atol/rtol 2e-2)."""
    rcfg, cfg = _cfgs()
    p = _params(rcfg, seed=11)
    u = _u((2, s, 32), seed=12)
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else {}
    def cast(tree):             # mamba2_init's dtypes: A_log, dt_bias, D f32
        return {k: cast(v) if isinstance(v, dict) else jnp.asarray(v).astype(
            jnp.float32 if k in ("A_log", "dt_bias", "D") else dtype)
            for k, v in tree.items()}

    def to_torch(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            getattr(torch, str(a.dtype)))

    rp, ru = cast(p), jnp.asarray(u).astype(dtype)
    ry, rc = jax.jit(lambda q, x: r_mamba.mamba2_apply(
        q, x, rcfg, return_state=True))(rp, ru)
    y, cache = mamba2.mamba2_apply(jax.tree_util.tree_map(to_torch, rp),
                                   to_torch(ru), cfg, return_state=True)
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == getattr(torch, dtype)
    assert cache["conv"].shape == (2, 3, cfg.conv_dim)
    _close(y.float(), np.asarray(ry.astype(jnp.float32)), **tol)
    _close(cache["ssm"], np.asarray(rc["ssm"]), **tol)
    _close(cache["conv"].float(), np.asarray(rc["conv"].astype(jnp.float32)),
           **tol)
    if s < 3:
        assert not cache["conv"][:, :3 - s].any()


def test_decode_steps_match_reference_and_the_chunked_pass():
    """``init_mamba_cache`` (f32 state, zeros) and 8 ``mamba2_decode``
    steps from it against the reference's step by step, outputs and cache,
    and against ``mamba2_apply`` over the 8 positions; the cache is
    written in place."""
    rcfg, cfg = _cfgs()
    p = _params(rcfg, seed=13)
    u = _u((2, CHUNK, 32), seed=14)
    rc = r_mamba.init_mamba_cache(rcfg, 2, jnp.float32)
    cache = mamba2.init_mamba_cache(cfg, 2, torch.float32)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "ssm": ((2, cfg.n_heads, cfg.d_state, cfg.headdim), torch.float32),
        "conv": ((2, 3, cfg.conv_dim), torch.float32)}
    rstep = jax.jit(lambda q, x, c: r_mamba.mamba2_decode(q, x, c, rcfg))
    tp = _t(p)
    outs = []
    for i in range(CHUNK):
        ry, rc = rstep(p, u[:, i:i + 1], rc)
        y, same = mamba2.mamba2_decode(tp, torch.from_numpy(u[:, i:i + 1]),
                                       cache, cfg)
        assert same is cache
        _close(y, ry)
        outs.append(y)
    _close(cache["ssm"], rc["ssm"])
    _close(cache["conv"], rc["conv"])
    whole, state = mamba2.mamba2_apply(tp, torch.from_numpy(u), cfg,
                                       return_state=True)
    _close(torch.cat(outs, dim=1), whole.numpy())
    _close(cache["ssm"], state["ssm"].numpy())


def test_ssm_leaves_init_rules_dtypes_and_order():
    """``Model.init`` draws the SSM leaves as ``mamba2_init`` does, under
    bf16 params: ``conv_w`` a normal (not truncated) times 0.1 and
    ``conv_b`` zeros, in bf16; ``A_log = log(linspace(1, 16, h))`` within
    1 ulp of the reference's, ``dt_bias`` zeros and ``D`` ones, in f32.
    The leaves sort as ``jax.tree_util`` sorts them (capitals first), so
    the plan's slots equal the reference's."""
    name = "mamba2-1.3b"
    cfg = dataclasses.replace(get_smoke_config(name).model,
                              param_dtype="bfloat16", n_layers=4)
    p = make_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    rmodel = r_make_model(dataclasses.replace(r_smoke(name).model,
                                              param_dtype="bfloat16",
                                              n_layers=4))
    rp = rmodel.init(jax.random.PRNGKey(0))
    rnames = [".".join(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(rp)[0]]
    assert list(p) == rnames
    pre = "blocks.pos0.mamba."
    h = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    for leaf in ("A_log", "dt_bias", "D"):
        assert p[pre + leaf].dtype == torch.float32
        assert p[pre + leaf].shape == (4, h)
    for leaf in ("conv_w", "conv_b", "in_proj.w", "out_proj.w",
                 "norm.scale"):
        assert p[pre + leaf].dtype == torch.bfloat16
    ref_alog = np.asarray(rp["blocks"]["pos0"]["mamba"]["A_log"])
    ulp = np.spacing(np.abs(ref_alog))
    assert np.all(np.abs(p[pre + "A_log"].numpy() - ref_alog) <= ulp)
    assert torch.equal(p[pre + "dt_bias"], torch.zeros(4, h))
    assert torch.equal(p[pre + "D"], torch.ones(4, h))
    assert torch.equal(p[pre + "conv_b"].float(),
                       torch.zeros(p[pre + "conv_b"].shape))
    conv = p[pre + "conv_w"].float()
    assert abs(float(conv.std()) - 0.1) < 0.01        # not truncated:
    assert float(conv.abs().max()) > 0.25             # past 2σ
    w = p[pre + "in_proj.w"].float()
    assert float(w.abs().max()) <= 2.0 * cfg.d_model ** -0.5 * 1.01
    plan = KernelPlan.for_tree(p)
    rplan = RPlan.for_tree(rp)
    assert [(s.shape, s.size, s.row_start, s.n_rows) for s in plan.slots] \
        == [(s.shape, s.size, s.row_start, s.n_rows) for s in rplan.slots]
    assert (plan.rows, plan.used_rows) == (rplan.rows, rplan.used_rows)
