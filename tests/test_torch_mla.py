"""The port's MLA (``repro_torch.models.attention.mla_apply``) against the
reference's, from the same numpy params and inputs.

Params come from the reference's ``mla_init`` (an exact copy through
numpy), the inputs from a seeded numpy draw.  MLA is smooth, so the bars
are ``tests/test_torch_models.py``'s f32 bars: outputs atol 1e-5 / rtol
1e-5 (XLA:CPU and PyTorch sum the matmuls and the softmax in other
orders, a few ulps), gradients each within 1e-5 of the largest
gradient's max norm.  The blockwise path (query chunks of 4, taken at
``blockwise_threshold``) equals the full one at the same bar.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as r_attn  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402

ATOL = RTOL = 1e-5
GRAD_FRAC = 1e-5
# the smoke config's MLA ranks (get_smoke_config): q_lora 64, kv_lora 32,
# nope/rope 16/8, v_head 16, over 4 heads of d_model 64
DIMS = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
            q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
            v_head_dim=16)
PATHS = {"full": {}, "blockwise": dict(q_chunk=4, blockwise_threshold=8)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensor ops (the suite
    runs several test processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(path):
    rcfg = r_attn.AttnCfg(**DIMS, **PATHS[path])
    return rcfg, attention.AttnCfg(**dataclasses.asdict(rcfg))


def _params(rcfg, seed=0):
    return jax.tree_util.tree_map(
        np.array, r_attn.mla_init(jax.random.PRNGKey(seed), rcfg,
                                  jnp.float32))


def _t(tree):
    return ({k: _t(v) for k, v in tree.items()} if isinstance(tree, dict)
            else torch.from_numpy(np.array(tree)))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_mla_apply_matches_reference(path):
    rcfg, cfg = _cfgs(path)
    p = _params(rcfg)
    x = _x((2, 16, 64))
    rcos, rsin = r_layers.rope_freqs(rcfg.qk_rope_dim, 16)
    cos, sin = layers.rope_freqs(cfg.qk_rope_dim, 16)
    want = r_attn.mla_apply(p, x, rcfg, rcos, rsin)
    got = attention.mla_apply(_t(p), torch.from_numpy(x), cfg, cos, sin)
    assert got.shape == (2, 16, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    if path == "blockwise":     # the chunked path equals the full one
        _, full = _cfgs("full")
        np.testing.assert_allclose(
            got.numpy(), attention.mla_apply(_t(p), torch.from_numpy(x),
                                             full, cos, sin).numpy(),
            atol=ATOL, rtol=RTOL)


def test_mla_is_causal_and_mha_over_96_dims_at_full_ranks():
    """At MiniCPM3's head geometry (nope 64 + rope 32, so scores over 96
    dims at scale 96^-0.5, and v 64; 2 heads here) the port equals the
    reference, and the output at a position does not depend on later
    positions."""
    rcfg = r_attn.AttnCfg(d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
                          q_lora_rank=24, kv_lora_rank=16, qk_nope_dim=64,
                          qk_rope_dim=32, v_head_dim=64)
    cfg = attention.AttnCfg(**dataclasses.asdict(rcfg))
    p = _params(rcfg, seed=3)
    x = _x((1, 12, 32), seed=4)
    rcos, rsin = r_layers.rope_freqs(32, 12)
    cos, sin = layers.rope_freqs(32, 12)
    y = attention.mla_apply(_t(p), torch.from_numpy(x), cfg, cos, sin)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(r_attn.mla_apply(p, x, rcfg, rcos, rsin)),
        atol=ATOL, rtol=RTOL)
    x2 = x.copy()
    x2[:, 7:] += 1.0
    y2 = attention.mla_apply(_t(p), torch.from_numpy(x2), cfg, cos, sin)
    assert torch.equal(y[:, :7], y2[:, :7])
    assert not torch.allclose(y[:, 7:], y2[:, 7:])


def test_mla_grads_under_vmap_match_reference_per_worker():
    """Every MLA leaf's gradient of ``Σ y·r`` for K = 2 stacked workers
    through ``torch.func.vmap(grad)``, against the reference's per worker;
    ``wkr``'s gradient sums the rotary head's broadcast over the heads."""
    rcfg, cfg = _cfgs("full")
    ps = [_params(rcfg, seed=s) for s in (5, 6)]
    xs = [_x((2, 16, 64), seed=s) for s in (7, 8)]
    r = _x((2, 16, 64), seed=9)
    rcos, rsin = r_layers.rope_freqs(rcfg.qk_rope_dim, 16)
    cos, sin = layers.rope_freqs(cfg.qk_rope_dim, 16)

    def rloss(p, x):
        return jnp.sum(r_attn.mla_apply(p, x, rcfg, rcos, rsin) * r)

    def loss(p, x):
        return torch.sum(attention.mla_apply(p, x, cfg, cos, sin)
                         * torch.from_numpy(r))

    stacked = jax.tree_util.tree_map(lambda a, b: np.stack([a, b]), *ps)
    grads = torch.func.vmap(torch.func.grad(loss))(
        _t(stacked), torch.from_numpy(np.stack(xs)))
    for w in range(2):
        want = params_from_reference(jax.tree_util.tree_map(
            np.array, jax.grad(rloss)(ps[w], xs[w])), "cpu")
        got = params_from_reference(jax.tree_util.tree_map(
            lambda t: t[w].numpy(), grads), "cpu")
        assert list(got) == list(want)
        assert "wkr.w" in want and float(want["wkr.w"].abs().max()) > 0
        scale = max(float(v.abs().max()) for v in want.values())
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=GRAD_FRAC * scale, rtol=0)
