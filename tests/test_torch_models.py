"""The port's transformer layers, attention and model against the
reference's, from the same params and inputs.

Inputs are numpy draws from a seed; params come from the reference's own
``init`` through ``params_from_reference`` (an exact copy).  The
transformer is smooth (no ReLU), so the bars are tight f32 bars: XLA:CPU
and PyTorch sum the matmuls and reductions in different orders, which
moves results by a few ulps.

* layers and attention outputs: atol 1e-5, rtol 1e-5;
* logits: atol 1e-5 (measured on the ten smoke configs: at most
  2.3e-6 apart); the loss: rtol 1e-5 (measured: 1.5e-7 at most);
* gradients: each leaf within 1e-4 of the largest gradient's max norm
  (measured: 8.7e-7 of it at most);
* PD-SGDM's kernel round on the MiniCPM3 (MLA) and Mamba2 (SSD) smoke
  configs, round by round from the same start: params and m within atol
  2e-6, losses rtol 1e-6, as ``tests/test_torch_moe.py`` holds Mixtral's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelCfg as RModelCfg  # noqa: E402
from repro.configs.registry import get_smoke_config as r_smoke  # noqa: E402
from repro.core import make_optimizer as r_make_optimizer  # noqa: E402
from repro.core import topology as r_top  # noqa: E402
from repro.core.gossip import DenseComm as RDenseComm  # noqa: E402
from repro.models import attention as r_attn  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import make_model as r_make_model  # noqa: E402
from repro_torch.configs.base import ModelCfg  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import DenseComm, make_optimizer, ring  # noqa: E402
from repro_torch.models import attention, layers, make_model  # noqa: E402
from repro_torch.tree import leaf_order  # noqa: E402

ATOL = RTOL = 1e-5
GRAD_FRAC = 1e-4


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


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return {k: _t(v) for k, v in a.items()} if isinstance(a, dict) else \
        torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias):
    rng = _rng(0)
    p = {"w": rng.standard_normal((48, 24), dtype=np.float32)}
    if bias:
        p["b"] = rng.standard_normal((24,), dtype=np.float32)
    x = rng.standard_normal((3, 5, 48), dtype=np.float32)
    _close(layers.dense(_t(p), _t(x)), r_layers.dense(p, x))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "layernorm_nobias",
                                  "nonparametric"])
def test_norms(kind):
    rng = _rng(1)
    x = 3.0 * rng.standard_normal((2, 7, 64), dtype=np.float32) + 0.5
    p = {"scale": rng.standard_normal((64,), dtype=np.float32),
         "bias": rng.standard_normal((64,), dtype=np.float32)}
    if kind == "rmsnorm":
        got, want = layers.rmsnorm(_t(p), _t(x)), r_layers.rmsnorm(p, x)
    elif kind == "nonparametric":
        got = layers.nonparametric_layernorm(_t(x))
        want = r_layers.nonparametric_layernorm(x)
    else:
        if kind == "layernorm_nobias":
            del p["bias"]
        got, want = layers.layernorm(_t(p), _t(x)), r_layers.layernorm(p, x)
    _close(got, want)


def test_embed_and_rope():
    rng = _rng(2)
    table = rng.standard_normal((50, 16), dtype=np.float32)
    tok = rng.integers(0, 50, (3, 9)).astype(np.int32)
    _close(layers.embed({"table": _t(table)}, _t(tok)),
           r_layers.embed({"table": table}, tok), atol=0, rtol=0)
    for theta in (10000.0, 1e6):               # Qwen2 uses θ = 1e6
        cos, sin = layers.rope_freqs(32, 40, theta)
        rcos, rsin = r_layers.rope_freqs(32, 40, theta)
        _close(cos, rcos)
        _close(sin, rsin)
        x = rng.standard_normal((3, 9, 4, 32), dtype=np.float32)
        pos = np.stack([np.arange(9) + o for o in (0, 5, 30)]).astype(
            np.int32)
        _close(layers.apply_rope(_t(x), cos, sin, _t(pos).long()),
               r_layers.apply_rope(x, rcos, rsin, pos))


@pytest.mark.parametrize("gated", [True, False])
def test_mlp(gated):
    """Gated SiLU, and OLMo's non-gated GELU in its tanh form (the port
    must not take ``F.gelu``'s exact default)."""
    rng = _rng(3)
    p = {"wi": {"w": rng.standard_normal((32, 64), dtype=np.float32)},
         "wo": {"w": rng.standard_normal((64, 32), dtype=np.float32)}}
    if gated:
        p["wg"] = {"w": rng.standard_normal((32, 64), dtype=np.float32)}
    x = rng.standard_normal((2, 5, 32), dtype=np.float32)
    _close(layers.mlp(_t(p), _t(x)), r_layers.mlp(p, x), atol=1e-4)


# ---------------------------------------------------------------- attention
ATTN_CASES = {
    "mha": dict(n_heads=4, n_kv_heads=4),
    "gqa": dict(n_heads=4, n_kv_heads=1),
    "gqa_bias": dict(n_heads=4, n_kv_heads=2, qkv_bias=True),
    "window": dict(n_heads=4, n_kv_heads=2, window=5),
    "blockwise": dict(n_heads=4, n_kv_heads=2, q_chunk=4),
    "blockwise_window": dict(n_heads=4, n_kv_heads=1, window=6, q_chunk=4),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_apply(case):
    kw = dict(ATTN_CASES[case])
    force = "blockwise" in case
    rcfg = r_attn.AttnCfg(d_model=32, head_dim=8, **kw)
    cfg = attention.AttnCfg(**dataclasses.asdict(rcfg))
    params = jax.tree_util.tree_map(
        np.array, r_attn.attention_init(jax.random.PRNGKey(4), rcfg,
                                        jnp.float32))
    if cfg.qkv_bias:    # non-zero biases, so that the bias path is held
        rng = _rng(5)
        for k in ("wq", "wk", "wv"):
            params[k]["b"] = rng.standard_normal(
                params[k]["b"].shape, dtype=np.float32)
    x = _rng(6).standard_normal((2, 16, 32), dtype=np.float32)
    rcos, rsin = r_layers.rope_freqs(8, 16)
    cos, sin = layers.rope_freqs(8, 16)
    want = r_attn.attention_apply(params, x, rcfg, rcos, rsin,
                                  force_blockwise=force)
    got = attention.attention_apply(_t(params), _t(x), cfg, cos, sin,
                                    force_blockwise=force)
    _close(got, want)
    if force:       # the blockwise path equals the full one
        full = attention.attention_apply(_t(params), _t(x), cfg, cos, sin,
                                         force_blockwise=False)
        _close(got, full.detach().numpy())


# ---------------------------------------------------------------- the model
# every LM config of get_smoke_config: GQA (dense and MoE FFNs), MLA, the
# SSD mixer, Jamba's hybrid (mamba, dense) + (attn, moe) pattern, and the
# audio (embeds) and VLM (patch prefix) input modes
SMOKE = ("olmo-1b", "qwen2-72b", "stablelm-12b", "mixtral-8x7b",
         "arctic-480b", "minicpm3-4b", "mamba2-1.3b", "jamba-1.5-large-398b",
         "musicgen-medium", "internvl2-76b")
# the configs of this slice run at seq 32: two chunks of the smoke SSD's
# 16, and the VLM's 16 patches before 16 tokens
SEQ = {name: 32 for name in SMOKE[5:]}


def _ref_model(name):
    mcfg = r_smoke(name).model
    model = r_make_model(mcfg)
    params = jax.tree_util.tree_map(
        np.array, model.init(jax.random.PRNGKey(7)))
    return mcfg, model, params


def _batch(vocab, b=2, s=16, seed=8, mcfg=None):
    """Tokens and labels; under ``mcfg``'s ``embeds`` mode normal frame
    embeddings instead of tokens, under ``vlm`` normal patch embeddings
    (``min(n_patches, s // 2)`` of them) before ``s − patches`` tokens,
    with labels for the tokens only (as ``train_batch_arrays``)."""
    rng = _rng(seed)
    mode = "tokens" if mcfg is None else mcfg.input_mode
    out = {}
    if mode == "embeds":
        out["embeds"] = rng.standard_normal((b, s, mcfg.d_model),
                                            dtype=np.float32)
    elif mode == "vlm":
        npatch = min(mcfg.n_patches, s // 2)
        out["patch_embeds"] = rng.standard_normal((b, npatch, mcfg.d_model),
                                                  dtype=np.float32)
        s -= npatch
    if mode != "embeds":
        out["tokens"] = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -1                       # masked labels
    out["labels"] = labels
    return out


@pytest.mark.parametrize("name", SMOKE)
def test_model_apply_loss_and_grads(name):
    mcfg, rmodel, rparams = _ref_model(name)
    model = make_model(get_smoke_config(name).model)
    params = params_from_reference(rparams, "cpu")
    assert list(params) == leaf_order(model.param_shapes())
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        model.param_shapes()
    batch = _batch(mcfg.vocab, s=SEQ.get(name, 16), mcfg=mcfg)
    tbatch = _t(batch)

    rlogits, raux = jax.jit(rmodel.apply)(rparams, batch)
    logits, aux = model.apply(params, tbatch)
    assert logits.dtype == torch.float32
    _close(logits, rlogits)
    # the MoE configs' summed router loss; exactly 0 without an MoE FFN
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5, atol=0)

    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        rmodel.loss, has_aux=True))(rparams, batch)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    loss, met = model.loss(params, tbatch)
    # the embeds mode never reads the embedding table: its gradient is 0,
    # as the reference's
    grads = dict(zip(params, torch.autograd.grad(
        loss, list(params.values()), materialize_grads=True)))
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["ce"].detach()), float(rmet["ce"]),
                               rtol=1e-5)
    rflat = params_from_reference(jax.tree_util.tree_map(np.array, rgrads),
                                  "cpu")
    assert list(rflat) == list(grads)
    scale = max(float(v.abs().max()) for v in rflat.values())
    for k, g in grads.items():
        _close(g, rflat[k].numpy(), atol=GRAD_FRAC * scale, rtol=0)


def test_model_loss_under_vmap_matches_per_worker():
    """K stacked workers through ``torch.func.vmap(grad_and_value)`` (what
    ``SimTrainer`` runs) give each worker's own loss and gradients."""
    _, _, rparams = _ref_model("olmo-1b")
    model = make_model(get_smoke_config("olmo-1b").model)
    one = params_from_reference(rparams, "cpu")
    stacked = {k: torch.stack([v, v * 1.01]) for k, v in one.items()}
    b0 = _t(_batch(model.cfg.vocab, seed=9))
    b1 = _t(_batch(model.cfg.vocab, seed=10))
    batch = {k: torch.stack([b0[k], b1[k]]) for k in b0}
    grads, losses = torch.func.vmap(torch.func.grad_and_value(
        lambda p, b: model.loss(p, b)[0]))(stacked, batch)
    for w, b in enumerate((b0, b1)):
        pw = {k: v[w] for k, v in stacked.items()}
        gw, lw = torch.func.grad_and_value(
            lambda p: model.loss(p, b)[0])(pw)
        np.testing.assert_allclose(float(losses[w]), float(lw), rtol=1e-6)
        for k in gw:
            _close(grads[k][w], gw[k].numpy(), atol=1e-6, rtol=1e-5)


def test_leaf_counts_and_tied_head():
    """The quickstart's tiny LM has 12 leaves, OLMo 8 (its non-parametric
    norms have none), Qwen2's smoke config 15; a tied head has no
    ``lm_head`` leaf and reads ``embed.table.T``."""
    tiny = ModelCfg(name="tiny-lm", arch_type="dense", n_layers=2,
                    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
    assert len(make_model(tiny).param_shapes()) == 12
    from repro_torch.configs.olmo_1b import config as olmo
    assert len(make_model(olmo().model).param_shapes()) == 8
    assert len(make_model(get_smoke_config("qwen2-72b").model)
               .param_shapes()) == 15
    rcfg = RModelCfg(name="tied", arch_type="dense", n_layers=2, d_model=32,
                     n_heads=4, n_kv_heads=2, d_ff=64, vocab=40,
                     tie_embeddings=True, norm="layernorm")
    rmodel = r_make_model(rcfg)
    rparams = jax.tree_util.tree_map(np.array,
                                     rmodel.init(jax.random.PRNGKey(1)))
    model = make_model(ModelCfg(**{f.name: getattr(rcfg, f.name)
                                   for f in dataclasses.fields(rcfg)}))
    params = params_from_reference(rparams, "cpu")
    assert "lm_head.w" not in params and list(params) == list(
        model.param_shapes())
    batch = _batch(40, s=8, seed=11)
    _close(model.apply(params, _t(batch))[0], rmodel.apply(rparams, batch)[0])


def test_init_distribution_and_refusals():
    """``init`` draws the reference's distributions (a truncated normal on
    [−2, 2] times ``in_dim ** -0.5``; the embedding times 1.0; norm scales
    1, biases 0) from an explicit generator, the MoE leaves too (the
    router in f32 under bf16 params, ``wi`` at d^-0.5, ``wo`` at f^-0.5),
    and the SSM leaves of Jamba's hybrid pattern (``conv_w`` a normal
    times 0.1, ``conv_b`` zeros, ``A_log`` log(1 … 16), ``dt_bias`` 0,
    ``D`` 1; the last three f32 under bf16 params); every mixer and input
    mode builds, and ``decode_step`` runs one step from an empty cache on
    every smoke config."""
    cfg = get_smoke_config("stablelm-12b").model
    model = make_model(cfg)
    g = torch.Generator().manual_seed(0)
    p = model.init(g, device="cpu")
    again = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    w = p["blocks.pos0.mlp.wi.w"]
    assert float(w.abs().max()) <= 2.0 * cfg.d_model ** -0.5
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 0.8796) < 0.02
    assert float(p["embed.table"].abs().max()) <= 2.0
    assert torch.equal(p["final_norm.scale"], torch.ones(cfg.d_model))
    assert torch.equal(p["final_norm.bias"], torch.zeros(cfg.d_model))
    mcfg = dataclasses.replace(get_smoke_config("mixtral-8x7b").model,
                               param_dtype="bfloat16")
    mp = make_model(mcfg).init(torch.Generator().manual_seed(1),
                               device="cpu")
    assert mp["blocks.pos0.moe.router.w"].dtype == torch.float32
    assert mp["blocks.pos0.moe.wi"].dtype == torch.bfloat16
    for leaf, fan_in in (("router.w", mcfg.d_model), ("wi", mcfg.d_model),
                         ("wg", mcfg.d_model), ("wo", mcfg.d_ff)):
        t = mp[f"blocks.pos0.moe.{leaf}"].float()
        assert float(t.abs().max()) <= 2.0 * fan_in ** -0.5
        assert abs(float(t.std()) * fan_in ** 0.5 - 0.8796) < 0.02, leaf
    jcfg = dataclasses.replace(get_smoke_config("jamba-1.5-large-398b").model,
                               param_dtype="bfloat16")
    jp = make_model(jcfg).init(torch.Generator().manual_seed(2),
                               device="cpu")
    ssm = "blocks.pos0.mamba."
    h = jcfg.ssm_expand * jcfg.d_model // jcfg.ssm_headdim
    np.testing.assert_allclose(jp[ssm + "A_log"][0].numpy(),
                               np.log(np.linspace(1, 16, h)), rtol=1e-6)
    for leaf, value in (("dt_bias", 0.0), ("D", 1.0)):
        assert jp[ssm + leaf].dtype == torch.float32
        assert torch.equal(jp[ssm + leaf], torch.full((1, h), value))
    assert jp[ssm + "A_log"].dtype == torch.float32
    assert jp[ssm + "conv_b"].dtype == torch.bfloat16
    assert not jp[ssm + "conv_b"].float().any()
    assert jp[ssm + "conv_w"].dtype == torch.bfloat16
    assert abs(float(jp[ssm + "conv_w"].float().std()) - 0.1) < 0.02
    assert jp["blocks.pos1.moe.router.w"].dtype == torch.float32
    for name in SMOKE:
        scfg = get_smoke_config(name).model
        built = make_model(scfg)
        sp = built.init(torch.Generator().manual_seed(3), device="cpu")
        cache = built.init_cache(2, 4, device="cpu")
        step = (torch.zeros((2, 1, scfg.d_model))
                if scfg.input_mode == "embeds"
                else torch.zeros((2,), dtype=torch.int32))
        logits, same = built.decode_step(sp, cache, step, 0)
        assert same is cache and logits.shape == (2, scfg.vocab)
        assert logits.dtype == torch.float32 and bool(
            torch.isfinite(logits).all())


# ----------------------------------- PD-SGDM on the MLA and SSD smoke models
K, P, ROUNDS = 2, 4, 2
HYPER = dict(eta=0.25, mu=0.9, p=P, weight_decay=1e-4)


def _nested(flat):
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = out
        for q in path:
            d = d.setdefault(q, {})
        d[leaf] = np.array(v)
    return out


@pytest.mark.parametrize("name", ["minicpm3-4b", "mamba2-1.3b"])
def test_pd_sgdm_kernel_round_matches_reference(name):
    """PD-SGDM on the smoke config (2 layers: (mla, dense), or (mamba,
    none) at 2 chunks of 16), K = 2 on ``ring(2)``, the chip path's step:
    each of two kernel rounds from the port's state after the rounds
    before it, against the reference's kernel round (its Pallas kernels in
    interpret mode on the CPU) from that same state, on the reference's
    ``lm_batch`` batches.  The momentum launches write in place, so the
    round's inputs must come back untouched."""
    from repro.data.synthetic import LMStreamCfg as RLMCfg
    from repro.data.synthetic import lm_batch as r_lm_batch
    mcfg = r_smoke(name).model
    rmodel = r_make_model(mcfg)
    p0 = jax.tree_util.tree_map(np.asarray, jax.vmap(
        lambda _: rmodel.init(jax.random.PRNGKey(0)))(jnp.arange(K)))
    data = RLMCfg(vocab=mcfg.vocab, seq_len=32, batch=2, n_workers=K)
    batches = [jax.tree_util.tree_map(np.asarray, r_lm_batch(data, t))
               for t in range(ROUNDS * P)]
    ref = r_make_optimizer("pd_sgdm", RDenseComm(r_top.ring(K)),
                           use_kernel=True, **HYPER)
    rgrad = jax.vmap(jax.value_and_grad(lambda p, b: rmodel.loss(p, b)[0]))

    def r_grads(p, b):
        losses, g = rgrad(p, b)
        return losses.mean(), g

    r_round = jax.jit(lambda s, p, b: ref.round(s, p, r_grads, b))
    model = make_model(get_smoke_config(name).model)
    opt = make_optimizer("pd_sgdm", DenseComm(ring(K), device="cpu"),
                         use_kernel=True, **HYPER)
    grad = torch.func.vmap(torch.func.grad_and_value(
        lambda p, b: model.loss(p, b)[0]))

    def grads(p, b):
        g, losses = grad(p, b)
        return losses.mean(), g

    params = params_from_reference(p0, "cpu")
    state = opt.init(params)
    for r in range(ROUNDS):
        steps = batches[r * P:(r + 1) * P]
        stacked = {k: np.stack([b[k] for b in steps]) for k in steps[0]}
        rstate = {"m": _nested(state["m"]),
                  "step": jnp.asarray(int(state["step"]), jnp.int32)}
        rp, rs, rl = r_round(rstate, _nested(params), stacked)
        before = ({k: v.clone() for k, v in params.items()},
                  {k: v.clone() for k, v in state["m"].items()})
        new_p, new_s, losses = opt.round(state, params, grads, _t(stacked))
        assert all(torch.equal(params[k], before[0][k]) for k in params)
        assert all(torch.equal(state["m"][k], before[1][k])
                   for k in state["m"])
        np.testing.assert_allclose(losses.numpy(), np.asarray(rl),
                                   rtol=1e-6)
        want_p = params_from_reference(jax.tree_util.tree_map(np.asarray,
                                                              rp), "cpu")
        want_m = params_from_reference(jax.tree_util.tree_map(
            np.asarray, rs["m"]), "cpu")
        for k in want_p:
            _close(new_p[k], want_p[k].numpy(), atol=2e-6, rtol=0)
            _close(new_s["m"][k], want_m[k].numpy(), atol=2e-6, rtol=0)
        assert int(new_s["step"]) == (r + 1) * P
        params, state = new_p, new_s
