"""The port's serving path (``repro_torch.models`` caches, prefill and
decode, ``repro_torch.serve.serving.generate``, the serving CLI and
example) against the reference's, from the same params and inputs.

Params come from the reference's ``init`` through
``params_from_reference`` (an exact copy), tokens and embeddings from a
seeded numpy draw; the reference's prefill and decode run under
``jax.jit``, as its own ``tests/test_models.py`` runs them.  Bars:

* logits (prefill, every decode step): atol 1e-5, rtol 1e-5, the
  model tests' f32 bar (XLA:CPU and PyTorch sum in other orders);
* caches: every K/V, latent, SSM state and conv leaf within atol 1e-5,
  rtol 1e-5; every cache ``pos`` exactly; shapes and dtypes exactly;
* greedy tokens exactly.

The cases: dense GQA; GQA with a window of 8 under a 12-token prompt (the
ring takes the prompt's tail rolled) and under a 6-token prompt (decode
wraps the ring); QKV bias with LayerNorm; MLA; the pure SSM at 2 chunks
and with a 2-token prompt (shorter than the conv's k − 1 = 3); the hybrid
pattern with MoE; the ``embeds`` and ``vlm`` modes; and ``generate`` on
every smoke config whose input is tokens.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import LayerSpec  # noqa: E402
from repro.configs.base import ModelCfg as RModelCfg  # noqa: E402
from repro.configs.registry import get_smoke_config as r_smoke  # noqa: E402
from repro.configs.shapes import SHAPES as R_SHAPES  # noqa: E402
from repro.configs.shapes import train_batch_specs as r_specs  # noqa: E402
from repro.models import attention as r_attn  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import make_model as r_make_model  # noqa: E402
from repro.serve.serving import generate as r_generate  # noqa: E402
from repro_torch.configs.base import ModelCfg  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, train_batch_specs  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import attention, layers, make_model  # noqa: E402
from repro_torch.serve.serving import generate  # noqa: E402

ATOL = RTOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensor ops (the suite
    runs several test processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dense(**kw):
    base = dict(name="t", arch_type="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab=V)
    base.update(kw)
    return RModelCfg(**base)


# name: (reference config, prompt length, sequence length)
CASES = {
    "dense": (_dense(), 8, 16),
    "ring_prompt_roll": (_dense(window=8), 12, 16),
    "ring_decode_wrap": (_dense(window=8), 6, 16),
    "qkv_bias_ln": (_dense(qkv_bias=True, norm="layernorm"), 8, 16),
    "mla": (_dense(use_mla=True, n_kv_heads=4, q_lora_rank=32,
                   kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                   v_head_dim=16, pattern=(LayerSpec("mla", "dense"),)),
            8, 16),
    "ssm": (_dense(arch_type="ssm", d_ff=0, ssm_state=16, ssm_headdim=16,
                   ssm_chunk=4, pattern=(LayerSpec("mamba", "none"),)),
            8, 16),
    "ssm_short_prompt": (_dense(arch_type="ssm", d_ff=0, ssm_state=16,
                                ssm_headdim=16, ssm_chunk=4,
                                pattern=(LayerSpec("mamba", "none"),)),
                         2, 8),
    "hybrid_moe": (RModelCfg(name="h", arch_type="hybrid", n_layers=4,
                             d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                             vocab=V, n_experts=4, ssm_state=16,
                             ssm_headdim=16, ssm_chunk=4,
                             pattern=(LayerSpec("mamba", "dense"),
                                      LayerSpec("mamba", "moe"),
                                      LayerSpec("attn", "dense"),
                                      LayerSpec("mamba", "moe"))), 8, 16),
    "embeds": (r_smoke("musicgen-medium").model, 8, 16),
    "vlm": (r_smoke("internvl2-76b").model, 16, 24),
}
GEN_SMOKE = ("olmo-1b", "qwen2-72b", "stablelm-12b", "mixtral-8x7b",
             "arctic-480b", "minicpm3-4b", "mamba2-1.3b",
             "jamba-1.5-large-398b")
B = 2


def _port_cfg(rcfg) -> ModelCfg:
    return ModelCfg(**{f.name: getattr(rcfg, f.name)
                       for f in dataclasses.fields(rcfg)})


def _inputs(rcfg, S: int, seed: int = 3) -> dict:
    """The whole sequence's inputs in the config's mode (numpy)."""
    rng = np.random.default_rng(seed)
    if rcfg.input_mode == "embeds":
        return {"embeds": rng.standard_normal((B, S, rcfg.d_model),
                                              dtype=np.float32)}
    out = {}
    npatch = 0
    if rcfg.input_mode == "vlm":
        npatch = min(rcfg.n_patches, S // 2)
        out["patch_embeds"] = rng.standard_normal(
            (B, npatch, rcfg.d_model), dtype=np.float32)
    out["tokens"] = rng.integers(0, rcfg.vocab, (B, S - npatch)).astype(
        np.int32)
    return out


def _prompt(rcfg, inp: dict, P: int) -> dict:
    """The first P positions of the inputs."""
    if "embeds" in inp:
        return {"embeds": inp["embeds"][:, :P]}
    if "patch_embeds" in inp:
        npatch = inp["patch_embeds"].shape[1]
        return {"patch_embeds": inp["patch_embeds"],
                "tokens": inp["tokens"][:, :P - npatch]}
    return {"tokens": inp["tokens"][:, :P]}


def _step_input(inp: dict, i: int):
    """Position i's decode input: a token (b,), or an embedding (b, 1, d)
    (the ``embeds`` frames, and the ``vlm`` patches)."""
    if "embeds" in inp:
        return inp["embeds"][:, i:i + 1]
    npatch = inp["patch_embeds"].shape[1] if "patch_embeds" in inp else 0
    if i < npatch:
        return inp["patch_embeds"][:, i:i + 1]
    return inp["tokens"][:, i - npatch]


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    # a copy: decode writes the port's cache in place
    return tree.detach().clone().numpy() if isinstance(
        tree, torch.Tensor) else np.asarray(tree)


def _t(a):
    return {k: _t(v) for k, v in a.items()} if isinstance(a, dict) else \
        torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _runs(case: str) -> dict:
    """Both sides of one case: the prefill over the prompt and the
    teacher-forced decode after it, the decode of every position from an
    empty cache, and the sequential prefill (numpy)."""
    rcfg, P, S = CASES[case]
    rmodel = r_make_model(rcfg)
    rparams = jax.tree_util.tree_map(np.asarray,
                                     rmodel.init(jax.random.PRNGKey(0)))
    model = make_model(_port_cfg(rcfg))
    params = params_from_reference(rparams, "cpu")
    inp = _inputs(rcfg, S)
    prompt = _prompt(rcfg, inp, P)
    rstep = jax.jit(functools.partial(rmodel.decode_step, max_positions=S))
    out = {}
    for side in ("ref", "port"):
        if side == "ref":
            pre = jax.jit(functools.partial(rmodel.prefill_fast, max_len=S))

            def step(c, x, i):
                return rstep(rparams, c, x, jnp.int32(i))
            lg, cache = pre(rparams, prompt)
            empty = rmodel.init_cache(B, S)
        else:
            tp = _t(prompt)
            lg, cache = model.prefill_fast(params, tp, max_len=S)

            def step(c, x, i):
                return model.decode_step(params, c, torch.from_numpy(
                    np.array(x)), i, max_positions=S)
            empty = model.init_cache(B, S, device="cpu")
        res = {"prefill": _np(lg), "prefill_cache": _np(cache),
               "empty": _np(empty)}
        logits = []
        for i in range(P, S):
            lg, cache = step(cache, _step_input(inp, i), i)
            logits.append(_np(lg))
        res["decode"], res["decode_cache"] = np.stack(logits), _np(cache)
        cache, logits = empty if side == "ref" else model.init_cache(
            B, S, device="cpu"), []
        for i in range(S):
            lg, cache = step(cache, _step_input(inp, i), i)
            logits.append(_np(lg))
        res["from_empty"], res["from_empty_cache"] = (np.stack(logits),
                                                      _np(cache))
        if case != "ring_prompt_roll":
            seq = (rmodel.prefill(rparams, prompt, max_len=S) if side == "ref"
                   else model.prefill(params, _t(prompt), max_len=S))
            res["sequential"], res["sequential_cache"] = (_np(seq[0]),
                                                          _np(seq[1]))
        out[side] = res
    out["apply"] = np.asarray(rmodel.apply(rparams, inp)[0])
    return out


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _same_cache(got: dict, want: dict):
    assert set(got) == set(want)
    for pos in want:
        assert set(got[pos]) == set(want[pos]), pos
        for leaf, w in want[pos].items():
            g = got[pos][leaf]
            assert g.shape == w.shape and g.dtype == w.dtype, (pos, leaf)
            if leaf == "pos":
                np.testing.assert_array_equal(g, w)
            else:
                _close(g, w)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_fast_matches_reference(case):
    r = _runs(case)
    _close(r["port"]["prefill"], r["ref"]["prefill"])
    _same_cache(r["port"]["prefill_cache"], r["ref"]["prefill_cache"])
    if not CASES[case][0].n_experts:    # the MoE's capacity follows N
        _close(r["port"]["prefill"], r["apply"][:, CASES[case][1] - 1])


@pytest.mark.parametrize("case", list(CASES))
def test_decode_after_prefill_matches_reference(case):
    r = _runs(case)
    _close(r["port"]["decode"], r["ref"]["decode"])
    _same_cache(r["port"]["decode_cache"], r["ref"]["decode_cache"])


@pytest.mark.parametrize("case", list(CASES))
def test_decode_from_empty_cache_matches_reference(case):
    r = _runs(case)
    _close(r["port"]["from_empty"], r["ref"]["from_empty"])
    _same_cache(r["port"]["from_empty_cache"], r["ref"]["from_empty_cache"])


@pytest.mark.parametrize("case", list(CASES))
def test_init_cache_matches_reference(case):
    """Shapes, dtypes and values of the empty cache: K/V zero, ``pos``
    int32 −1, the SSM state f32, a ring of ``min(window, max_len)``."""
    r = _runs(case)
    _same_cache(r["port"]["empty"], r["ref"]["empty"])


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c != "ring_prompt_roll"])
def test_sequential_prefill_matches_reference(case):
    r = _runs(case)
    _close(r["port"]["sequential"], r["ref"]["sequential"])
    _same_cache(r["port"]["sequential_cache"], r["ref"]["sequential_cache"])


def test_sequential_prefill_on_a_ring_shorter_than_the_prompt():
    """The reference's ``prefill`` sizes RoPE by the cache's slots, and a
    ring shorter than the prompt reads the table past its end (XLA clamps
    the gather); the port's reads a table of ``max_len`` positions, so its
    sequential prefill equals the one-pass prefill (the reference's too)
    while the reference's own two disagree."""
    rcfg, P, S = CASES["ring_prompt_roll"]
    r = _runs("ring_prompt_roll")
    model = make_model(_port_cfg(rcfg))
    rmodel = r_make_model(rcfg)
    rparams = jax.tree_util.tree_map(np.asarray,
                                     rmodel.init(jax.random.PRNGKey(0)))
    prompt = _prompt(rcfg, _inputs(rcfg, S), P)
    lg, cache = model.prefill(params_from_reference(rparams, "cpu"),
                              _t(prompt), max_len=S)
    _close(_np(lg), r["ref"]["prefill"])
    _same_cache(_np(cache), r["ref"]["prefill_cache"])
    rlg = np.asarray(rmodel.prefill(rparams, prompt, max_len=S)[0])
    assert np.abs(rlg - r["ref"]["prefill"]).max() > 1e-2


@pytest.mark.parametrize("name", GEN_SMOKE)
def test_generate_greedy_matches_reference(name):
    """``generate`` at temperature 0 on the smoke config: the same tokens
    as the reference's, the prompt kept; the MoE configs too (their
    decode routes b tokens a step on both sides)."""
    rcfg = r_smoke(name).model
    rmodel = r_make_model(rcfg)
    rparams = jax.tree_util.tree_map(np.asarray,
                                     rmodel.init(jax.random.PRNGKey(0)))
    prompt = np.random.default_rng(5).integers(0, rcfg.vocab, (3, 12)
                                               ).astype(np.int32)
    want = np.asarray(r_generate(rmodel, rparams, prompt, 8))
    model = make_model(get_smoke_config(name).model)
    got = generate(model, params_from_reference(rparams, "cpu"),
                   torch.from_numpy(prompt), 8)
    assert got.dtype == torch.int32 and got.shape == (3, 20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_with_temperature():
    """Sampling keeps the prompt, gives (b, s + max_new) int32 tokens in
    the vocabulary, and repeats under one generator seed."""
    cfg = get_smoke_config("olmo-1b").model
    model = make_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.randint(0, cfg.vocab, (3, 5),
                           generator=torch.Generator().manual_seed(1))
    runs = [generate(model, params, prompt, 7, temperature=0.8,
                     generator=torch.Generator().manual_seed(seed))
            for seed in (4, 4, 5)]
    for out in runs:
        assert out.shape == (3, 12) and out.dtype == torch.int32
        assert torch.equal(out[:, :5], prompt.to(torch.int32))
        assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    greedy = generate(model, params, prompt, 7)
    assert torch.equal(greedy, generate(model, params, prompt, 7,
                                        temperature=0.0))


def test_generate_max_len_and_one_token():
    """``max_len`` sizes the cache past the run (the same tokens), and one
    new token runs no decode step."""
    cfg = get_smoke_config("mixtral-8x7b").model
    model = make_model(cfg)
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(3))
    out = generate(model, params, prompt, 5)
    assert torch.equal(out, generate(model, params, prompt, 5, max_len=32))
    calls = []
    step = model.decode_step
    model.decode_step = lambda *a, **k: calls.append(1) or step(*a, **k)
    one = generate(model, params, prompt, 1)
    assert calls == [] and torch.equal(one, out[:, :7])


@pytest.mark.parametrize("window", [None, 8])
def test_attention_layer_prefill_and_decode(window):
    """The GQA layer's serving functions against the reference's on one
    layer: ``attention_prefill`` over 12 rows into a 16-position cache (a
    ring of 8 with the window), then 4 ``attention_decode`` steps, each
    equal to ``attention_apply`` over the rows so far."""
    rcfg = r_attn.AttnCfg(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                          window=window)
    cfg = attention.AttnCfg(**dataclasses.asdict(rcfg))
    p = jax.tree_util.tree_map(np.asarray, r_attn.attention_init(
        jax.random.PRNGKey(0), rcfg, jnp.float32))
    x = np.random.default_rng(7).standard_normal((2, 16, 64),
                                                 dtype=np.float32)
    rcos, rsin = r_layers.rope_freqs(16, 16)
    cos, sin = layers.rope_freqs(16, 16)
    ry, rc = r_attn.attention_prefill(p, x[:, :12], rcfg, rcos, rsin, 16)
    y, c = attention.attention_prefill(_t(p), _t(x[:, :12]), cfg, cos, sin,
                                       16)
    _close(_np(y), ry)
    _same_cache({"l": _np(c)}, {"l": _np(rc)})
    full = attention.attention_apply(_t(p), _t(x), cfg, cos, sin)
    for i in range(12, 16):
        ry, rc = r_attn.attention_decode(p, x[:, i:i + 1], rc, jnp.int32(i),
                                         rcfg, rcos, rsin)
        y, c = attention.attention_decode(_t(p), _t(x[:, i:i + 1]), c, i,
                                          cfg, cos, sin)
        _close(_np(y), ry)
        _close(_np(y), _np(full[:, i:i + 1]))
    _same_cache({"l": _np(c)}, {"l": _np(rc)})


def test_train_batch_specs_match_reference():
    """``train_batch_specs``: the reference's ``ShapeDtypeStruct`` stacks
    as meta tensors, in every input mode and shape kind."""
    for name in ("olmo-1b", "musicgen-medium", "internvl2-76b"):
        rcfg, cfg = r_smoke(name).model, get_smoke_config(name).model
        for shape in ("train_4k", "decode_32k"):
            want = r_specs(rcfg, R_SHAPES[shape], 4)
            got = train_batch_specs(cfg, SHAPES[shape], 4)
            assert set(got) == set(want)
            for k, w in want.items():
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(w.shape), (name, k)
                assert str(got[k].dtype).split(".")[-1] == str(w.dtype)
    with pytest.raises(ValueError):
        train_batch_specs(get_smoke_config("olmo-1b").model,
                          SHAPES["train_4k"], 3)


def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_serve_cli_on_cpu():
    """``python -m repro_torch.launch.serve`` at ``--device cpu``: the
    shape of the batch it generated and its tok/s line."""
    out = _run(["-m", "repro_torch.launch.serve", "--arch", "olmo-1b",
                "--batch", "2", "--prompt-len", "6", "--max-new", "4",
                "--device", "cpu"])
    assert "generated (2, 10)" in out and "tok/s" in out
    out = _run(["-m", "repro_torch.launch.serve", "--arch", "mamba2-1.3b",
                "--batch", "2", "--prompt-len", "6", "--max-new", "3",
                "--temperature", "0.7", "--device", "cpu"])
    assert "generated (2, 9)" in out


def test_serve_batched_example_on_cpu():
    """``examples/torch_serve_batched.py`` serves its three cache families
    (dense KV, the ring with MoE, the SSM state) at a trimmed size."""
    out = _run([os.path.join("examples", "torch_serve_batched.py"),
                "--device", "cpu", "--batch", "2", "--prompt", "6",
                "--new", "4"])
    for arch in ("olmo-1b", "mixtral-8x7b", "mamba2-1.3b"):
        assert arch in out
    assert "served all three cache families" in out
