"""DeepSeek-V2's layers in the port against the benchmark's plain
reference (``bench/reference/deepseek_v2_lm.py``), on seeded random
weights at a tiny cut.

* MLA with a direct query (``q_lora_rank`` 0): ``mla_apply`` against the
  reference's layer, and ``mla_prefill`` of a prompt then ``mla_decode``
  of the rest against the full forward;
* the expert layer with shared experts, an expert width other than
  ``d_ff`` and the top-k gates left un-normalised, at a capacity that
  drops slots, whole and as a share of the experts;
* the share test: the 8 shares ``first = 0, 8, …, 56`` of a 64-expert
  layer, with the shared experts counted once, sum to the uncut layer;
* the whole model's loss, and its gradients for two stacked workers under
  ``vmap``, against the reference worker by worker;
* the cut's parameter count and the sharded plan's refusal.

Both sides compute in f32 on the CPU and sum in other orders (the
reference's matmuls by head and by expert, the port's batched), so the
bars are ``tests/test_torch_models.py``'s: values atol 1e-5 / rtol 1e-5,
gradients each within 1e-5 of the largest gradient's max norm.  The
routing is integer work on gates that differ by far more than rounding
(continuous draws), so the same slots are kept and dropped on both
sides.
"""
import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.reference import deepseek_v2_lm as ref  # noqa: E402
from bench.reference.common import Ops  # noqa: E402
from repro_torch.configs.base import LayerSpec, ModelCfg  # noqa: E402
from repro_torch.launch.sharding import shard_plan  # noqa: E402
from repro_torch.models import attention, layers, make_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ATOL = RTOL = 1e-5
GRAD_FRAC = 1e-5
OPS = Ops("f32")

# DeepSeek-V2-Lite's structure at a tiny cut: a dense layer and two expert
# layers, MLA with a direct query, 8 experts of width 12 (d_ff 48), top 3
# with 2 held, 2 shared experts, gates not renormalised, capacity factor 1
TINY = {
    "name": "tiny-deepseek", "arch_type": "moe", "n_layers": 3,
    "d_model": 32, "n_heads": 4, "n_kv_heads": 4, "d_ff": 48, "vocab": 64,
    "norm": "rmsnorm", "rope_theta": 10000.0, "gated_mlp": True,
    "tie_embeddings": False,
    "pattern": [{"mixer": "mla", "ffn": "dense"},
                {"mixer": "mla", "ffn": "moe"},
                {"mixer": "mla", "ffn": "moe"}],
    "n_experts": 8, "top_k": 3, "capacity_factor": 1.0,
    "router_aux_weight": 0.01, "moe_d_ff": 12, "n_shared_experts": 2,
    "experts_held": 2, "moe_norm_topk": False, "use_mla": True,
    "q_lora_rank": 0, "kv_lora_rank": 16, "qk_nope_dim": 8,
    "qk_rope_dim": 4, "v_head_dim": 8}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensor ops (the suite
    runs several test processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(model: dict) -> ModelCfg:
    return ModelCfg(**dict(model, pattern=tuple(LayerSpec(**p)
                                               for p in model["pattern"])))


def _randn(shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float32) * scale


def _weights(shapes: dict, seed: int) -> dict:
    """Every leaf a normal of std fan-in^-0.5 (1 + noise for a norm's
    scale, so that a scale's gradient is checked off its init)."""
    out = {}
    for i, (name, shape) in enumerate(shapes.items()):
        if name.endswith("scale"):
            out[name] = 1.0 + _randn(shape, seed * 1000 + i, 0.1)
        elif name.endswith("table"):
            out[name] = _randn(shape, seed * 1000 + i)
        else:
            out[name] = _randn(shape, seed * 1000 + i, shape[-2] ** -0.5)
    return out


def _nest(flat: dict) -> dict:
    """Leaf names ``a.b.w`` to the port's nested ``{"a": {"b": {"w"}}}``."""
    out: dict = {}
    for name, t in flat.items():
        node = out
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return out


def _attn_cfg(model: dict) -> attention.AttnCfg:
    return make_model(_cfg(model)).attn_cfg


MLA_LEAVES = ("wq.w", "wdkv.w", "kv_norm.scale", "wkr.w", "wuk.w", "wuv.w",
              "wo.w")


def _mla_params(model: dict, seed: int) -> dict:
    """One MLA layer's leaves (flat, without the repeat dim)."""
    shapes = {n.split("attn.", 1)[1]: s[1:]
              for n, s in ref.param_shapes(model).items()
              if n.startswith("blocks.pos0.attn.")}
    assert sorted(shapes) == sorted(MLA_LEAVES)
    return _weights(shapes, seed)


def _ref_layer(flat: dict) -> dict:
    """Flat leaves (``wq.w``, ``kv_norm.scale``, ``shared.wg.w``) as the
    reference's layer functions take them."""
    out: dict = {}
    for name, t in flat.items():
        parts = [p for p in name.split(".") if p not in ("w", "scale")]
        node = out
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = t
    return out


def _rope(model, s):
    return layers.rope_freqs(model["qk_rope_dim"], s, model["rope_theta"])


# ---------------------------------------------------------------- MLA
def test_mla_direct_query_matches_reference():
    p = _mla_params(TINY, seed=1)
    x = _randn((2, 16, 32), 2)
    cos, sin = _rope(TINY, 16)
    got = attention.mla_apply(_nest(p), x, _attn_cfg(TINY), cos, sin)
    want = ref.mla(_ref_layer(p), x, TINY, OPS)
    assert got.shape == (2, 16, 32)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    # a direct query: the model declares wq and no q latent
    names = make_model(_cfg(TINY)).param_shapes()
    assert "blocks.pos0.attn.wq.w" in names
    assert not any(".wdq." in n or ".wuq." in n or ".q_norm." in n
                   for n in names)


def test_mla_direct_query_prefill_then_decode_equals_full_forward():
    p = _nest(_mla_params(TINY, seed=3))
    cfg = _attn_cfg(TINY)
    x = _randn((2, 12, 32), 4)
    cos, sin = _rope(TINY, 12)
    full = attention.mla_apply(p, x, cfg, cos, sin)
    y, cache = attention.mla_prefill(p, x[:, :7], cfg, cos, sin, 12)
    torch.testing.assert_close(y, full[:, :7], atol=ATOL, rtol=RTOL)
    for pos in range(7, 12):
        y, cache = attention.mla_decode(p, x[:, pos:pos + 1], cache, pos,
                                        cfg, cos, sin)
        torch.testing.assert_close(y, full[:, pos:pos + 1], atol=ATOL,
                                   rtol=RTOL)


# ---------------------------------------------------------------- MoE
def _moe_model(**kw) -> dict:
    return dict(TINY, **kw)


def _moe_params(model: dict, seed: int) -> dict:
    """One expert layer's leaves (flat, without the repeat dim)."""
    shapes = {n.split("moe.", 1)[1]: s[1:]
              for n, s in ref.param_shapes(model).items()
              if n.startswith("blocks.pos1.moe.")}
    return _weights(shapes, seed)


def _moe_cfg(model: dict, first: int = 0) -> moe.MoECfg:
    return dataclasses.replace(make_model(_cfg(model)).moe_cfg, first=first)


def _port_moe(p: dict, x, model: dict, first: int = 0):
    return moe.moe_apply(_nest(p), x, _moe_cfg(model, first))


@pytest.mark.parametrize("held", [8, 2])
@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_moe_layer_matches_reference(held, cf):
    """Shared experts, expert width 12 ≠ d_ff 48, un-normalised gates; at
    capacity factor 0.5 slots drop (C = 8 of 3 × 32 / 8 = 12 expected an
    expert), at 4 none do."""
    model = _moe_model(experts_held=held, capacity_factor=cf)
    p = _moe_params(model, seed=5)
    x = _randn((2, 16, 32), 6)
    y, aux = _port_moe(p, x, model)
    want_y, want_aux = ref.moe(_ref_layer(p), x, model, OPS)
    torch.testing.assert_close(y, want_y, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(aux, want_aux, atol=ATOL, rtol=RTOL)


def test_moe_capacity_drops_slots_at_factor_half():
    # the routing of the test above at capacity factor 0.5: some expert is
    # given more slots than its capacity, so the drop path is exercised
    model = _moe_model(experts_held=8, capacity_factor=0.5)
    p = _moe_params(model, seed=5)
    x = _randn((2, 16, 32), 6)
    gates = torch.softmax(x.reshape(32, 32) @ p["router.w"], -1)
    top_e = torch.topk(gates, 3, -1).indices
    counts = torch.bincount(top_e.reshape(-1), minlength=8)
    assert int(counts.max()) > moe.capacity(32, _moe_cfg(model))


def test_moe_gates_not_renormalised():
    # with norm_topk off the output is the routed sum at the raw gates:
    # renormalising changes it
    model = _moe_model(experts_held=8, capacity_factor=4.0,
                       n_shared_experts=0)
    p = _moe_params(model, seed=7)
    x = _randn((1, 8, 32), 8)
    raw, _ = _port_moe(p, x, model)
    normed, _ = _port_moe(p, x, dict(model, moe_norm_topk=True))
    torch.testing.assert_close(
        normed, ref.moe(_ref_layer(p), x, dict(model, moe_norm_topk=True),
                        OPS)[0], atol=ATOL, rtol=RTOL)
    assert not torch.allclose(raw, normed, atol=1e-3)


def test_moe_shares_sum_to_the_uncut_layer():
    """64 experts, top 6, two shared: the 8 shares of 8 experts each
    (``first`` 0, 8, …, 56), with the shared experts' output counted once,
    sum to the layer that holds all 64, and every share gives the whole
    layer's load-balance loss."""
    model = _moe_model(n_experts=64, top_k=6, experts_held=64,
                       capacity_factor=1.0)
    whole = _moe_params(model, seed=9)
    x = _randn((2, 32, 32), 10)
    uncut, uncut_aux = _port_moe(whole, x, model)
    share_model = dict(model, experts_held=8)
    shared = layers.mlp(_nest(whole)["shared"],
                        x.reshape(-1, 32)).reshape(x.shape)
    total = torch.zeros_like(uncut)
    for first in range(0, 64, 8):
        part = {n: (t[first:first + 8] if n in ("wg", "wi", "wo") else t)
                for n, t in whole.items()}
        y, aux = _port_moe(part, x, share_model, first)
        torch.testing.assert_close(aux, uncut_aux, atol=0, rtol=0)
        ry, _ = ref.moe(_ref_layer(part), x, share_model, OPS, first)
        torch.testing.assert_close(y, ry, atol=ATOL, rtol=RTOL)
        total = total + (y - shared)
    torch.testing.assert_close(total + shared, uncut, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------- the model
def _batch(seed: int, workers=None):
    shape = (2, 17) if workers is None else (workers, 2, 17)
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, TINY["vocab"], shape, generator=g)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def test_model_loss_matches_reference():
    m = make_model(_cfg(TINY))
    params = _weights(ref.param_shapes(TINY), seed=11)
    assert m.param_shapes() == {n: tuple(t.shape) for n, t in params.items()}
    batch = _batch(12)
    got, parts = m.loss(params, batch)
    want = ref.loss(params, batch, TINY, OPS)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert float(parts["aux"]) > 0


def test_model_grads_under_vmap_match_reference_per_worker():
    """Every leaf's gradient for two stacked workers through
    ``torch.func.vmap(grad_and_value)`` against the reference's autograd,
    worker by worker."""
    m = make_model(_cfg(TINY))
    ws = [_weights(ref.param_shapes(TINY), seed=s) for s in (13, 14)]
    stacked = {n: torch.stack([w[n] for w in ws]) for n in ws[0]}
    batch = _batch(15, workers=2)

    def loss(p, b):
        return m.loss(p, b)[0]
    grads, values = torch.func.vmap(torch.func.grad_and_value(loss))(
        stacked, batch)
    for k, w in enumerate(ws):
        leaves = {n: t.clone().requires_grad_(True) for n, t in w.items()}
        one = {n: t[k] for n, t in batch.items()}
        lv = ref.loss(leaves, one, TINY, OPS)
        want = dict(zip(leaves, torch.autograd.grad(lv, list(
            leaves.values()))))
        torch.testing.assert_close(values[k], lv.detach(), atol=ATOL,
                                   rtol=RTOL)
        scale = max(float(g.abs().max()) for g in want.values())
        for n, g in want.items():
            assert float(g.abs().max()) > 0, n
            torch.testing.assert_close(grads[n][k], g, rtol=0,
                                       atol=GRAD_FRAC * scale)


# ---------------------------------------------------------------- the cut
def _deepseek_cut() -> dict:
    with open(ROOT / "bench" / "configs" / "deepseek-v2-lite.json") as f:
        return json.load(f)["model"]


def test_deepseek_cut_params_count():
    # a worker's card: 5 MLA layers of 13,763,072 (the kv norm's 512
    # included), one SwiGLU of 10,944, four expert layers of 86,638,592
    # (router 2,048 × 64, 8 held experts and 2 shared of 3 × 2,048 ×
    # 1,408), 10 block norms, the final norm and an untied 12,800-row
    # embedding and head
    cfg = _cfg(_deepseek_cut())
    want = (5 * 13_763_072 + 3 * 2048 * 10944 + 4 * 86_638_592
            + 11 * 2048 + 2 * 12800 * 2048)
    assert want == 535_060_992
    m = make_model(cfg)
    assert sum(torch.Size(s).numel()
               for s in m.param_shapes().values()) == want
    # the approximate count leaves out the 25,088 norm scales
    assert cfg.params_count() == want - 5 * 512 - 11 * 2048
    # a token's active params: 6 routed experts instead of the 8 held,
    # and a router of 6 outputs
    assert cfg.active_params_count() == cfg.params_count() - 4 * (
        2 * 8_650_752 + 2048 * 58)


@pytest.mark.parametrize("field,value", [
    ("moe_d_ff", 12), ("n_shared_experts", 1), ("experts_held", 4),
    ("moe_norm_topk", False), ("q_lora_rank", 0)])
def test_shard_plan_refuses_the_new_fields(field, value):
    base = dict(TINY, moe_d_ff=None, n_shared_experts=0, experts_held=None,
                moe_norm_topk=True, q_lora_rank=24)
    cfg = _cfg(dict(base, **{field: value}))
    shapes = make_model(cfg).param_shapes()
    with pytest.raises(ValueError, match=field):
        shard_plan(cfg, shapes, 2)
    # at the defaults (MLA through a q latent) the plan is made
    plain = _cfg(base)
    assert shard_plan(plain, make_model(plain).param_shapes(), 2).size == 2
