"""The FLOP and byte counters at the published shapes, against numbers
worked by hand, and the reference's leaves against the program's.  The
MLA and MoE counts are of model dicts written here, at published widths,
as a configuration's file would state them."""
import json
import math

import pytest

from bench import yardstick
from bench.reference import dense_lm, mamba2_lm
from bench.harness import Traced
from bench.spec import ROOT, reader


def _model(name):
    with open(ROOT / "bench" / "configs" / f"{name}.json") as f:
        return json.load(f)["model"]


OLMO, MAMBA = _model("olmo-1b"), _model("mamba2-1.3b")
PEAKS = {"hbm_bytes_per_s": 3.35e12}


def test_olmo_params_and_rows():
    shapes = dense_lm.param_shapes(OLMO)
    # 50,304 × 2,048 (the embedding, tied to the head) + 4 × 2,048²
    # + 3 × 2,048 × 8,192 (SwiGLU)
    assert yardstick.param_count(shapes) == 170_131_456
    # every leaf fills whole rows of 1,024; 166,144 is a multiple of 256
    assert yardstick.layout_rows(shapes) == (166_144, 166_144)


def test_mamba2_params_and_rows():
    shapes = mamba2_lm.param_shapes(MAMBA)
    # the embedding, tied to the head, 50,288 × 2,048; in_proj 2,048 ×
    # 8,512; out_proj 4,096 × 2,048; conv 4 × 4,352 + 4,352; 3 × 64 head
    # scalars; the gated norm 4,096 and two RMSNorms 2,048
    assert yardstick.param_count(shapes) == 128_841_152
    # 125,825 rows in use, padded to 492 blocks of 256
    assert yardstick.layout_rows(shapes) == (125_952, 125_825)


def test_kernel_bounds_at_olmo_plan():
    elems = 166_144 * 1024
    # 5 streams of 8 × 166,144 × 1,024 f32 = 27.22 GB at 3.35 TB/s
    assert yardstick.bound_ms(yardstick.momentum_bytes(8, elems),
                              PEAKS) == pytest.approx(8.1257, abs=5e-4)
    assert yardstick.bound_ms(yardstick.gossip_bytes(8, elems),
                              PEAKS) == pytest.approx(3.2503, abs=5e-4)


def test_sign_codec_bytes():
    # one worker, one full block: pack reads 4,096 + 4 B, writes 128 + 4;
    # unpack reads 132, writes 4,096
    assert yardstick.sign_codec_bytes(1, 1024, 1) == 4100 + 132 + 132 + 4096
    assert yardstick.sign_codec_bytes(8, 2048, 2) == 8 * (
        8192 + 8 + 264 + 264 + 8192)


def test_olmo_flops_per_token():
    # matmul params: 4 × 2,048² + 3 × 2,048 × 8,192 + 2,048 × 50,304 (the
    # tied head multiplies once a token, as an untied one would)
    assert yardstick.matmul_params(OLMO) == 170_131_456
    # 6 × that, plus 12 × 2,048 × 2,048 for the scores and weighted values
    assert yardstick.model_flops_per_token(OLMO, 2048) == \
        6 * 170_131_456 + 12 * 2048 * 2048


def test_mamba2_flops_per_token():
    assert yardstick.matmul_params(MAMBA) == (2048 * 8512 + 4096 * 2048
                                              + 2048 * 50288)
    # 3 × 64 heads × (2·256·128 + 2·256·64 + 4·128·64); Q, the chunk, 256
    assert yardstick.ssd_flops_per_token(MAMBA, 2048) == \
        3 * 64 * (65536 + 32768 + 32768)
    assert yardstick.attention_flops_per_token(MAMBA, 2048) == 0


@pytest.mark.parametrize("ref,model", [(dense_lm, OLMO),
                                       (mamba2_lm, MAMBA)])
def test_reference_leaves_are_the_programs(ref, model):
    from bench.program import Program
    traffic = {"topology": "ring", "workers": 8, "optimizer": "pd_sgdm",
               "eta": 0.25, "mu": 0.9, "p": 4, "weight_decay": 1e-4}
    prog = Program(model, traffic, "cpu")
    assert prog.param_shapes() == ref.param_shapes(model)
    assert prog.self_weight == pytest.approx(1 / 3)


# DeepSeek-V2-Lite (deepseek-ai/DeepSeek-V2-Lite, config.json), cut as a
# card's share: the leading dense layer and 4 expert layers, 8 of the 64
# routed experts held, 12,800 of 102,400 vocabulary rows
DEEPSEEK_V2_LITE = {
    "n_layers": 5, "d_model": 2048, "n_heads": 16, "n_kv_heads": 16,
    "d_ff": 10944, "vocab": 12800, "gated_mlp": True,
    "tie_embeddings": False,
    "pattern": [{"mixer": "mla", "ffn": "dense"}]
    + [{"mixer": "mla", "ffn": "moe"}] * 4,
    "q_lora_rank": 0, "kv_lora_rank": 512, "qk_nope_dim": 128,
    "qk_rope_dim": 64, "v_head_dim": 128,
    "n_experts": 64, "top_k": 6, "experts_held": 8, "n_shared_experts": 2,
    "moe_d_ff": 1408, "compute_dtype": "float32"}
# Mixtral-8x7B, one layer: GQA 32/8 heads of 128, 8 experts of 14,336,
# top 2, a window of 4,096
MIXTRAL = {
    "n_layers": 1, "d_model": 4096, "n_heads": 32, "n_kv_heads": 8,
    "d_ff": 14336, "vocab": 32000, "gated_mlp": True, "window": 4096,
    "pattern": [{"mixer": "attn", "ffn": "moe"}],
    "n_experts": 8, "top_k": 2}
# MiniCPM3-4B, one layer, untied: MLA through a q latent of 768
MINICPM3 = {
    "n_layers": 1, "d_model": 2560, "n_heads": 40, "n_kv_heads": 40,
    "d_ff": 6400, "vocab": 73448, "gated_mlp": True,
    "tie_embeddings": False,
    "pattern": [{"mixer": "mla", "ffn": "dense"}],
    "q_lora_rank": 768, "kv_lora_rank": 256, "qk_nope_dim": 64,
    "qk_rope_dim": 32, "v_head_dim": 64}


def test_deepseek_v2_lite_cut_counts():
    # MLA a layer: q 2,048 × 16 × 192 (no q latent), kv_a 2,048 × 576,
    # kv_b 512 × 16 × 256, o 16 × 128 × 2,048: 13,762,560, five times
    mla = 5 * (6_291_456 + 1_179_648 + 2_097_152 + 4_194_304)
    dense = 3 * 2048 * 10944
    # an expert layer: router 2,048 × 64; 6 slots × 8 / 64 held of
    # 3 × 2,048 × 1,408 each; 2 shared experts of the same width
    moe = 4 * (2048 * 64 + 6 * 8 * 8_650_752 // 64 + 2 * 8_650_752)
    assert mla + dense + moe + 2048 * 12800 == 257_949_696
    assert yardstick.matmul_params(DEEPSEEK_V2_LITE) == 257_949_696
    # 6 × 2,048 keys × 16 heads × (192 + 128) a layer, five layers
    assert yardstick.attention_flops_per_token(DEEPSEEK_V2_LITE, 2048) == \
        5 * 6 * 2048 * 16 * 320 == 314_572_800
    assert yardstick.model_flops_per_token(DEEPSEEK_V2_LITE, 2048) == \
        6 * 257_949_696 + 314_572_800 == 1_862_270_976


def test_mixtral_layer_counts():
    # attention 4,096 × 128 × (2 × 32 + 2 × 8); router 4,096 × 8; two of
    # the 8 experts of 3 × 4,096 × 14,336 a token; the head 4,096 × 32,000
    assert yardstick.matmul_params(MIXTRAL) == (
        41_943_040 + 32_768 + 2 * 176_160_768 + 131_072_000) == 525_369_344
    # at 2,048 the window of 4,096 cuts nothing: 12 × 4,096 × 2,048
    assert yardstick.attention_flops_per_token(MIXTRAL, 2048) == \
        12 * 4096 * 2048 == 100_663_296
    # at 8,192 a query sees 4,096 keys: half of the whole matrix's count
    assert yardstick.attention_flops_per_token(MIXTRAL, 8192) == \
        12 * 4096 * 8192 / 2


def test_minicpm3_layer_counts():
    # q 2,560 × 768 + 768 × 40 × 96; kv_a 2,560 × 288; kv_b 256 × 40 ×
    # 128; o 40 × 64 × 2,560; SwiGLU 3 × 2,560 × 6,400; head 2,560 ×
    # 73,448
    assert yardstick.matmul_params(MINICPM3) == (
        4_915_200 + 737_280 + 1_310_720 + 6_553_600 + 49_152_000
        + 188_026_880) == 250_695_680
    # 6 × 2,048 × 40 × (96 + 64)
    assert yardstick.attention_flops_per_token(MINICPM3, 2048) == \
        78_643_200


@pytest.mark.parametrize("mixer", ["attn", "mla", "mamba"])
@pytest.mark.parametrize("ffn", ["dense", "moe", "dense+moe", "none"])
def test_every_layer_kind_is_counted(mixer, ffn):
    model = dict(DEEPSEEK_V2_LITE, n_layers=1,
                 pattern=[{"mixer": mixer, "ffn": ffn}], ssm_state=128,
                 ssm_headdim=64, ssm_expand=2, ssm_chunk=256)
    flops = yardstick.model_flops_per_token(model, 2048)
    assert math.isfinite(flops) and flops > 6 * 2048 * 12800


def test_moe_keys_default_to_the_programs_fields():
    # no expert width, shared expert or held share stated: d_ff, none,
    # every expert
    plain = {k: v for k, v in DEEPSEEK_V2_LITE.items()
             if k not in ("moe_d_ff", "n_shared_experts", "experts_held")}
    assert yardstick.moe_params(plain) == \
        2048 * 64 + 6 * 3 * 2048 * 10944
    # a share that is not whole: router 2 × 3, one slot of 1 of 3
    # experts of 2 × 2 × 1
    tiny = {"d_model": 2, "d_ff": 1, "gated_mlp": False, "n_experts": 3,
            "top_k": 1, "experts_held": 1}
    assert yardstick.moe_params(tiny) == pytest.approx(6 + 4 / 3)


def test_step_mfu_reads_an_mla_and_moe_model():
    traced = Traced(dev=[], window_s=1.0, busy_s=1.0, rounds=1,
                    tokens=65536, seq=2048, workers=8, elems=1, blocks=1,
                    model=DEEPSEEK_V2_LITE,
                    peaks={"f32_flops_per_s": 67e12}, ms_by_kind={})

    class Root:
        root = ROOT
    mfu = reader(Root(), "step_mfu_pct")(traced)
    assert math.isfinite(mfu)
    assert mfu == pytest.approx(100 * 1_862_270_976 * 65536 / 67e12)
