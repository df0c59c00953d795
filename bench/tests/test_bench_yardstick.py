"""The FLOP and byte counters at the published shapes, against numbers
worked by hand, and the reference's leaves against the program's."""
import json

import pytest

from bench import yardstick
from bench.reference import dense_lm, mamba2_lm
from bench.spec import ROOT


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
