"""The DeepSeek-V2-Lite cell (``deepseek-v2-lite.pd-ring4.p4``) and the
p = 1 OLMo cell (``olmo-1b.pd-ring8.p1``) on the CPU.

The configuration's file against the yardstick's pinned counts and the
program's leaves at full width (on the meta device); both cells as
``BENCHMARK.json`` states them; then a tiny cut of the DeepSeek cell
through the harness (``harness.run``, widths cut so that a run takes
seconds), held to the new cell's limits: the sound run is correct, and
the reference in TF32, or with its exchange left out, in the program's
place is not.  The tiny tree is built here, beside the
one ``bench_tiny.py`` builds for the older cells.
"""
import json
import shutil
import time
from pathlib import Path

import pytest

from bench import harness, judge, spec, yardstick
from bench.reference import deepseek_v2_lm

ROOT = Path(__file__).resolve().parents[2]
CELL = "deepseek-v2-lite.pd-ring4.p4"
P1 = "olmo-1b.pd-ring8.p1"
NEW_METRICS = ("mla_ms_per_round", "moe_dispatch_ms_per_round",
               "moe_experts_ms_per_round", "moe_expert_rows_per_round")
# the cell's configuration cut to a tiny width: the same pattern (one
# dense and four expert layers), MLA with a direct query, 2 shared
# experts, gates not renormalised, half of the routed experts held.  It
# routes to 2 of 8 experts, not 6 of 64: at d_model 32 a token's 6th and
# 7th of 64 gates now and then lie within the few ulps by which the
# program's and the reference's gates differ, and one slot routed apart
# moves a 32-token batch's loss by some 1e-4, where the cell's 1,024
# tokens a worker dilute it 32-fold (PERF.md, §6)
CUT = dict(d_model=32, n_heads=4, n_kv_heads=4, d_ff=48, moe_d_ff=12,
           kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8,
           vocab=96, n_experts=8, top_k=2, experts_held=4)
TRAFFIC_CUT = dict(seq=16, batch=2)


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def test_the_file_holds_the_pinned_counts():
    model = spec.load(CELL).model
    shapes = deepseek_v2_lm.param_shapes(model)
    assert yardstick.param_count(shapes) == 535_060_992
    assert yardstick.matmul_params(model) == 257_949_696
    assert yardstick.model_flops_per_token(model, 2048) == 1_862_270_976


def test_the_programs_leaves_are_the_references_at_full_width():
    from bench.program import Program
    cell = spec.load(CELL)
    prog = Program(cell.model, cell.traffic, "cpu")
    assert prog.param_shapes() == deepseek_v2_lm.param_shapes(cell.model)
    assert prog.self_weight == pytest.approx(cell.traffic["self_weight"])


def test_the_file_keeps_the_catalog_keys():
    # the published config.json's keys at the top level: the cut ones
    # beside their published values, the program's in "model"
    cfg = spec.load(CELL).config
    assert (cfg["num_hidden_layers"], cfg["n_routed_experts"],
            cfg["vocab_size"]) == (5, 8, 12800)
    assert cfg["published"]["n_routed_experts"] == 64
    model = cfg["model"]
    assert (model["n_experts"], model["experts_held"], model["top_k"],
            model["moe_d_ff"], model["n_shared_experts"]) == (
        cfg["published"]["n_routed_experts"], cfg["n_routed_experts"],
        cfg["num_experts_per_tok"], cfg["moe_intermediate_size"],
        cfg["n_shared_experts"])
    assert model["moe_norm_topk"] == cfg["norm_topk_prob"]
    assert not model["q_lora_rank"] and cfg["q_lora_rank"] is None


@pytest.mark.parametrize("name", [CELL, P1])
def test_the_new_cells_load(name):
    cell = spec.load(name)
    assert cell.chips == 1 and set(cell.limits) >= {
        "loss_gap", "grad1_gap", "change_gap", "momentum_gap"}
    metrics = {m["name"] for m in cell.per_layer}
    assert (set(NEW_METRICS) <= metrics) == (name == CELL)
    assert {"step_mfu_pct", "momentum_roofline", "grad_ms_per_round"} <= \
        metrics
    for m in NEW_METRICS:
        assert callable(spec.reader(cell, m))


def test_p1_traffic_is_the_p4_mix_at_p1():
    a = spec.load(P1).traffic
    b = spec.load("olmo-1b.pd-ring8.p4").traffic
    differ = {k for k in a if a[k] != b.get(k)}
    assert differ == {"about", "p", "check_rounds"}
    assert (a["p"], a["check_rounds"]) == (1, 4)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    """A checkout-like tree whose one cell is the DeepSeek cell cut to
    ``CUT``, with the real cell's limits and metric readers."""
    dest = tmp_path_factory.mktemp("tiny_deepseek")
    bench = _read(ROOT / "BENCHMARK.json")
    real = {w["name"]: w for w in bench["workloads"]}[CELL]
    conf = {c["name"]: c for c in bench["configs"]}[real["config"]]
    for sub in ("configs", "traffic", "limits"):
        (dest / "bench" / sub).mkdir(parents=True)
    shutil.copytree(ROOT / "bench" / "metrics", dest / "bench" / "metrics")
    cfg = _read(ROOT / conf["file"])
    cfg["model"].update(CUT)
    (dest / "bench" / "configs" / "tiny-deepseek.json").write_text(
        json.dumps(cfg))
    traffic = _read(ROOT / "bench" / "traffic" / f"{real['traffic']}.json")
    traffic.update(TRAFFIC_CUT)
    (dest / "bench" / "traffic" / "tiny-deepseek.json").write_text(
        json.dumps(traffic))
    shutil.copy(ROOT / "bench" / "limits" / f"{CELL}.json",
                dest / "bench" / "limits" / "tiny-deepseek.pd.json")
    out = dict(bench, configs=[dict(conf, name="tiny-deepseek",
                                    file="bench/configs/tiny-deepseek.json")],
               workloads=[dict(real, name="tiny-deepseek.pd",
                               config="tiny-deepseek",
                               traffic="tiny-deepseek")])
    for m in out["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny-deepseek.pd"] if CELL in m[
                "workloads"] else []
    (dest / "BENCHMARK.json").write_text(json.dumps(out, indent=1))
    return dest


SEED = 2 ** 31 + 77


def _run(root):
    cell = spec.load("tiny-deepseek.pd", root=root)
    return harness.run(cell, SEED, 0.05, False, "cpu", time.perf_counter(),
                       log=lambda m: None)


def test_tiny_cut_run_is_correct(tiny_root):
    result = _run(tiny_root)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0


def test_tiny_cut_tf32_control_is_not_correct(tiny_root):
    # the reference in TF32 (emulated on the CPU) in the program's place
    setup = harness.Setup(spec.load("tiny-deepseek.pd", root=tiny_root),
                          SEED, "cpu")
    stream = setup.stream(setup.check_steps)
    ref = harness.reference_readings(setup, stream)
    control = harness.reference_readings(setup, stream, "tf32")
    ok, checks = judge.judge(judge.numbers(control, ref), setup.cell.limits)
    assert not ok, checks


def test_tiny_cut_without_exchange_is_not_correct(tiny_root):
    # the reference with its exchange left out in the program's place
    setup = harness.Setup(spec.load("tiny-deepseek.pd", root=tiny_root),
                          SEED, "cpu")
    stream = setup.stream(setup.check_steps)
    ref = harness.reference_readings(setup, stream)
    fault = harness.reference_readings(setup, stream, fault="no_exchange")
    ok, checks = judge.judge(judge.numbers(fault, ref), setup.cell.limits)
    assert not ok, checks
