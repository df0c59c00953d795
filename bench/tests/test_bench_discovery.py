"""A configuration, a traffic mix and a per-layer metric are found by
name: a throwaway one of each, dropped into a copy of the tree as new
files plus new entries of ``BENCHMARK.json``, runs with no other edit.
So does a metric that reads the program's counters."""
import importlib
import json
import shutil
import time

from bench import harness, spec


def test_new_files_are_found_by_name(tiny_root, tmp_path):
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "bench" / "configs" /
                      "tiny-dense.pd.config.json").read_text())
    cfg["model"].update(d_model=48, n_heads=6, n_kv_heads=2, d_ff=96,
                        gated_mlp=True, norm="rmsnorm", n_layers=1)
    (root / "bench" / "configs" / "throwaway.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((root / "bench" / "traffic" /
                          "tiny-dense.pd.traffic.json").read_text())
    traffic.update(workers=3, seq=8, batch=3, p=2)
    (root / "bench" / "traffic" / "throwaway-mix.json").write_text(
        json.dumps(traffic))
    (root / "bench" / "metrics" / "throwaway_rounds.py").write_text(
        "def read(trace):\n    return float(trace.rounds)\n")
    (root / "bench" / "limits" / "throwaway.cell.json").write_text(
        (root / "bench" / "limits" / "tiny-dense.pd.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="throwaway",
                                 file="bench/configs/throwaway.json"))
    bench["workloads"].append({"name": "throwaway.cell",
                               "config": "throwaway",
                               "traffic": "throwaway-mix", "chips": 1,
                               "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "throwaway_rounds", "unit": "rounds",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "tokens_per_s",
                               "workloads": ["throwaway.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load("throwaway.cell", root=root)
    assert cell.model["d_model"] == 48 and cell.traffic["workers"] == 3
    assert "throwaway_rounds" in [m["name"] for m in cell.per_layer]
    assert "throwaway_rounds" not in [
        m["name"] for m in spec.load("tiny-dense.pd", root=root).per_layer]

    timed = harness.run(cell, 7, 0.05, False, "cpu", time.perf_counter(),
                        log=lambda m: None)
    assert timed["correct"], timed["checks"]
    assert "tokens_per_s" in timed["metrics"]
    traced = harness.run(cell, 8, 0.05, True, "cpu", time.perf_counter(),
                         log=lambda m: None)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["throwaway_rounds"]["value"] == \
        harness.TRACE_ROUNDS


COUNTER_READER = """import json
from pathlib import Path


def read(trace):
    Path(__file__).with_suffix(".seen.json").write_text(
        json.dumps(trace.counters))
    return float(trace.counters["momentum_update"])
"""


# each kernel wrapper's launches, as the program's
# ``analysis.round_check.kernel_launches`` lists them, and the momentum
# launch's leaf counters
COUNTERS = {"momentum_update", "gossip_mix", "sign_pack", "sign_unpack",
            "qsgd_quant", "qsgd_dequant", "topk_select", "topk_scatter",
            "row_gather", "row_scatter", "momentum_update.leaf_reads",
            "momentum_update.leaf_copies"}
MOMENTUM = "repro_torch.kernels.momentum"


def test_a_counter_metric_is_found_by_name(tiny_root, tmp_path,
                                           monkeypatch):
    # a throwaway metric that reads trace.counters, dropped in as a file
    # and an entry; it sees every counter, each as its change over the
    # traced window
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "bench" / "metrics" / "throwaway_counter.py").write_text(
        COUNTER_READER)
    bench["per_layer"].append({"name": "throwaway_counter",
                               "unit": "launches", "better": "lower",
                               "source": "program_counter",
                               "layer": "kernels", "moves": "tokens_per_s",
                               "workloads": ["tiny-dense.pd"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    # the CPU's plain momentum counts no launch: count each call of it as
    # the card's wrapper counts its launch, one a step
    plain = f"{MOMENTUM}.momentum_update_ref"
    monkeypatch.setattr(plain, _counted(plain))
    cell = spec.load("tiny-dense.pd", root=root)
    traced = harness.run(cell, 9, 0.05, True, "cpu", time.perf_counter(),
                         log=lambda m: None)
    assert traced["correct"], traced["checks"]
    seen = json.loads((root / "bench" / "metrics" /
                       "throwaway_counter.seen.json").read_text())
    assert set(seen) == COUNTERS
    steps = harness.TRACE_ROUNDS * cell.traffic["p"]
    assert traced["metrics"]["throwaway_counter"]["value"] == steps
    assert seen == dict.fromkeys(COUNTERS, 0) | {"momentum_update": steps}


def _counted(target: str):
    """``target`` (a dotted name), which bumps the momentum wrapper's
    launch counter at each call."""
    module, name = target.rsplit(".", 1)
    mod = importlib.import_module(module)
    fn = getattr(mod, name)

    def counted(*args, **kwargs):
        mod.momentum_update.launches += 1
        return fn(*args, **kwargs)
    return counted
