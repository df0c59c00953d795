"""A configuration, a traffic mix and a per-layer metric are found by
name: a throwaway one of each, dropped into a copy of the tree as new
files plus new entries of ``BENCHMARK.json``, runs with no other edit."""
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
