"""Tiny cuts of the real cells, for the CPU tests: ``build_tiny_root``
writes a checkout-like tree whose ``BENCHMARK.json`` names tiny cuts of
the real configurations and traffic mixes (the widths cut so that a run
takes a second on the CPU), each tiny cell with the limits of the real
cell it cuts."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# tiny cell -> (real cell, config cut, traffic cut)
TINY = {
    "tiny-dense.pd": ("olmo-1b.pd-ring8.p4",
                      dict(d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
                           vocab=96, n_layers=2),
                      dict(workers=4, seq=16, batch=2)),
    "tiny-ssd.pd": ("mamba2-1.3b.pd-ring8.p4",
                    dict(d_model=32, ssm_state=8, ssm_headdim=8,
                         ssm_chunk=8, vocab=96, n_heads=4, n_kv_heads=4),
                    dict(workers=4, seq=16, batch=1)),
    "tiny-dense.cpd": ("olmo-1b.cpd-sign-ring8.p4",
                       dict(d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
                            vocab=96, n_layers=2),
                       dict(workers=4, seq=16, batch=2)),
}


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def build_tiny_root(dest: Path) -> Path:
    """Write the tiny tree under ``dest``: its ``BENCHMARK.json`` and the
    files it names, and a copy of the metric readers."""
    bench = _read(ROOT / "BENCHMARK.json")
    real = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    (dest / "bench" / "configs").mkdir(parents=True)
    (dest / "bench" / "traffic").mkdir()
    (dest / "bench" / "limits").mkdir()
    shutil.copytree(ROOT / "bench" / "metrics", dest / "bench" / "metrics")
    out = dict(bench, configs=[], workloads=[])
    for name, (src, ccut, tcut) in TINY.items():
        w = real[src]
        cname, tname = f"{name}.config", f"{name}.traffic"
        cfg = _read(ROOT / configs[w["config"]]["file"])
        cfg["model"].update(ccut)
        with open(dest / "bench" / "configs" / f"{cname}.json", "w") as f:
            json.dump(cfg, f)
        traffic = _read(ROOT / "bench" / "traffic" / f"{w['traffic']}.json")
        traffic.update(tcut)
        with open(dest / "bench" / "traffic" / f"{tname}.json", "w") as f:
            json.dump(traffic, f)
        limits = ROOT / "bench" / "limits" / f"{src}.json"
        if limits.exists():
            shutil.copy(limits, dest / "bench" / "limits" / f"{name}.json")
        out["configs"].append(dict(configs[w["config"]], name=cname,
                                   file=f"bench/configs/{cname}.json"))
        out["workloads"].append(dict(w, name=name, config=cname,
                                     traffic=tname))
    for m in out["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [n for n, (src, _c, _t) in TINY.items()
                              if src in m["workloads"]]
    with open(dest / "BENCHMARK.json", "w") as f:
        json.dump(out, f, indent=1)
    return dest
