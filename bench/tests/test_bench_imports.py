"""The import guard: what the benchmark runs loads neither JAX nor the JAX
package (``repro``, compared as a whole top-level name: ``repro_torch``
begins with it), and the reference loads nothing of the program."""
import ast
import json
import subprocess
import sys

import pytest

from bench.spec import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PROGRAM = {"repro_torch"}


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def _top_names(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_tiny_run_loads_no_jax(tiny_root):
    code = f"""
import json, sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import torch
torch.set_num_threads(1)
from pathlib import Path
from bench import harness, spec
from bench.run import forbidden_modules
cell = spec.load("tiny-ssd.pd", root=Path({str(tiny_root)!r}))
r = harness.run(cell, 5, 0.05, True, "cpu", time.perf_counter(),
                log=lambda m: None)
print(json.dumps({{"correct": r["correct"], "bad": forbidden_modules(),
                  "program": "repro_torch" in sys.modules}}))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "bad": [], "program": True}


def test_reference_loads_nothing_of_the_program():
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}]
import bench.reference.common, bench.reference.dense_lm
import bench.reference.mamba2_lm, bench.reference.pd_sgdm
import bench.reference.cpd_sgdm_sign
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in {sorted(FORBIDDEN | PROGRAM)})))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted((ROOT / "bench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    names = _top_names(path)
    assert not names & FORBIDDEN
    rel = path.relative_to(ROOT / "bench")
    if rel.parts[0] == "reference":
        assert not names & PROGRAM
    # only the program's adapter and tests that break the program touch it
    if names & PROGRAM:
        assert rel.name in ("program.py", "test_bench_faults.py")


def test_whole_names_are_compared(monkeypatch):
    from bench.run import forbidden_modules
    monkeypatch.setitem(sys.modules, "repro_torch_fake_mod", sys)
    assert "repro_torch_fake_mod" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake_mod", sys)
    assert "repro.fake_mod" in forbidden_modules()


def test_benchmark_reads_nothing_of_the_jax_benchmarks():
    for path in (ROOT / "bench").rglob("*.py"):
        assert "benchmarks" not in _top_names(path)


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "olmo-1b.pd-ring8.p4", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
