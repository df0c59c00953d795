"""The port's AST lint (``repro_torch.analysis.astlint``), as
``tests/test_astlint.py`` holds the reference's: each rule fires on its
seeded snippet and stays quiet on the compliant variant, the pragma
suppresses any rule, a syntax error is reported, the port lints clean, and
the CLI exits 0, 1 or 2."""
import os

import pytest

from repro_torch.analysis.astlint import lint_paths, lint_source, main

REPO = os.path.join(os.path.dirname(__file__), "..")
CORE = "src/repro_torch/core/pdsgdm.py"


def _rules(src, rel):
    return [e.rule for e in lint_source(src, rel)]


@pytest.mark.parametrize("call", ["x.item()", "x.tolist()", "x.cpu()",
                                  "x.numpy()", "torch.cuda.synchronize()",
                                  "np.asarray(x)"])
def test_host_sync_in_core(call):
    src = f"def f(x):\n    return {call}\n"
    assert _rules(src, CORE) == ["RPR001"]
    # outside core/ it is fine, and topology.py is host-side by design
    assert _rules(src, "src/repro_torch/launch/train.py") == []
    assert _rules(src, "src/repro_torch/core/topology.py") == []


def test_host_sync_rule_quiet_on_lookalikes():
    # a device move with an argument, and numpy's own array, are no reads
    assert _rules("def f(x):\n    return x.to('cpu', non_blocking=True)\n",
                  CORE) == []
    assert _rules("y = np.array([1, 2])\n", CORE) == []


def test_compressor_isinstance_dispatch():
    src = ("def f(c):\n"
           "    if isinstance(c, SignCompressor):\n"
           "        return 1\n")
    assert _rules(src, "src/repro_torch/core/cpdsgdm.py") == ["RPR002"]
    assert _rules(src, "src/repro_torch/core/wire.py") == []
    tup = "ok = isinstance(c, (TopKCompressor, int))\n"
    assert _rules(tup, "src/repro_torch/train/trainer.py") == ["RPR002"]
    assert _rules("ok = isinstance(c, int)\n", CORE) == []


def test_lane_literal():
    src = "x = y.reshape(-1, 1024)\n"
    assert _rules(src, "src/repro_torch/core/compression.py") == ["RPR003"]
    assert _rules(src, "src/repro_torch/kernels/ops.py") == []
    ok = "n_patches = 1024  # ViT patches  # lint: allow\n"
    assert _rules(ok, "src/repro_torch/configs/base.py") == []
    assert _rules("x = 1023\n", CORE) == []
    assert _rules("x = 1024.0\n", CORE) == []


@pytest.mark.parametrize("line", [
    "torch.backends.cudnn.allow_tf32 = False",
    "torch.backends.cuda.matmul.allow_tf32 = True",
    "torch.set_default_dtype(torch.float64)",
    "torch.use_deterministic_algorithms(True)",
])
def test_config_at_import(line):
    src = f"import torch\n{line}\n"
    assert _rules(src, "src/repro_torch/launch/train.py") == ["RPR004"]
    # repro_torch/__init__.py is the one allowed site
    assert _rules(src, "src/repro_torch/__init__.py") == []
    # inside a function it is a runtime setting
    fn = f"import torch\ndef setup():\n    {line}\n"
    assert _rules(fn, "src/repro_torch/launch/train.py") == []


def test_pragma_suppresses_any_rule():
    src = "def f(x):\n    return x.item()  # lint: allow\n"
    assert _rules(src, CORE) == []


def test_syntax_error_reported():
    out = lint_source("def f(:\n", "src/broken.py")
    assert out and out[0].rule == "RPR000"


def test_port_lints_clean():
    errors = lint_paths([os.path.join(REPO, "src", "repro_torch")],
                        base=REPO)
    assert errors == [], "\n".join(str(e) for e in errors)


def test_cli_exit_codes(tmp_path):
    assert main([]) == 0                          # src/repro_torch
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert main([str(clean)]) == 0
    dirty = tmp_path / "repro_torch" / "core" / "dirty.py"
    dirty.parent.mkdir(parents=True)
    dirty.write_text("def f(x):\n    return x.item()\n")
    assert main([str(dirty)]) == 1
    assert main([str(tmp_path / "missing_dir")]) == 2
