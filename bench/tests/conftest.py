"""Fixtures of the benchmark's CPU tests.

``cuda`` marks a test that needs an NVIDIA card; it decides inside its
body whether to skip.  ``tiny_root`` is a checkout-like tree whose
``BENCHMARK.json`` names tiny cuts of the real configurations and
traffic mixes (the widths cut so that a run takes a second on the CPU),
each tiny cell with the limits of the real cell it cuts.
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from bench_tiny import build_tiny_root  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without them)")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return build_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite runs several test processes at once."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
