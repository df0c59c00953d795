"""Registers the marker of tests that need an NVIDIA GPU.

A ``cuda`` test decides inside its body whether a card is present and skips
otherwise; run them on a GPU machine with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without them)")
