"""Tests of the benchmark harness. Run from the repository root:

    python -m pytest perfbench/tests -q

The CPU tests drive the harness on tiny copies of the cells (``tiny.py``)
with the compositor's plain torch version; tests marked ``cuda`` need the
card and skip here."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
