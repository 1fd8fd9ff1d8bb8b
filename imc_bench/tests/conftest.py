"""The benchmark's tests: ``python -m pytest -q imc_bench/tests`` from the
checkout's root.  Tests marked ``card`` need a CUDA device and skip
without one; whether there is one is decided in the ``card`` fixture."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on the card")
    return torch.device("cuda")
