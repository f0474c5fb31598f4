"""The benchmark's own tests (``python -m pytest portbench/tests``).  Tests
marked ``card`` need an NVIDIA card; a fixture skips them elsewhere."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

DATA = Path(__file__).resolve().parent / "data"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skipped without one)")


@pytest.fixture
def card():
    """The CUDA device, or a skip when there is none (decided here, at run
    time, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the chip")
    return torch.device("cuda", 0)


@pytest.fixture
def data_root():
    return DATA
