"""The benchmark's own tests: ``python -m pytest annbench/tests -q`` on
any host (the card-only cases skip without a card); on the card, ``python
-m pytest annbench/tests -q -m cuda``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped on hosts without one")


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none (decided here, at run
    time, never while a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda:0")
