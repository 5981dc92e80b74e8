"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` (the
card's ones, marked ``cuda``, skip without a card)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
