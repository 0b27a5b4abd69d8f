"""Tests of the benchmark (benchmark/): CPU tests at small sizes, and tests
marked ``card`` that need a CUDA device and skip without one.

Run here: ``python -m pytest benchmark/tests -p no:cacheprovider``; on a
machine with a card, the card tests: ``python -m pytest benchmark/tests -m
card -o addopts="" -p no:cacheprovider -s``.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
