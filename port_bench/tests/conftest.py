"""The benchmark's CPU tests: ``python -m pytest port_bench/tests -q`` from
the root of the repository, in a process of their own (the repository's
``tests/`` load JAX, which no benchmark run may hold). Tests of the card
path carry the ``cuda`` marker and skip without a card."""
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
