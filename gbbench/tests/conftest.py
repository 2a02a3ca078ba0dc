"""gbbench's tests: the repository root on the path, and the ``cuda``
marker of the repository's card tests (``tests/conftest.py`` does not
reach this folder).  A test decides inside itself or a fixture whether
there is a card, never at import."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; the test skips without one")


@pytest.fixture
def card():
    """The card's device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
