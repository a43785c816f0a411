"""Tests of the benchmark itself. Run them on the CPU from the root of the
checkout with ``python3 -m pytest benchmark/tests -q``; the repository's
``pytest tests/`` does not collect them. Tests marked ``chip`` need a CUDA
card and skip without one (``python3 -m pytest benchmark/tests -q -m chip``
on the card)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with -m chip on the card")
    return "cuda"
