"""ptbench's tests: the benchmark's plumbing, reference and check on the CPU
at sizes a test run holds; card tests carry the ``cuda`` marker and skip
here (the decision is made in the ``card`` fixture, never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark measures the card)")
    return torch.device("cuda")


@pytest.fixture
def bench():
    from ptbench.manifest import Bench

    return Bench(ROOT)
