"""Tests of the benchmark harness, on the CPU unless marked `card`.

Run from the root of a checkout: `python -m pytest portbench/tests -q`.
Tests marked `card` need an NVIDIA card; each decides inside itself,
through the `card` fixture, and skips where there is none."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.cuda.get_device_name(0)
