"""pytest settings of the benchmark's tests: the checkout's ``src`` on
the path (the port), and the ``cuda`` marker for tests that need the
card, which skip here when there is none. Whether a card is present is
decided inside the ``card`` fixture, never while a module is
imported."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips with a reason when "
        "torch.cuda.is_available() is False")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)
