"""Settings of the benchmark's own tests (`pytest portbench/tests`).

Tests that need a card carry the `card` marker and ask for the `card`
fixture, which decides whether there is one when the test runs, never when
a module is imported.  Run them one at a time (`-n 0`): a run uses every
core, and several at once starve each other.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)
