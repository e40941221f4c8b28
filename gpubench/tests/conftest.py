"""The benchmark's own tests (``python -m pytest gpubench/tests -q`` from
the root of the repository). They run on the CPU; a test that needs a card
takes the ``card`` fixture, which skips it without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")
