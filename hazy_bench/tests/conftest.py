"""The benchmark's own tests: `python -m pytest hazy_bench/tests` from the
checkout's root (the CPU cases, tiny tables, plain kernel versions);
`-m card` on a machine with a GPU runs the cases marked `card`."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the case runs on the card")
    return "cuda"
