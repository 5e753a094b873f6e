"""The benchmark's own tests.  Run from the checkout's root:

    python -m pytest -q perfbench/tests

Tests that need a card carry the ``card`` marker and skip without one; the
decision is made inside the ``card`` fixture."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def smoke_base(tmp_path_factory):
    from perfbench.tests import smoke
    return smoke.make_base(tmp_path_factory.mktemp("bench"))
