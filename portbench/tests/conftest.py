"""The benchmark's tests: the ``cuda`` marker and the card fixture."""

from __future__ import annotations

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card; skips without one (on the card: "
        "python -m pytest -m cuda portbench/tests)",
    )


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
