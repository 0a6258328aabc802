"""Fixtures of the benchmark's CPU tests (helpers in `bench_tiny.py`)."""

from __future__ import annotations

import pytest
import torch

from bench_tiny import TINY_MODELS, write_checkout


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips elsewhere")


@pytest.fixture(autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def tiny_models(monkeypatch):
    """The tiny model registered in the program's model table."""
    from fast_dit_torch.models import dit

    monkeypatch.setitem(dit.DiT_models, "DiT-T/8", dit.dit_config(*TINY_MODELS["DiT-T/8"]))


@pytest.fixture
def checkout(tmp_path):
    return write_checkout(tmp_path)


@pytest.fixture
def card():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (on the card: python -m pytest h100_bench/tests -m cuda)")
    return torch.device("cuda", 0)
