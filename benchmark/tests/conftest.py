"""The benchmark's own tests.  Tests that need a CUDA card carry the `chip`
marker and skip, inside the `card` fixture, where there is none."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the test runs on the chip")
    return torch.device("cuda", 0)
