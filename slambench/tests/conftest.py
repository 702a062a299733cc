"""The benchmark's own tests: ``python -m pytest slambench/tests -q``.

Tests that need the card take the ``card`` fixture, which skips them where
no CUDA device is present; they carry the ``card`` marker, so that
``-m card`` selects them on a machine with one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cpu_threads():
    """Few torch threads: the suite runs beside other workers."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
