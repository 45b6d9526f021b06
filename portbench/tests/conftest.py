"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from the
repository root (CPU; the ``card`` tests skip there) and
``python -m pytest portbench/tests -q -m card`` on a machine with a CUDA card."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """Workers of pytest-xdist share the cores: two threads each."""
    import torch

    torch.set_num_threads(2)


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
