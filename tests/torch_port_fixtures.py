"""A fixture shared by the PyTorch port's CPU tests (tests/test_torch_*.py).

Import it into a test module by name:
    from tests.torch_port_fixtures import few_torch_threads  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """One intra-op thread while a module's tests run: tier-1 runs several
    test workers on one host, and torch's default of one thread per core
    in each of them oversubscribes it many times over (a tiny training run
    went from 0.5 s alone to 71 s under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
