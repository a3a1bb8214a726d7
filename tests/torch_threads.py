"""One torch intra-op thread for a port test file.

Every ``tests/test_torch_*.py`` that runs on the CPU takes the fixture
with ``from torch_threads import one_torch_thread  # noqa: F401``; pytest
finds an autouse fixture in the module's namespace.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    the port's small CPU tensors gain nothing from threads that take CPU
    time from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
