"""Shared fixture of the port's CPU tests."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU tests work on small tensors, where torch's intra-op
    threads gain little; one thread per test keeps parallel test workers
    from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
