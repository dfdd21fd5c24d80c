"""One intra-op thread for a test module's small CPU tensors.

The suite runs several pytest workers on one CPU, and each worker's
torch would otherwise start as many intra-op threads as there are cores:
many tiny ops on full thread pools then spin against each other (on an
8-core CPU beside a whole-suite run of 6 workers, a robust-design module
took 8 times as long as on one thread). A module imports ``one_thread``
to use it; the count is restored after the module, for the JAX package's
tests that share the worker.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
