"""One torch intra-op thread for the port's CPU tests.

The tier-1 suite runs on six workers that share the box's cores.  Each
worker's torch would start one intra-op thread per core and spin them
against the other workers': six parallel runs of one 14 s port test took
421 s so, and 21 s with one thread each.  The port's tests run many small
ops, which one thread serves as fast.  Import `one_torch_thread` into a
test module to use it there."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
