"""One intra-op thread for the port's tests on the CPU.

The port's CPU tests run tiny shapes, where torch's intra-op threads cost
more than they give; where several test processes share the cores, their
waiting threads also spin against the other processes. Each port test
module imports ``one_torch_thread``, an autouse fixture that sets one
thread for the module's tests and restores the count after them.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
