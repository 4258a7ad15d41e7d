"""One intra-op thread for the port's plain PyTorch versions on the CPU.

Their SGM and DP recurrences are loops of thousands of small operations.
Under several test workers, torch's default of one intra-op thread per
core oversubscribes the CPU: six workers running a teddy-size sharded
test took over 600 s each at 8 threads and 8.5 s at 1.  A test module
opts in with ``from .torch_threads import one_torch_thread  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
