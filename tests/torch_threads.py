"""The port's test modules run PyTorch on one intra-op thread.

Each `test_torch_*` module imports `one_torch_thread`, an autouse module
fixture: the test workers share the machine's cores, and each worker's
spinning OpenMP threads multiplied the port's CPU time several times over.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
