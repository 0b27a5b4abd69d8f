"""tests/torch_threads.py: a module that imports `one_torch_thread` runs
PyTorch on one intra-op thread."""

import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_a_port_test_module_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
