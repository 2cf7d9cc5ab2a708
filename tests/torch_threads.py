"""The port's tests' shared autouse fixture (imports no JAX).

A test file takes it with ``from torch_threads import _one_thread``.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tiny models run many small ops, and the
    suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
