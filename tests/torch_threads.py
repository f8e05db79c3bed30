"""One intra-op thread for the port's CPU tests.

The tier-1 run has six pytest workers on the machine's cores, and
PyTorch's default of one OpenMP/MKL thread per core in each of them
oversubscribes the CPU: the six heaviest port test files took 610 s under
`-n 6 --dist loadfile` with the default and 148 s with one thread each
(the same 42 tests passing).  Test files import `one_torch_thread`; it is
module-scoped and autouse, so module fixtures run under it too."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
