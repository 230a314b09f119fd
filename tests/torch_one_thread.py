"""An autouse fixture for port test modules: their torch CPU work on one
thread.  Under pytest-xdist several test processes share the host's
cores, and torch's OpenMP regions then stall in their barriers (a
frontier test took 52 s under 4 workers against 2.8 s alone, 0.4 s on
one thread).  Import it into a module to apply it there:

    from torch_one_thread import one_torch_thread  # noqa: F401

The port's CPU results do not depend on the thread count: every test of
a module that imports it passes on one thread and on the default count.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
