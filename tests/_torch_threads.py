"""One intra-op torch thread for a test module of the port.

The port's CPU tests run many small ops while the suite's workers share
the host's cores; torch's default of a thread a core per worker then
oversubscribes them, and the tests run several times slower. A module
takes the fixture by importing it (it is autouse)::

    from _torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
