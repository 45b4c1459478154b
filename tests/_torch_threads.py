"""A module-scoped autouse fixture that runs a test module's torch ops on
two threads.

The suite runs several pytest-xdist workers on a few cores, and torch's
default of one OpenMP thread per core in every worker oversubscribes them:
the spinning threads starve the JAX side of the same tests (a comparison
that takes 6 s alone took minutes among four workers). Import it into a
test module's namespace to use it:

    from _torch_threads import two_torch_threads  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
