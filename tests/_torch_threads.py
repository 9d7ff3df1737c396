"""One intra-op thread for the port's CPU tests.

The tests run under pytest-xdist, several worker processes on the
machine's cores.  Each worker's torch would start one OpenMP thread per
core, and at the tests' small shapes every op ends in a barrier where the
threads of all the workers spin against each other: a test that takes
6 s alone took 1140 s beside five other workers.  A port test module
imports ``one_intra_op_thread``; the autouse fixture runs the module's
tests on one intra-op thread and gives the count back after.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
