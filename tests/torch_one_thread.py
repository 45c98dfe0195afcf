"""A module-scoped autouse fixture for the port's CPU tests at small
shapes: import ``one_thread`` into a test file to run it on one intra-op
thread. Beside the other test workers, a worker's many threads spin
against each other and its small ops run tens of times slower."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
