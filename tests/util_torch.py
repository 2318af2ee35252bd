"""Shared by the port's test files (`test_torch_*.py`).

The test suite runs on several pytest-xdist worker processes at once
(ROADMAP.md, "Tier-1 verify"), each of which would otherwise give torch's
CPU kernels a thread per core. The port's tests run its plain versions on small tensors, where
those threads mostly wait for one another; with every worker doing so the
machine is oversubscribed and the whole run slows down. Each port test
module takes `one_torch_thread` (an autouse fixture, imported by name) and
runs its tests on one torch thread, restoring the count afterwards.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
