"""One PyTorch intra-op thread while a test module runs.

The test command in ROADMAP.md runs the tests in 6 pytest-xdist worker
processes. PyTorch's eager CPU ops each fan out over its intra-op threads
(one per core by default in every process), whose OpenMP threads spin
while they wait for work, so where the workers' threads outnumber the
cores they contend for them: the port's driver and training tests, a few
seconds each alone on one thread, then take minutes each. A module that
imports ``torch_one_thread`` runs on one intra-op thread and sets the
count back when it ends. A module whose results depend on the thread
count (a sum split over threads rounds otherwise, and a chaotic line
search carries that ulp-level change) does not take it:
tests/test_torch_fly.py's substep against the JAX kernel.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
