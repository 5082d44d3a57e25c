"""One torch thread for a port test file's tests.

The suite runs on six xdist workers (`pytest -n 6`), on the machine's
cores. torch gives each worker as many intra-op threads as there are cores,
so the six workers' threads oversubscribe them, and a small op's threads
wait on each other: `tests/test_torch_speculative.py::
test_draft_corruption_rate_sets_the_acceptance` takes 3.8 s alone and 187 s
in each of six copies run at once, and the port's test files took 867 s on
six workers, 395 s on one torch thread a worker (an 8-core machine). A port
test file imports `one_torch_thread`, an autouse fixture that runs the
file's tests on one torch thread and gives the count back after them. What
the tests compare moves with the count of threads only through the order of
fp32 sums, which their tolerances hold.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
