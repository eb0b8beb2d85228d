"""``one_torch_thread``: an autouse fixture for test modules that drive
many tiny solves; import it into the test module.

Under ``pytest -n 6`` several workers share the cores, and torch's
spinning intra-op pools then slow each other down tenfold or more (a tiny
driver run took 97.6 s against 4.3 s with one thread beside six busy
processes); one thread is also the faster for tensors this small.  The
count is not restored afterwards: raising it again in the same process
left the pool spinning, and the next module's chip_smoke rehearsal ran
for over 400 s instead of 63 s (42.6 s with one thread throughout).  So
the rest of the worker's tests run on one thread too."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    torch.set_num_threads(1)
