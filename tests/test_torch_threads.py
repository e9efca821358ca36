"""One torch intra-op thread for the port's CPU tests.

The suite runs in several worker processes at once (``pytest -n 6``), and
torch starts one intra-op thread per core in each of them, so six workers
on eight cores keep about six times as many busy threads as cores. The
port's test files, which run many small torch ops, then ran about twice as
slow as on one thread each: their summed durations were 2689 s with torch's
default and 1341 s with one thread, on the same tree with the same flags.
Each port test module that computes imports ``one_torch_thread``, a
module-scoped autouse fixture: one thread while the module runs, the
previous count after it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_a_module_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
