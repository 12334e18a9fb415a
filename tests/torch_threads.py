"""One intra-op thread for the port's CPU tests, which work on small tensors.

The suite runs in several worker processes at once, and each process's
torch keeps a pool of as many spinning threads as the host has cores: on a
host whose cores are all busy, the pools turn seconds of work into
minutes. The spawned ranks and hosts of the sharded and multi-host
tests run on one thread too (`parallel.launch.rank_device`,
OMP_NUM_THREADS=1), so the single-process runs they are held to match.

A test module takes it with

    from torch_threads import one_thread  # noqa: F401

and runs on one thread, the count restored after its last test.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
