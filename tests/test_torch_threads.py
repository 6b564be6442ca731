"""PyTorch's CPU threads in the port's tests under pytest-xdist.

PyTorch runs a CPU op on as many OpenMP threads as the machine has
cores, and an idle thread spins before it sleeps.  With several xdist
workers on one machine every worker's threads then contend with every
other's: six copies of ``tests/test_torch_edit_effects.py`` run at once
on 8 cores took 338 s each with PyTorch's default of 8 threads, and
37 s each with 2 (one copy alone: 18 s).  Each worker imports every
test file while it collects, before it runs any test, so importing
this module gives each worker's PyTorch its share of the cores for the
whole run.  A run in one process keeps PyTorch's default.
"""
import os

import torch


def worker_threads(env=os.environ, cores=None):
    """PyTorch threads for one xdist worker: the cores this process may
    use over the number of workers, at least 1; None outside xdist."""
    workers = env.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        return None
    cores = len(os.sched_getaffinity(0)) if cores is None else cores
    return max(1, cores // int(workers))


THREADS = worker_threads()
if THREADS is not None:
    torch.set_num_threads(THREADS)


def test_each_worker_takes_its_share_of_the_cores():
    env = {"PYTEST_XDIST_WORKER_COUNT": "6"}
    assert worker_threads(env, cores=8) == 1
    assert worker_threads(env, cores=24) == 4
    assert worker_threads({"PYTEST_XDIST_WORKER_COUNT": "16"}, cores=8) == 1
    assert worker_threads({}, cores=8) is None
    if THREADS is not None:
        assert torch.get_num_threads() == THREADS
