"""The torch CPU thread budget of a test process: its share of the cores.

The tier-1 run starts several pytest-xdist workers on one machine. Left at its
default, each worker's torch runs one OpenMP thread per core, and the pipeline
under test adds its own prep and stage-3 pools on top, so the workers' threads
fight over the cores rather than run the tests: one fixture that takes 16 s
alone took 784 s among six such workers on eight cores. Each worker takes
``cpu_count // workers`` threads instead; a process that runs alone keeps
every core.

The port's test files load this module with ``pytest_plugins``, so a file run
on its own gets the budget too. pytest calls ``pytest_configure`` of a plugin
loaded that late as it registers it.
"""

import os

import torch


def pytest_configure(config):
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(n)
    # Overwritten, not defaulted: the scripts the tests start as subprocesses
    # (the example twins, bench_torch.py) must run at the worker's own count.
    os.environ["OMP_NUM_THREADS"] = str(n)
