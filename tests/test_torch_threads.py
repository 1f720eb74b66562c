"""A test process runs torch at its share of the cores (``torch_threads``):
its own intra-op threads, a thread of a pool such as the pipeline's prep and
stage-3 pools, and a script it starts as a subprocess."""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

pytest_plugins = ["torch_threads"]

# Worked out here, not read from the helper, so that a process left at
# torch's default of one thread per core fails.
BUDGET = max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


def test_the_process_runs_at_the_budget():
    assert torch.get_num_threads() == BUDGET


def test_a_pool_thread_runs_at_the_budget():
    with ThreadPoolExecutor(max_workers=2) as pool:
        assert pool.submit(torch.get_num_threads).result() == BUDGET


def test_a_subprocess_runs_at_the_budget():
    probe = "import os, torch; print(os.environ.get('OMP_NUM_THREADS'), torch.get_num_threads())"
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.split() == [str(BUDGET), str(BUDGET)]
