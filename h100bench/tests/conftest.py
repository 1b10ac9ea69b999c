"""Each test process takes its share of the cores. Workers that each start a
thread per core slow one another many times over, and a run's window is
measured in seconds: a detect window would then end before it reached the
requests it samples."""

import os

import torch


def pytest_configure(config):
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
