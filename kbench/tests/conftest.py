"""One intra-op thread a test process: the suite runs in several worker
processes (pytest-xdist), and torch's CPU thread pools in each of them
on every core would stall one another."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    torch.set_num_threads(1)
