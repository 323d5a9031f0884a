"""The benchmark's CPU tests run the plain twin on tensors of 64 PEs: one
host thread each, so that several test workers do not oversubscribe the
cores."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
