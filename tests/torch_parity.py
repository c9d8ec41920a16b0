"""Settings the port's parity test modules share (not a test module).

``one_intraop_thread``: a module-scoped autouse fixture that runs the
module's tests with torch's intra-op pool at one thread and restores the
pool's size after it. The suite runs as several pytest-xdist worker
processes on one machine's cores; torch's default pool (one thread a
core) in each of them oversubscribes the machine, and its waiting
threads made the port's heavy modules several times slower (12 of them:
388 s at the default pool, 154 s at one thread, under ``-n 6``). A
module opts in by importing the fixture::

    from torch_parity import one_intraop_thread  # noqa: F401

Modules whose reference comparisons were tuned at the default pool (the
Keras ResNet-50's gradients against XLA's, which agree to 1e-4 only in
that summation order) do not import it.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intraop_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
