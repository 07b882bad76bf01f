"""The one-thread pin of the port's CPU test files: each imports
``one_thread``, a module-scoped autouse fixture, by

    from tests.torch_one_thread import one_thread  # noqa: F401

Torch's CPU operations then run on one intra-op thread while the file's
tests run.  The files are small grids and many small operations, which
one thread runs about as fast as eight, and the suite runs several test
processes at once: a process with a thread per core makes every other
process wait on its pool.  A first multithreaded ``torch.cos`` on the CPU
has also been seen to return one worker's rows wrong in the ninth
significant digit (ROADMAP.md, Queue 3), which a 1e-12 comparison with
the JAX package would catch; with one thread it has not been seen.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
