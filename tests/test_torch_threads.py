"""One intra-op thread for the port's CPU test modules.

The test run spreads its modules over several worker processes on one
machine; PyTorch's default intra-op pool (one thread a core) in each of
them oversubscribes the cores, and at the port's small shapes a thread
pool waiting on its peers costs more than the arithmetic.  A module
that does PyTorch arithmetic imports :func:`one_thread`, which pins
one thread for the module and restores the count after it; the values
are the same at any thread count.  The JAX side in the same process is
not touched.

    from test_torch_threads import one_thread  # noqa: F401
"""
import pytest
import torch


def pinned():
    """Set one intra-op thread; restore the count found when resumed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    yield from pinned()


def test_one_thread_pins_the_module():
    assert torch.get_num_threads() == 1


def test_pinned_restores_the_count_it_found():
    torch.set_num_threads(3)
    gen = pinned()
    next(gen)
    assert torch.get_num_threads() == 1
    with pytest.raises(StopIteration):
        next(gen)
    assert torch.get_num_threads() == 3
    torch.set_num_threads(1)
