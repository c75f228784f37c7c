"""A fixture that the port's CPU test modules share.

``one_thread`` runs a module's tests on one intra-op thread. The port's
tests run smoke-size models, whose ops are too small to gain from
splitting; and the suite runs its files on several workers at once, so
every worker's default pool of one thread per core would contend for
the same cores, and a pool that waits on its threads then waits on the
other workers (a 0.5 s test took 30 s so). Import it into a test module
(``from torch_threads import one_thread  # noqa: F401``): it is
module-scoped and autouse, and restores the previous count after the
module."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)
