"""The ``one_thread`` fixture of the port's CPU test modules.

With the suite's six pytest workers on eight cores, torch's default of one
intra-op thread per core oversubscribes the machine: a module's runs took
up to 20-45x their time alone.  A module that runs torch on the CPU takes
``pytestmark = pytest.mark.usefixtures("one_thread")`` and imports the
fixture from here."""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(scope="module")
def one_thread():
    """torch on one intra-op thread for a module's tests, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
