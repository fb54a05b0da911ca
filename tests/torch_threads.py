"""The port's test files' one-torch-thread pin (a module imports
:func:`one_torch_thread` to use it).

The tests' tensor ops are small, and with other test processes busy,
torch's spinning intra-op threads starve them (six concurrent runs of the
LM family goldens on an 8-core host: 205 s at 8 threads a process, 15 s
at 1).  Results do not depend on the count.  The pin is module-scoped:
pytest sets up wider scopes first, so a function-scoped pin would leave a
module's own fixtures (a search, a golden recomputed once) at torch's
default thread count.
"""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
