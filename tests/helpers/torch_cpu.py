"""The CPU choice of the torch port's CPU tests.

The port runs on the card unless the caller asks for the CPU. A test module
of the port asks for it by importing the autouse fixture below::

    from torch_cpu import _on_the_cpu  # noqa: F401
"""

import pytest
import torch

from pybnesian_tpu_torch.runtime.device import use_device

# One intra-op thread per test process: the test runner starts several
# worker processes, and the port's CPU paths are chains of small tensor
# ops, where a thread pool per worker, each as wide as the machine, spends
# its time waiting on the others (a 7 s test took 150 s under 4 workers).
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """Every test of the importing module runs with the CPU chosen."""
    with use_device("cpu"):
        yield
