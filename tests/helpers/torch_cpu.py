"""The CPU choice of the torch port's CPU tests.

The port runs on the card unless the caller asks for the CPU. A test module
of the port asks for it by importing the autouse fixture below::

    from torch_cpu import _on_the_cpu  # noqa: F401
"""

import pytest

from pybnesian_tpu_torch.runtime.device import use_device


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """Every test of the importing module runs with the CPU chosen."""
    with use_device("cpu"):
        yield
