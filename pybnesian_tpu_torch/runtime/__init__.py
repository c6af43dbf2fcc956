from .device import (
    default_device,
    host_to_device,
    numpy_dtype,
    resolve_device,
    torch_dtype,
    use_device,
    visible_devices,
)
from .config import (
    RuntimeConfig,
    default_mesh,
    device_info,
    dtype_policy,
    set_dtype_policy,
    trace,
)
from .checkpoint import load_pytree, nuts_checkpointed, save_pytree
from . import distributed, tracing

__all__ = [
    "RuntimeConfig",
    "device_info",
    "default_mesh",
    "dtype_policy",
    "set_dtype_policy",
    "trace",
    "save_pytree",
    "load_pytree",
    "nuts_checkpointed",
    "distributed",
    # the port's device choice (runtime/device.py)
    "default_device",
    "resolve_device",
    "visible_devices",
    "use_device",
    "torch_dtype",
    "numpy_dtype",
    "host_to_device",
]
