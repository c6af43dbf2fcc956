from .device import (
    default_device,
    host_to_device,
    numpy_dtype,
    resolve_device,
    torch_dtype,
    use_device,
)

__all__ = ["default_device", "resolve_device", "use_device", "torch_dtype",
           "numpy_dtype", "host_to_device"]
