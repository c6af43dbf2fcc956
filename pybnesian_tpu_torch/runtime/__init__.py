from .device import default_device, torch_dtype

__all__ = ["default_device", "torch_dtype"]
