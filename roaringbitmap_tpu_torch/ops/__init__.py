from . import device, kernels

__all__ = ["device", "kernels"]
