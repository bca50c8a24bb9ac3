"""Device abstraction layer (counterpart of ``deepspeed_tpu/accelerator/``)."""

from .abstract_accelerator import Accelerator
from .cuda_accelerator import CudaAccelerator, get_accelerator, resolve_device

__all__ = ["Accelerator", "CudaAccelerator", "get_accelerator",
           "resolve_device"]
