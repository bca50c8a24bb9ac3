"""Accelerator abstraction (counterpart of
``deepspeed_tpu/accelerator/abstract_accelerator.py``).

The seam every device-touching call site goes through: device inventory,
synchronization, memory introspection and precision probes. The port has
one implementation, :class:`~.cuda_accelerator.CudaAccelerator`.
"""

import abc


class Accelerator(abc.ABC):
    """Device abstraction. One instance serves the whole process."""

    _name: str = "abstract"

    # --- identity -----------------------------------------------------
    @abc.abstractmethod
    def device_name(self, device_index=None) -> str:
        """Platform name, optionally suffixed ``:<index>``."""

    @abc.abstractmethod
    def device(self, device_index=None):
        """The underlying device handle (a ``torch.device``)."""

    @abc.abstractmethod
    def current_device(self) -> int:
        """Default device index for this process."""

    def current_device_name(self) -> str:
        return self.device_name(self.current_device())

    @abc.abstractmethod
    def device_count(self) -> int:
        """Local (process-visible) device count."""

    @abc.abstractmethod
    def is_available(self) -> bool:
        """True when at least one accelerator device initializes."""

    # --- execution ----------------------------------------------------
    @abc.abstractmethod
    def synchronize(self, device_index=None) -> None:
        """Wait for all queued device work."""

    # --- memory introspection ----------------------------------------
    @abc.abstractmethod
    def memory_allocated(self, device_index=None) -> int:
        ...

    @abc.abstractmethod
    def max_memory_allocated(self, device_index=None) -> int:
        ...

    @abc.abstractmethod
    def reset_peak_memory_stats(self, device_index=None) -> None:
        ...

    # --- precision probes ---------------------------------------------
    @abc.abstractmethod
    def is_bf16_supported(self) -> bool:
        ...

    def communication_backend_name(self) -> str:
        return "nccl"
