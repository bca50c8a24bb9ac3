"""CUDA accelerator and the port's device resolution.

Every entry point of the port resolves its device here: ``None`` means
the card (``cuda``), and only an explicit ``"cpu"`` runs on the host —
the tests' choice. Asking for ``cuda`` on a machine without a usable GPU
raises; nothing ever falls back to the CPU.
"""

import os

import torch

from .abstract_accelerator import Accelerator


class CudaAccelerator(Accelerator):
    _name = "cuda"

    def device_name(self, device_index=None) -> str:
        return "cuda" if device_index is None else f"cuda:{device_index}"

    def device(self, device_index=None):
        return torch.device(self.device_name(device_index))

    def current_device(self) -> int:
        return torch.cuda.current_device()

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def is_available(self) -> bool:
        return torch.cuda.is_available()

    def synchronize(self, device_index=None) -> None:
        torch.cuda.synchronize(device_index)

    def memory_allocated(self, device_index=None) -> int:
        return torch.cuda.memory_allocated(device_index)

    def max_memory_allocated(self, device_index=None) -> int:
        return torch.cuda.max_memory_allocated(device_index)

    def reset_peak_memory_stats(self, device_index=None) -> None:
        torch.cuda.reset_peak_memory_stats(device_index)

    def is_bf16_supported(self) -> bool:
        return torch.cuda.is_available() and torch.cuda.is_bf16_supported()


_accelerator = CudaAccelerator()


def get_accelerator() -> Accelerator:
    return _accelerator


def resolve_device(device=None) -> torch.device:
    """``None`` → the card: ``cuda:LOCAL_RANK`` under a process group
    (one process per card), else ``cuda``. A CUDA device without a usable
    GPU raises."""
    if device is None:
        import torch.distributed as dist

        running = dist.is_available() and dist.is_initialized()
        device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
                  if running else torch.device("cuda"))
    device = torch.device(device)
    if device.type == "cuda" and not get_accelerator().is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path on the "
            "host")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}: 'cuda' or 'cpu'")
    return device
