"""Gradient-norm helpers (counterpart of ``deepspeed_tpu/runtime/utils.py``
and of the engine's ``_global_norm``, ``runtime/engine.py:93``).

Norms are 0-d fp32 tensors on the tensors' device (no host sync);
:func:`clip_grad_norm_` scales the given tensors IN PLACE, where the JAX
version returns a new tree.
"""

import math

import torch


def sum_of_squares(tensors) -> torch.Tensor:
    """The sum of squares of every element, in fp32, as a sum of each
    tensor's squared norm (the ZeRO engine sums it over ranks)."""
    tensors = [t.float() for t in tensors]
    if not tensors:
        return torch.zeros(())
    return torch.stack(torch._foreach_norm(tensors)).square().sum()


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return sum_of_squares(tensors).sqrt()


def get_global_norm_of_tensors(tensors, norm_type=2):
    """Global ``norm_type`` norm over a list of tensors (reference
    ``get_global_norm_of_tensors``)."""
    tensors = list(tensors)
    if norm_type == 2:
        return global_norm(tensors)
    total = sum(t.float().abs().pow(norm_type).sum() for t in tensors)
    return total ** (1.0 / norm_type)


def get_global_norm(norm_list):
    """sqrt(sum of squared norms) — reference ``get_global_norm``."""
    return math.sqrt(sum(float(n) ** 2 for n in norm_list))


def clip_grad_norm_(tensors, max_norm, norm_type=2):
    """Scale ``tensors`` in place by ``min(1, max_norm / (norm + 1e-6))``.
    Returns ``(tensors, total_norm)``, the JAX version's pair."""
    tensors = list(tensors)
    total = get_global_norm_of_tensors(tensors, norm_type)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    torch._foreach_mul_(tensors, coef)
    return tensors, total


__all__ = ["global_norm", "sum_of_squares", "get_global_norm", "get_global_norm_of_tensors",
           "clip_grad_norm_"]
