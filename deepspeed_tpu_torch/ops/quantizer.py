"""Row-wise int8 codec of the paged KV pools (counterpart of
``deepspeed_tpu/ops/quantizer.py:83-104``).

Symmetric int8 with one fp32 scale per row along ``axis``: the serving
engine's ``kv_cache_dtype: "int8"`` stores every pool row (one token x
head) as int8 codes plus its scale in a side pool indexed by the same
block table. These are plain array operations in the JAX package too,
not a Pallas kernel. ``torch.round`` rounds half to even like
``jnp.round``, and the division is a true division (not a multiply by a
reciprocal), so the codes and scales match the JAX package's bit for
bit.

The stochastic per-tensor quantizer of that module (a Pallas kernel)
comes with the compressed-collectives slice.
"""

import torch


def quantize_rowwise(x, axis: int = -1):
    """``(q int8 like x, scale fp32 with axis collapsed to 1)``: scale =
    absmax / 127 (1 for an all-zero row, so it round-trips to exact
    zeros), q = round(x / scale) clamped to ±127."""
    f = x.float()
    absmax = f.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_rowwise(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_rowwise` (``scale`` broadcasts over the
    collapsed axis)."""
    return (q.float() * scale).to(dtype)
