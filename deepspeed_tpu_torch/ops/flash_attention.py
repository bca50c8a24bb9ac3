"""Flash attention forward on the card (counterpart of
``deepspeed_tpu/ops/flash_attention.py``).

Replaces the TPU kernel ``_fwd_kernel`` (``deepspeed_tpu/ops/
flash_attention.py:77``, launched by ``_flash_forward`` at ``:174``) with
the hand-written CUDA kernel ``csrc/flash_fwd.cu``: causal
online-softmax attention with the bottom-right mask ``off = Tk - Tq``,
returning O in the input dtype and the fp32 logsumexp. Layout
``[B, H, T, D]``, taken through explicit strides (the last dim must be
contiguous), so a strided ``[B, T, H, D]`` view goes in without a copy.
Unlike the TPU wrapper it takes any ``T``: ragged tiles are masked in the
kernel.

The backward kernels (TPU kernels 2 and 3) come with the training slice.
"""

import ctypes

import torch

from deepspeed_tpu_torch.ops.op_builder import load

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GRID_Y = 65535

_SIG = {"ds_flash_fwd": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p], ctypes.c_int)}


def softmax_pv(s, visible, v):
    """The kernels' softmax and P·V on fp32 scores ``s [..., q, k]``:
    invisible keys get p = 0 (a row with none left gets O = 0, lse =
    NEG_INF), the unnormalized p is rounded to ``v.dtype`` before P·V
    (the TPU kernels' ``p.astype(v.dtype)``) while the row sum uses the
    unrounded p, and the fp32 accumulator is divided by ``l`` at the end.
    Returns fp32 ``(o, lse)``."""
    s = s.masked_fill(~visible, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l_sum == 0, torch.ones_like(l_sum), l_sum)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / safe_l
    return o, (m + torch.log(safe_l)).squeeze(-1)


def flash_attention_reference(q, k, v, causal=True, softmax_scale=None):
    """Plain PyTorch version of the kernel: q ``[B, H, Tq, D]``, k/v
    ``[B, H, Tk, D]``. Scores are exact fp32 products of the inputs (a
    product of two bf16 values is exact in fp32), summed in fp32."""
    tq, tk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    visible = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        visible = torch.tril(visible, diagonal=tk - tq)
    o, lse = softmax_pv(s, visible, v)
    return o.to(q.dtype), lse


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be [B, H, T, D] with a "
                             f"contiguous last dim, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash kernel takes bf16 or fp32, got {q.dtype}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"B*H = {b * h} exceeds the grid limit "
                         f"{_MAX_GRID_Y}")


def flash_attention(q, k, v, causal=True, softmax_scale=None):
    """Flash attention forward: ``(O, lse)`` with O ``[B, H, Tq, D]`` in
    q's dtype and lse ``[B, H, Tq]`` fp32. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, softmax_scale)
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention backward (TPU kernels _bwd_dq_kernel / "
            "_bwd_dkv_kernel) is not ported yet: it comes with the training "
            "slice of the PyTorch port; call under torch.no_grad()")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    _check(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    o = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if tq == 0:
        return o, lse
    lib = load("flash_fwd", _SIG)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    err = lib.ds_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), int(q.dtype == torch.bfloat16), b, h, tq, tk, d,
        *strides, float(scale), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    return o, lse


# kernel launches by this wrapper (chip_smoke.py zeroes and reads it)
flash_attention.launches = 0
