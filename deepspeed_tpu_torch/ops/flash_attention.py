"""Flash attention forward and backward on the card (counterpart of
``deepspeed_tpu/ops/flash_attention.py``).

Hand-written CUDA kernels replace the TPU kernels of the JAX module. bf16
runs on the tensor cores (TMA loads, ``wgmma``, warp-specialised, on
``csrc/sm90_common.cuh``): q, k, v and dO reach those kernels through
tensor maps, so their views must keep TMA's 16-byte rule
(:func:`tma_view_error`). fp32 runs on the CUDA cores, since the tensor
cores would round it to TF32:

- for ``_fwd_kernel`` (``:77``, launched at ``:174``), causal or not
  online-softmax attention with the bottom-right mask ``off = Tk - Tq``,
  returning O in the input dtype and the fp32 logsumexp:
  ``csrc/flash_fwd_sm90.cu`` (bf16), ``csrc/flash_fwd.cu`` (fp32);
- for ``_bwd_dq_kernel`` (``:196`` · ``:336``), dQ by query tiles:
  ``csrc/flash_bwd_dq_sm90.cu`` (bf16), ``csrc/flash_bwd_dq.cu`` (fp32);
- for ``_bwd_dkv_kernel`` (``:252`` · ``:355``), dK and dV by key tiles
  (the bf16 kernel computes the transposed scores, so P and dS are
  already ``wgmma``'s register operand): ``csrc/flash_bwd_dkv_sm90.cu``
  (bf16), ``csrc/flash_bwd_dkv.cu`` (fp32).

Each takes explicit strides (last dim contiguous), so the ``[B, T, H, D]``
entry :func:`flash_attention_bthd` passes transposed views of its inputs
to the same kernels: that is the port of the TPU kernels 4-6
(``_fwd_kernel_bthd`` and the two ``_bwd_*_bthd``), which share kernels
1-3's bodies and differ only in layout. Unlike the TPU wrappers the
kernels take any ``T``: ragged tiles are masked in the kernel.

Gradients flow through :class:`FlashAttentionFunction`, the counterpart of
the ``custom_vjp`` pair ``_fa_fwd``/``_fa_bwd``: it saves q, k, v, O and
lse, computes ``delta = rowsum(dO * O)`` in fp32 and runs the two backward
kernels. The forward runs as the custom op ``deepspeed_tpu_torch::
flash_fwd``, so selective activation checkpointing (``models/
remat_utils.py``) can save its outputs by op, as the JAX model saves the
residuals named ``flash_o``/``flash_lse``.

Every wrapper takes its plain PyTorch version for a tensor on the CPU and
launches its kernel, or raises, for a CUDA tensor; ``.launches`` on each
public wrapper counts its kernel's launches.

:func:`flash_attention_bthd_tp` is the tensor-parallel entry (JAX
``flash_attention_bthd_tp``, a ``shard_map`` there): each rank already
holds its heads, so it runs kernel 1 on them, with no collective.
"""

import ctypes
from typing import Tuple

import torch

from deepspeed_tpu_torch.ops.op_builder import load
from deepspeed_tpu_torch.telemetry import flops

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GRID_Y = 65535
# ds_flash_fwd_sm90's return codes from here up: a tensor map that
# cuTensorMapEncodeTiled refused (10000 + its CUresult)
_TENSOR_MAP_ERROR = 10000

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_TAIL = [ctypes.c_float, _INT, _PTR]  # scale, causal, stream
# each kernel source's C entry point: (argtypes, restype). The two forward
# kernels take the same arguments; the tensor-core backward kernels take
# the (batch, head, token) strides of each tensor as arguments (the
# CUDA-core ones as a host array)
_FWD_ARGS = ([_PTR] * 5 + [_INT] * 5 + [_I64] * 12 + _TAIL, _INT)
_SIGS = {
    "flash_fwd": _FWD_ARGS,
    "flash_fwd_sm90": _FWD_ARGS,
    "flash_bwd_dq": ([_PTR] * 7 + [_INT] * 5 + [_PTR] + _TAIL, _INT),
    "flash_bwd_dq_sm90": ([_PTR] * 7 + [_INT] * 5 + [_I64] * 15 + _TAIL,
                          _INT),
    "flash_bwd_dkv": ([_PTR] * 8 + [_INT] * 5 + [_PTR] + _TAIL, _INT),
    "flash_bwd_dkv_sm90": ([_PTR] * 8 + [_INT] * 5 + [_I64] * 18 + _TAIL,
                           _INT),
}


def _scale(q, softmax_scale):
    return softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5


def _visible(tq, tk, causal, device):
    """[tq, tk] keys each query row sees (bottom-right causal)."""
    visible = torch.ones((tq, tk), dtype=torch.bool, device=device)
    return torch.tril(visible, diagonal=tk - tq) if causal else visible


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
    """Plain PyTorch version of the forward kernel: q ``[B, H, Tq, D]``,
    k/v ``[B, H, Tk, D]``. Scores are exact fp32 products of the inputs (a
    product of two bf16 values is exact in fp32), summed in fp32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * _scale(q, softmax_scale)
    o, lse = softmax_pv(s, _visible(q.shape[-2], k.shape[-2], causal,
                                    q.device), v)
    return o.to(q.dtype), lse


def probs_ds(q, k, v, do, lse, delta, visible, scale):
    """The backward kernels' p = exp(s - lse) (0 where ``visible``, a
    boolean broadcastable to ``[..., q, k]``, is False, also in fully
    masked rows whose lse is NEG_INF) and ds = p * (dp - delta) * scale
    rounded to the input dtype (the TPU kernels' ``ds.astype``), in
    fp32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1)).masked_fill(~visible, 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta.unsqueeze(-1)) * scale).to(q.dtype).float()
    return p, ds


def flash_attention_backward_dq_reference(q, k, v, do, lse, delta,
                                          causal=True, softmax_scale=None):
    """Plain PyTorch version of the dQ kernel: ``ds · K`` in fp32."""
    _, ds = probs_ds(q, k, v, do, lse, delta,
                     _visible(q.shape[-2], k.shape[-2], causal, q.device),
                     _scale(q, softmax_scale))
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_attention_backward_dkv_reference(q, k, v, do, lse, delta,
                                           causal=True, softmax_scale=None):
    """Plain PyTorch version of the dK/dV kernel: ``dsᵀ · Q`` and ``pᵀ ·
    dO`` in fp32, with p rounded to dO's dtype first (``p.astype``)."""
    p, ds = probs_ds(q, k, v, do, lse, delta,
                     _visible(q.shape[-2], k.shape[-2], causal, q.device),
                     _scale(q, softmax_scale))
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(do, o):
    """``delta = rowsum(dO * O)`` in fp32, ``[B, H, Tq]`` contiguous (the
    TPU wrapper computes it outside the kernels, ``:323``)."""
    return (do.float() * o.float()).sum(-1).contiguous()


def flash_attention_backward_reference(q, k, v, o, lse, do, causal=True,
                                       softmax_scale=None):
    """Plain PyTorch version of the whole backward (``_flash_backward``):
    ``(dq, dk, dv)`` from the forward's residuals and the cotangent."""
    delta = attention_delta(do, o)
    dq = flash_attention_backward_dq_reference(q, k, v, do, lse, delta,
                                               causal, softmax_scale)
    dk, dv = flash_attention_backward_dkv_reference(q, k, v, do, lse, delta,
                                                    causal, softmax_scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# checks and kernel launches
# ---------------------------------------------------------------------------
def _require_cuda(t, what):
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, got {t.device}")


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


def _check_bwd(q, k, v, do, lse, delta):
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.stride(-1) != 1 \
            or do.device != q.device:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} strides "
                         f"{do.stride()} must match q {tuple(q.shape)} "
                         f"{q.dtype} with a contiguous last dim")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous fp32 "
                             f"{tuple(q.shape[:3])}, got {tuple(t.shape)} "
                             f"{t.dtype}")


def _strides(*tensors):
    """(batch, head, token) element strides of each tensor, as the host
    int64 array the backward kernels copy into their parameters."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def tma_view_error(shape, strides, itemsize, data_ptr):
    """Why TMA cannot address a ``[B, H, T, D]`` view, or None. A tensor
    map needs a 16-byte aligned base, a contiguous last dim whose rows are
    a multiple of 16 bytes, and every other stride a multiple of 16 bytes
    (and below 2^40); a dim of size 1 is never stepped, so its stride does
    not count. ``strides`` are in elements, as ``Tensor.stride()``."""
    if strides[-1] != 1:
        return f"last dim not contiguous (strides {tuple(strides)})"
    if (shape[-1] * itemsize) % 16:
        return f"rows of {shape[-1] * itemsize} bytes, not a multiple of 16"
    if data_ptr % 16:
        return f"base address {data_ptr:#x} not 16-byte aligned"
    for size, stride in zip(shape[:-1], strides[:-1]):
        nbytes = stride * itemsize
        if size > 1 and (nbytes % 16 or not 0 < nbytes < 2 ** 40):
            return (f"stride of {nbytes} bytes (strides {tuple(strides)}) not"
                    f" a positive multiple of 16 below 2^40")
    return None


def readable_cotangent(do, tma):
    """dO as the backward kernels can read it: the cotangent's layout is
    the caller's, so a copy where it has a strided last dim or, when the
    kernels read it through a tensor map (``tma``), breaks TMA's 16-byte
    rule."""
    if do.stride(-1) != 1 or (
            tma and tma_view_error(do.shape, do.stride(), do.element_size(),
                                   do.data_ptr()) is not None):
        return do.contiguous()
    return do


def _tma_strides(t):
    """(batch, head, token) element strides of a TMA-checked view, each
    dim of size 1 given its head-dim row (never stepped, but the tensor
    map wants a multiple of 16 bytes)."""
    return [st if n > 1 else t.shape[-1]
            for n, st in zip(t.shape[:3], t.stride()[:3])]


def _check_tma(what, **views):
    """Raise where a bf16 view breaks TMA's 16-byte rule."""
    for name, t in views.items():
        why = tma_view_error(t.shape, t.stride(), t.element_size(),
                             t.data_ptr())
        if why is not None:
            raise ValueError(f"{what} (bf16, TMA): {name} view "
                             f"{tuple(t.shape)}: {why}")


def _launch(source, ptrs, *args, sigs=_SIGS):
    """Call kernel source ``source``'s entry point (its ctypes signature in
    ``sigs``) on ``ptrs`` (tensors) and ``args``, raising on a refused
    tensor map or launch."""
    fn = getattr(load(source, {f"ds_{source}": sigs[source]}),
                 f"ds_{source}")
    err = fn(*(t.data_ptr() for t in ptrs), *args)
    if err >= _TENSOR_MAP_ERROR:
        raise RuntimeError(f"{source}: cuTensorMapEncodeTiled refused a "
                           f"tensor map (CUresult "
                           f"{err - _TENSOR_MAP_ERROR})")
    if err:
        raise RuntimeError(f"{source} kernel launch failed: CUDA error "
                           f"{err}")


def _fwd_launch(q, k, v, causal, scale):
    """Launch the forward kernel, ``csrc/flash_fwd_sm90.cu`` for bf16 and
    ``csrc/flash_fwd.cu`` for fp32: ``(o, lse)``, o in q's layout."""
    b, h, tq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if tq == 0:
        return o, lse
    if q.dtype == torch.bfloat16:
        _check_tma("flash forward", q=q, k=k, v=v)
        source = "flash_fwd_sm90"
        strides = ([s for t in (q, k, v) for s in _tma_strides(t)]
                   + list(o.stride()[:3]))
    else:
        source = "flash_fwd"
        strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    _launch(source, (q, k, v, o, lse), b, h, tq, k.shape[2], d, *strides,
            float(scale), int(causal), _stream(q))
    flash_attention.launches += 1
    return o, lse


def _bwd_args(q, k, v, do, outs):
    """The backward kernels' source suffix and stride arguments for q's
    dtype: bf16 the tensor-core kernel (tensor-map strides of q, k, v, dO,
    then the outputs' strides, as arguments), fp32 the CUDA-core one (one
    host array of every stride)."""
    if q.dtype == torch.bfloat16:
        _check_tma("flash backward", q=q, k=k, v=v, do=do)
        return "_sm90", ([s for t in (q, k, v, do) for s in _tma_strides(t)]
                         + [s for t in outs for s in t.stride()[:3]])
    return "", [_strides(q, k, v, do, *outs)]


def _dq_launch(q, k, v, do, lse, delta, causal, scale):
    """Launch the dQ kernel, ``csrc/flash_bwd_dq_sm90.cu`` for bf16 and
    ``csrc/flash_bwd_dq.cu`` for fp32: dq in q's layout."""
    b, h, tq, d = q.shape
    dq = torch.empty_like(q)
    if tq == 0 or k.shape[2] == 0:
        return dq.zero_()
    suffix, strides = _bwd_args(q, k, v, do, (dq,))
    _launch("flash_bwd_dq" + suffix, (q, k, v, do, lse, delta, dq), b, h, tq,
            k.shape[2], d, *strides, float(scale), int(causal), _stream(q))
    flash_attention_backward.launches += 1
    return dq


def _dkv_launch(q, k, v, do, lse, delta, causal, scale):
    """Launch the dK/dV kernel, ``csrc/flash_bwd_dkv_sm90.cu`` for bf16
    and ``csrc/flash_bwd_dkv.cu`` for fp32: (dk, dv) in k's and v's
    layout."""
    b, h, tq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if tq == 0 or k.shape[2] == 0:
        return dk.zero_(), dv.zero_()
    suffix, strides = _bwd_args(q, k, v, do, (dk, dv))
    _launch("flash_bwd_dkv" + suffix, (q, k, v, do, lse, delta, dk, dv), b,
            h, tq, k.shape[2], d, *strides, float(scale), int(causal),
            _stream(q))
    flash_attention_backward_dkv.launches += 1
    return dk, dv


# ---------------------------------------------------------------------------
# the forward as a custom op (selective checkpointing saves it by op)
# ---------------------------------------------------------------------------
@torch.library.custom_op("deepspeed_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, scale: float) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """``(o, lse)``: the plain version on the CPU, the kernel on the card
    (callers check the device first)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    return _fwd_launch(q, k, v, causal, scale)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, scale):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


class FlashAttentionFunction(torch.autograd.Function):
    """O = flash(q, k, v) with the flash backward: saves q, k, v, O and
    lse (``_fa_fwd``), and in backward computes ``delta`` in fp32 and runs
    the dQ and dK/dV wrappers (``_fa_bwd``). Returns ``(o, lse)``; lse
    carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd_op(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = readable_cotangent(do, do.dtype == torch.bfloat16
                                and do.device.type == "cuda")
        delta = attention_delta(do, o)
        # dQ and dK/dV: two matmuls each, the forward's FLOPs each
        def fwd():
            b, h, tq, d = q.shape
            return flops.attention_flops(b, h, tq, k.shape[2], d,
                                         ctx.causal)

        dq = flops.counted("flash_bwd_dq", fwd,
                           flash_attention_backward, q, k, v, do, lse,
                           delta, ctx.causal, ctx.scale)
        dk, dv = flops.counted("flash_bwd_dkv", fwd,
                               flash_attention_backward_dkv, q, k, v, do,
                               lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, causal=True, softmax_scale=None):
    """Flash attention: ``(O, lse)`` with O ``[B, H, Tq, D]`` in q's dtype
    and lse ``[B, H, Tq]`` fp32, differentiable in q, k and v. CPU tensors
    take the plain versions; CUDA tensors launch the kernels or raise."""
    if q.device.type != "cpu":
        _require_cuda(q, "flash_attention")
        _check(q, k, v)
    return FlashAttentionFunction.apply(q, k, v, causal,
                                        float(_scale(q, softmax_scale)))


def flash_attention_bthd(q, k, v, causal=True, softmax_scale=None):
    """Flash attention over the projection-natural ``[B, T, H, D]``
    layout, returning O in the same layout: the kernels read and write
    transposed views through their strides, so no copy is made."""
    o, _ = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal, softmax_scale)
    return o.transpose(1, 2)


def flash_attention_bthd_tp(q, k, v, causal=True, softmax_scale=None):
    """Tensor-parallel :func:`flash_attention_bthd` (JAX
    ``flash_attention_bthd_tp``): ``[B, T, H, D]`` inputs holding this
    rank's heads (the column-parallel projection's output), run through
    the forward kernel, and in training the backward kernels through the
    base function's autograd, with no collective; attention never
    reduces across heads. The cotangent the row-parallel projection
    hands back is a contiguous ``[B, T, H, D]`` view, which keeps TMA's
    16-byte rule (no copy). A live ``seq`` axis (Ulysses) is refused by
    :class:`~deepspeed_tpu_torch.parallel.topology.MeshTopology`, naming
    the sequence-parallel slice ([12.7])."""
    return flash_attention_bthd(q, k, v, causal, softmax_scale)


def flash_attention_backward(q, k, v, do, lse, delta, causal=True,
                             softmax_scale=None):
    """dQ of flash attention (TPU kernel ``_bwd_dq_kernel``) from the
    forward's lse and ``delta = rowsum(dO * O)``; dq in q's layout."""
    scale = _scale(q, softmax_scale)
    if q.device.type == "cpu":
        return flash_attention_backward_dq_reference(q, k, v, do, lse, delta,
                                                     causal, scale)
    _require_cuda(q, "flash_attention_backward")
    _check_bwd(q, k, v, do, lse, delta)
    return _dq_launch(q, k, v, do, lse, delta, causal, scale)


def flash_attention_backward_dkv(q, k, v, do, lse, delta, causal=True,
                                 softmax_scale=None):
    """(dK, dV) of flash attention (TPU kernel ``_bwd_dkv_kernel``), in
    k's and v's layout."""
    scale = _scale(q, softmax_scale)
    if q.device.type == "cpu":
        return flash_attention_backward_dkv_reference(q, k, v, do, lse,
                                                      delta, causal, scale)
    _require_cuda(q, "flash_attention_backward_dkv")
    _check_bwd(q, k, v, do, lse, delta)
    return _dkv_launch(q, k, v, do, lse, delta, causal, scale)


# kernel launches by each wrapper (chip_smoke.py zeroes and reads them)
flash_attention.launches = 0
flash_attention_backward.launches = 0
flash_attention_backward_dkv.launches = 0
