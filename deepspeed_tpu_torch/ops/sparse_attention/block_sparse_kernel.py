"""Block-sparse attention forward and backward on the card (counterpart of
``deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py``).

Hand-written CUDA kernels replace the TPU kernels of the JAX module:

- for ``_fwd_kernel`` (``:79``, launched by ``_sparse_forward_impl`` at
  ``:141``), O in the input dtype and the fp32 logsumexp, ``[B, H, S]``,
  walking each query block's key blocks: ``csrc/block_sparse_fwd_sm90.cu``
  (tensor cores) or ``csrc/block_sparse_fwd.cu`` (CUDA cores);
- for ``_bwd_dq_kernel`` (``:175`` · ``:280``), dQ, walking each query
  block's key blocks: ``csrc/block_sparse_bwd_dq_sm90.cu`` (tensor cores)
  or ``csrc/block_sparse_bwd_dq.cu`` (CUDA cores);
- for ``_bwd_dkv_kernel`` (``:214`` · ``:311``), dK and dV, walking each
  key block's query blocks: ``csrc/block_sparse_bwd_dkv_sm90.cu`` (tensor
  cores) or ``csrc/block_sparse_bwd_dkv.cu`` (CUDA cores).

Which kernel runs, forward and backward alike, is a rule of dtype and
shape (:func:`tensor_cores`), not a fallback: bf16 with a block that is
a multiple of 64 takes the tensor-core kernels (TMA loads, ``wgmma``, on
``csrc/sm90_common.cuh``), which read q, k, v and dO through tensor maps,
so those views must keep TMA's 16-byte rule
(:func:`~deepspeed_tpu_torch.ops.flash_attention.tma_view_error`;
``ValueError`` otherwise); fp32 (the tensor cores would round it to
TF32) and bf16 blocks of 16, 32, 48, 80, ... take the CUDA-core kernels.
A build or launch error raises on either path.

The layout is a ``[H, nq, nk]`` boolean (numpy, as in the JAX module) with
square blocks and no empty row or column; :func:`block_lists` turns it
into per-head CSR (row pointers and key-block indices, for the forward
and dQ) and CSC lists (column pointers and query-block indices, for dK/dV:
the counterpart of the JAX wrapper's ``flatten_layout(layout.transpose(0,
2, 1))``) and the tensor-core kernels' schedules (the (head, block) pairs
longest walk first; the forward takes dQ's, since it walks the same
rows), built once per layout and device and cached as int32
device tensors. The JAX wrapper's VMEM grouping and batch splitting
(``_group``, the ``same_layout`` fold, the recursive batch halving) are
TPU tiling devices with no counterpart here: the kernels take ``[B, H, S,
D]`` and the per-head lists directly. They read q, k, v and dO through
their (batch, head, token) strides (last dim contiguous), so transposed
views of ``[B, T, H, D]`` projections go in without a copy. Head dim 64
and blocks that are a multiple of 16 in [16, 256] on the card.

Gradients flow through :class:`BlockSparseAttentionFunction`, the
counterpart of the ``custom_vjp`` pair ``_fwd``/``_bwd``: it saves q, k,
v, O and lse, computes ``delta = rowsum(dO * O)`` in fp32 outside the
kernels (``_sparse_backward``, ``:266-267``) and runs the two backward
kernels. The forward is the custom op ``deepspeed_tpu_torch::
block_sparse_fwd``, so the "dots" remat policy (``models/remat_utils.py``)
saves its outputs instead of running the forward again in backward.

Every wrapper takes its plain PyTorch version for a tensor on the CPU and
launches its kernel, or raises, for a CUDA tensor; ``.launches`` on each
public wrapper counts its kernel's launches, whichever source ran.
"""

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.telemetry import flops
from deepspeed_tpu_torch.ops.flash_attention import (_check_tma, _launch,
                                                     _require_cuda, _stream,
                                                     _strides, _tma_strides,
                                                     attention_delta,
                                                     probs_ds,
                                                     readable_cotangent,
                                                     softmax_pv)

SUPPORTED_HEAD_DIMS = (64,)
SUPPORTED_BLOCKS = tuple(range(16, 257, 16))
_MAX_GRID_Y = 65535

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the CUDA-core kernels, after the pointers: is_bf16, B, H, Sq, Sk, D,
# block; one host array of strides, scale, stream. The tensor-core ones,
# after the pointers (the last the schedule): B, H, Sq, Sk, D, block; the
# (batch, head, token) strides of each tensor as arguments, scale, stream
_TAIL = [_INT] * 7 + [_PTR, ctypes.c_float, _PTR]
_TAIL_SM90 = [_INT] * 6
_SIGS = {
    "block_sparse_fwd": ([_PTR] * 7 + _TAIL, _INT),
    "block_sparse_fwd_sm90": ([_PTR] * 8 + _TAIL_SM90 + [_I64] * 12
                              + [ctypes.c_float, _PTR], _INT),
    "block_sparse_bwd_dq": ([_PTR] * 9 + _TAIL, _INT),
    "block_sparse_bwd_dkv": ([_PTR] * 10 + _TAIL, _INT),
    "block_sparse_bwd_dq_sm90": ([_PTR] * 10 + _TAIL_SM90 + [_I64] * 15
                                 + [ctypes.c_float, _PTR], _INT),
    "block_sparse_bwd_dkv_sm90": ([_PTR] * 11 + _TAIL_SM90 + [_I64] * 18
                                  + [ctypes.c_float, _PTR], _INT),
}


def _scale(q, softmax_scale):
    return softmax_scale if softmax_scale is not None \
        else 1.0 / (q.shape[-1] ** 0.5)


# ---------------------------------------------------------------------------
# the layout and its block lists
# ---------------------------------------------------------------------------
def check_layout(layout, h: int, sq: int, sk: int) -> np.ndarray:
    """The JAX wrapper's layout checks (``:353-371``), with its errors:
    ``[H, nq, nk]``, square blocks, no empty row, no empty column.
    Returns the layout as a numpy bool array."""
    layout = np.asarray(layout, bool)
    if layout.ndim != 3 or layout.shape[0] != h:
        raise ValueError(f"layout must be [H={h}, nq, nk]; got {layout.shape}")
    nq, nk = layout.shape[1], layout.shape[2]
    if sq % nq or sk % nk or sq // nq != sk // nk:
        raise ValueError(
            f"layout {layout.shape} incompatible with seq {sq}/{sk}: "
            "square blocks required")
    if (layout.sum(axis=2) == 0).any():
        raise ValueError(
            "every (head, q_block) row needs at least one active block "
            "(an empty row would leave its output block unwritten)")
    if (layout.sum(axis=1) == 0).any():
        raise ValueError(
            "every (head, k_block) column needs at least one active block "
            "(the backward dk/dv walk would leave that column's gradient "
            "blocks unwritten — garbage, not zeros)")
    return layout


class BlockLists(NamedTuple):
    """A layout on one device: the ``[H, nq, nk]`` bool tensor (the plain
    versions' mask) and the kernels' int32 lists. ``row_ptr [H*nq + 1]``
    and ``col_idx``: head h's query block i attends key blocks
    ``col_idx[row_ptr[h*nq + i]:row_ptr[h*nq + i + 1]]`` (ascending);
    ``col_ptr [H*nk + 1]`` and ``row_idx`` the same by key block.
    ``dq_order [H*nq]`` and ``dkv_order [H*nk]``: the tensor-core
    kernels' schedules, the pairs ``h*nq + i`` (``h*nk + j``) sorted by
    row (column) length, longest first, ties by head then block."""
    layout: torch.Tensor
    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    col_ptr: torch.Tensor
    row_idx: torch.Tensor
    dq_order: torch.Tensor
    dkv_order: torch.Tensor


_LISTS = {}


def _csr(mask2d: np.ndarray):
    """(pointers, indices) of a 2-D bool matrix, row-major."""
    ptr = np.zeros(mask2d.shape[0] + 1, np.int32)
    np.cumsum(mask2d.sum(axis=1), out=ptr[1:])
    return ptr, np.nonzero(mask2d)[1].astype(np.int32)


def _longest_first(ptr: np.ndarray) -> np.ndarray:
    """The rows of a CSR pointer array sorted by length, longest first,
    ties in row order: a kernel that maps its CTA index through this order
    starts the longest walks in its first wave, so the short ones fill the
    tail (no CTA starts a long walk in the last wave)."""
    return np.argsort(-np.diff(ptr), kind="stable").astype(np.int32)


def block_lists(layout: np.ndarray, device) -> BlockLists:
    """The CSR and CSC lists of a checked layout and their schedules on
    ``device``, built once per (layout, device) and cached: the kernels
    read them from the card, so no layer uploads them again."""
    device = torch.device(device)
    key = (layout.shape, layout.tobytes(), str(device))
    lists = _LISTS.get(key)
    if lists is None:
        h, nq, nk = layout.shape
        row_ptr, col_idx = _csr(layout.reshape(h * nq, nk))
        col_ptr, row_idx = _csr(layout.transpose(0, 2, 1).reshape(h * nk, nq))
        lists = BlockLists(*(torch.from_numpy(np.ascontiguousarray(x))
                             .to(device)
                             for x in (layout, row_ptr, col_idx, col_ptr,
                                       row_idx, _longest_first(row_ptr),
                                       _longest_first(col_ptr))))
        _LISTS[key] = lists
    return lists


def _layout_tensor(layout, device) -> torch.Tensor:
    if isinstance(layout, torch.Tensor):
        return layout.to(device=device, dtype=torch.bool)
    return torch.from_numpy(np.asarray(layout, bool)).to(device)


def _token_mask(layout, sq, sk, device) -> torch.Tensor:
    """``[H, Sq, Sk]`` bool: the layout expanded to tokens."""
    lt = _layout_tensor(layout, device)
    block = sq // lt.shape[1]
    return lt.repeat_interleave(block, 1).repeat_interleave(block, 2)[
        :, :sq, :sk]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def block_sparse_attention_reference(q, k, v, layout, softmax_scale=None):
    """Plain PyTorch version of the forward kernel: q, k, v ``[B, H, S,
    D]``, ``layout`` ``[H, nq, nk]`` (numpy or a bool tensor). The layout
    becomes a token mask; the scores are fp32 products of the inputs and
    the softmax is the kernels' (:func:`~deepspeed_tpu_torch.ops.
    flash_attention.softmax_pv`: p rounded to v's dtype before P·V).
    Returns ``(o, lse)``, lse ``[B, H, Sq]`` fp32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * _scale(q, softmax_scale)
    visible = _token_mask(layout, q.shape[2], k.shape[2], q.device)[None]
    o, lse = softmax_pv(s, visible, v)
    return o.to(q.dtype), lse


def block_sparse_backward_dq_reference(q, k, v, do, lse, delta, layout,
                                       softmax_scale=None):
    """Plain PyTorch version of the dQ kernel: ``ds · K`` in fp32 with ds
    rounded to the input dtype."""
    visible = _token_mask(layout, q.shape[2], k.shape[2], q.device)[None]
    _, ds = probs_ds(q, k, v, do, lse, delta, visible,
                     _scale(q, softmax_scale))
    return torch.matmul(ds, k.float()).to(q.dtype)


def block_sparse_backward_dkv_reference(q, k, v, do, lse, delta, layout,
                                        softmax_scale=None):
    """Plain PyTorch version of the dK/dV kernel: ``dsᵀ · Q`` and ``pᵀ ·
    dO`` in fp32, p rounded to dO's dtype first."""
    visible = _token_mask(layout, q.shape[2], k.shape[2], q.device)[None]
    p, ds = probs_ds(q, k, v, do, lse, delta, visible,
                     _scale(q, softmax_scale))
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# checks and kernel launches
# ---------------------------------------------------------------------------
def _check(q, k, v, block):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be [B, H, S, D] with a "
                             f"contiguous last dim, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"block-sparse kernels take bf16 or fp32, got "
                         f"{q.dtype}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the block-sparse "
                         f"kernels: they take D in {SUPPORTED_HEAD_DIMS}")
    if block not in SUPPORTED_BLOCKS:
        raise ValueError(f"block {block} not supported by the block-sparse "
                         f"kernels: they take a multiple of 16 in "
                         f"[16, 256] {SUPPORTED_BLOCKS}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"B*H = {b * h} exceeds the grid limit "
                         f"{_MAX_GRID_Y}")


def _check_bwd(q, k, v, do, lse, delta, block):
    _check(q, k, v, block)
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


def _block(q, lists_or_layout):
    return q.shape[2] // lists_or_layout.shape[1]


def _dims(q, k, block):
    b, h, sq, d = q.shape
    return (int(q.dtype == torch.bfloat16), b, h, sq, k.shape[2], d, block)


def tensor_cores(dtype, block) -> bool:
    """Whether the forward and backward of ``dtype`` at ``block`` run on
    the tensor-core kernels (bf16, a block that is a multiple of 64)
    rather than the CUDA-core ones."""
    return dtype == torch.bfloat16 and block % 64 == 0


def _routed_launch(name, ptrs, views, outs, walk, block, scale):
    """Launch kernel ``name`` on the tensors ``ptrs`` (in its argument
    order), walking ``walk`` (pointers, indices, schedule): its ``_sm90``
    source where :func:`tensor_cores` says so (the TMA-checked input
    ``views``, q, k, v and in the backward dO, and the schedule), else
    the CUDA-core one (pointers and indices); each gets the (batch, head,
    token) strides of ``views`` and then of the outputs ``outs``."""
    q, k = views[:2]
    if tensor_cores(q.dtype, block):
        _check_tma(name, **dict(zip(("q", "k", "v", "do"), views)))
        b, h, sq, d = q.shape
        _launch(name + "_sm90", ptrs + walk, b, h, sq, k.shape[2], d, block,
                *(s for t in views for s in _tma_strides(t)),
                *(s for t in outs for s in t.stride()[:3]), float(scale),
                _stream(q), sigs=_SIGS)
    else:
        _launch(name, ptrs + walk[:2], *_dims(q, k, block),
                _strides(*views, *outs), float(scale), _stream(q),
                sigs=_SIGS)


def _fwd_launch(q, k, v, layout, row_ptr, col_idx, order, scale):
    """Launch the forward kernel, ``csrc/block_sparse_fwd_sm90.cu`` or
    ``csrc/block_sparse_fwd.cu`` (:func:`tensor_cores`), over the CSR
    lists of ``layout`` and the rows' schedule ``order``: ``(o, lse)``, o
    in q's layout."""
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _routed_launch("block_sparse_fwd", (q, k, v, o, lse), (q, k, v), (o,),
                   (row_ptr, col_idx, order), _block(q, layout), scale)
    block_sparse_attention.launches += 1
    return o, lse


def _dq_launch(q, k, v, do, lse, delta, lists, scale):
    """Launch the dQ kernel, ``csrc/block_sparse_bwd_dq_sm90.cu`` or
    ``csrc/block_sparse_bwd_dq.cu`` (:func:`tensor_cores`): dq in q's
    layout."""
    dq = torch.empty_like(q)
    _routed_launch("block_sparse_bwd_dq", (q, k, v, do, lse, delta, dq),
                   (q, k, v, do), (dq,),
                   (lists.row_ptr, lists.col_idx, lists.dq_order),
                   _block(q, lists.layout), scale)
    block_sparse_backward_dq.launches += 1
    return dq


def _dkv_launch(q, k, v, do, lse, delta, lists, scale):
    """Launch the dK/dV kernel, ``csrc/block_sparse_bwd_dkv_sm90.cu`` or
    ``csrc/block_sparse_bwd_dkv.cu`` (:func:`tensor_cores`): (dk, dv) in
    k's and v's layout."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _routed_launch("block_sparse_bwd_dkv", (q, k, v, do, lse, delta, dk, dv),
                   (q, k, v, do), (dk, dv),
                   (lists.col_ptr, lists.row_idx, lists.dkv_order),
                   _block(q, lists.layout), scale)
    block_sparse_backward_dkv.launches += 1
    return dk, dv


# ---------------------------------------------------------------------------
# the forward as a custom op (selective checkpointing saves it by op)
# ---------------------------------------------------------------------------
@torch.library.custom_op("deepspeed_tpu_torch::block_sparse_fwd",
                         mutates_args=())
def block_sparse_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        layout: torch.Tensor, row_ptr: torch.Tensor,
                        col_idx: torch.Tensor, order: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: the plain version on the CPU, the kernel on the card
    (callers check the device first)."""
    if q.device.type == "cpu":
        return block_sparse_attention_reference(q, k, v, layout, scale)
    return _fwd_launch(q, k, v, layout, row_ptr, col_idx, order, scale)


@block_sparse_fwd_op.register_fake
def _block_sparse_fwd_fake(q, k, v, layout, row_ptr, col_idx, order, scale):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


class BlockSparseAttentionFunction(torch.autograd.Function):
    """O = block-sparse attention of q, k, v over ``lists`` (a
    :class:`BlockLists` on q's device) with the two-kernel backward:
    saves q, k, v, O and lse, and in backward computes ``delta`` in fp32
    and runs the dQ and dK/dV wrappers. The lists ride on the context, not
    among the saved tensors: they are constants of the cache, so a
    recomputation under activation checkpointing finds the same ones.
    Returns ``(o, lse)``; lse carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, lists, scale):
        o, lse = block_sparse_fwd_op(q, k, v, lists.layout, lists.row_ptr,
                                     lists.col_idx, lists.dq_order, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.lists, ctx.scale = lists, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = readable_cotangent(
            do, tensor_cores(do.dtype, _block(q, ctx.lists.layout)))
        delta = attention_delta(do, o)
        # dQ and dK/dV: the forward's FLOPs each (telemetry's counter)
        def fwd():
            return flops.block_sparse_flops(q.shape, ctx.lists.layout.shape,
                                            ctx.lists.col_idx.shape[0])

        dq = flops.counted("block_sparse_bwd_dq", fwd, _backward_dq, q, k,
                           v, do, lse, delta, ctx.lists, ctx.scale)
        dk, dv = flops.counted("block_sparse_bwd_dkv", fwd, _backward_dkv,
                               q, k, v, do, lse, delta, ctx.lists,
                               ctx.scale)
        return dq, dk, dv, None, None


def _backward_dq(q, k, v, do, lse, delta, lists, scale):
    if q.device.type == "cpu":
        return block_sparse_backward_dq_reference(q, k, v, do, lse, delta,
                                                  lists.layout, scale)
    _require_cuda(q, "block_sparse_backward_dq")
    _check_bwd(q, k, v, do, lse, delta, _block(q, lists.layout))
    return _dq_launch(q, k, v, do, lse, delta, lists, scale)


def _backward_dkv(q, k, v, do, lse, delta, lists, scale):
    if q.device.type == "cpu":
        return block_sparse_backward_dkv_reference(q, k, v, do, lse, delta,
                                                   lists.layout, scale)
    _require_cuda(q, "block_sparse_backward_dkv")
    _check_bwd(q, k, v, do, lse, delta, _block(q, lists.layout))
    return _dkv_launch(q, k, v, do, lse, delta, lists, scale)


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------
def _prepare(q, k, layout):
    """The checked layout's lists on q's device (kernel checks on the
    card)."""
    layout = check_layout(layout, q.shape[1], q.shape[2], k.shape[2])
    if q.device.type != "cpu":
        _require_cuda(q, "block_sparse_attention")
    return block_lists(layout, q.device)


def block_sparse_attention_with_lse(q, k, v, layout, softmax_scale=None):
    """``(O, lse)`` of :func:`block_sparse_attention`; lse ``[B, H, Sq]``
    fp32 (the JAX kernel's ``[H, B, S]`` transposed)."""
    lists = _prepare(q, k, layout)
    if q.device.type != "cpu":
        _check(q, k, v, _block(q, lists.layout))
    return BlockSparseAttentionFunction.apply(
        q, k, v, lists, float(_scale(q, softmax_scale)))


def block_sparse_attention(q, k, v, layout, softmax_scale=None):
    """Attention restricted to the block ``layout`` (all-or-nothing
    blocks, the reference's block-sparse semantics). q, k, v: ``[B, H, S,
    D]``; layout: ``[H, S//block, S//block]`` bool (numpy), every row and
    column non-empty. Differentiable in q, k and v. CPU tensors take the
    plain versions; CUDA tensors launch the kernels or raise."""
    return block_sparse_attention_with_lse(q, k, v, layout,
                                           softmax_scale)[0]


def block_sparse_backward_dq(q, k, v, do, lse, delta, layout,
                             softmax_scale=None):
    """dQ of block-sparse attention (TPU kernel ``_bwd_dq_kernel``) from
    the forward's lse and ``delta = rowsum(dO * O)``; dq in q's layout."""
    return _backward_dq(q, k, v, do, lse, delta, _prepare(q, k, layout),
                        _scale(q, softmax_scale))


def block_sparse_backward_dkv(q, k, v, do, lse, delta, layout,
                              softmax_scale=None):
    """(dK, dV) of block-sparse attention (TPU kernel
    ``_bwd_dkv_kernel``), in k's and v's layout."""
    return _backward_dkv(q, k, v, do, lse, delta, _prepare(q, k, layout),
                         _scale(q, softmax_scale))


# kernel launches by each wrapper (chip_smoke.py zeroes and reads them)
block_sparse_attention.launches = 0
block_sparse_backward_dq.launches = 0
block_sparse_backward_dkv.launches = 0
