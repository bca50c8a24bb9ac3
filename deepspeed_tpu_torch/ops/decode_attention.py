"""Decode attention on the card (counterpart of
``deepspeed_tpu/ops/decode_attention.py``).

Hand-written CUDA kernels replace the TPU kernels of that module. The
three CUDA-core kernels share one split decode (``csrc/decode_split.cuh``:
the keys of each row group cut over several CTAs, :func:`decode_splits`,
and the partials merged in split order inside the same launch, with the
workspace of :func:`_split_workspace`):

- :func:`decode_attention` — ``csrc/decode_append.cu``, replacing
  ``_kernel`` (``decode_attention.py:39``, launched at ``:135``): a decode
  step against the valid ``[0, cache_index + T_q)`` prefix of an append
  KV cache (``InferenceEngine.generate``), or, for a left-padded batch,
  against ``[pad[b], cache_index + T_q)`` of each row: the kernel starts
  each row's keys at its first real one (the JAX model sends padded
  decode steps to the plain masked attention instead);
- :func:`decode_attention_paged` — ``csrc/decode_paged.cu``, replacing
  ``_paged_kernel`` (``decode_attention.py:194``, launched at ``:300``):
  the same through per-row block tables and lengths over a shared block
  pool (the serving engine's decode, chunk and verify steps);
- :func:`decode_attention_paged_int8` — replacing ``_paged_int8_kernel``
  (``decode_attention.py:319``, launched at ``:425``): the paged step over
  int8 pools with fp32 per-(token, head) scale side pools
  (``kv_cache_dtype: "int8"``), in two regimes that :func:`int8_source`
  picks from the shapes: ``csrc/decode_paged_int8_sm90.cu`` (tensor
  cores) for bf16 prefill chunks of at least :data:`TC_MIN_ROWS` rows,
  ``csrc/decode_paged_int8.cu`` (the split decode) for every other call.

Each has its plain PyTorch version beside it; a CPU tensor takes it, a
CUDA tensor launches the kernel or raises. The tensor-parallel wrappers
come with the multi-GPU slice.
"""

import ctypes
import functools

import torch

from deepspeed_tpu_torch.models.decode_utils import cache_attn_mask
from deepspeed_tpu_torch.ops.flash_attention import (SUPPORTED_HEAD_DIMS,
                                                     _stream, softmax_pv)
from deepspeed_tpu_torch.ops.op_builder import load

# pool block 0 is the reserved garbage sink: block tables pad with it,
# bucketed-prefill pad tokens scatter into it, and the paged kernel never
# reads it
GARBAGE_BLOCK = 0

# query rows a CTA of the split decode (csrc/decode_split.cuh)
DEC_ROWS = 4
# the split decode's cut of the cache: no split under MIN_SPLIT_KEYS keys
# (the kernels take it as an argument), at most 64 splits (their merge's
# shared arrays; they refuse more), and a grid of at most 65535 in z. On
# the H100 a split's merge (fence, ticket, a second pass) costs ~3 us,
# more than one CTA's walk over a few hundred keys saves: at B=2 H=12
# S=1024, 256 keeps generate()'s 129-160 visible keys on one CTA a row
# group and times as 64 does at 1001 keys (tools/time_decode.py sweeps it)
MIN_SPLIT_KEYS = 256
# the paged kernels' least keys a split: the bf16 and int8 split decodes
# time best at 192 at serving's and the fast path's decode steps (4 and 8
# slots over 8-955 keys; tools/time_decode.py --paged / --int8
# --min-split-keys), 6-9 % below 256
PAGED_MIN_SPLIT_KEYS = 192
MAX_SPLITS = 64
_MAX_GRID_Z = 65535
# int8 chunks of at least this many query rows run on the tensor cores
# (int8_source). tools/time_decode.py --int8 --tc-min-rows measured the
# crossover with the split decode at 3 rows for one row of 384 keys, but
# past 5 rows for 4 rows of up to 1019 keys (the split decode cuts a long
# row over CTAs; the chunk kernel does not): at 8, every chunk of the fast
# path runs on the tensor cores, and every verify step of up to 6 drafts
# on the split decode
TC_MIN_ROWS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_APPEND_SIG = {"ds_decode_append": (
    [_P] * 8 + [_I] * 8 + [ctypes.c_float, _P], _I)}
_PAGED_SIG = {"ds_decode_paged": (
    [_P] * 8 + [_I] * 10 + [ctypes.c_float, _P], _I)}
_PAGED_INT8_SIG = {"ds_decode_paged_int8": (
    [_P] * 10 + [_I] * 10 + [ctypes.c_float, _P], _I)}
_PAGED_INT8_SM90_SIG = {"ds_decode_paged_int8_sm90": (
    [_P] * 8 + [_I] * 7 + [ctypes.c_float, _P], _I)}


def _attend(q, k, v, visible, scale):
    """q ``[B, Tq, H, D]`` against k/v ``[B, S, H, D]`` with ``visible``
    ``[B, Tq, S]``: the kernels' math in plain PyTorch."""
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    o, _ = softmax_pv(s, visible[:, None], v.transpose(1, 2))
    return o.transpose(1, 2).to(q.dtype)


def decode_attention_reference(q, k_cache, v_cache, cache_index,
                               softmax_scale=None, pad=None):
    """Plain version of :func:`decode_attention`. Like the kernel it reads
    ``cache_index`` and ``pad`` on the device (no host sync): it attends
    over every cache row, masked to keys ``<= cache_index + r`` and, with
    ``pad``, ``>= pad[b]``."""
    b, tq, _, d = q.shape
    s_len = k_cache.shape[1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    visible = cache_attn_mask(s_len, torch.as_tensor(cache_index,
                                                     device=q.device),
                              tq, pad)[:, 0].expand(b, tq, s_len)
    # rows outside [pad, cache_index + T_q) are zeroed, not just masked:
    # the kernel never reads them, so not even a NaN there may reach the
    # output
    valid = visible[:, -1, :, None, None]
    k, v = (torch.where(valid, cache, 0) for cache in (k_cache, v_cache))
    return _attend(q, k, v, visible, scale)


def gather_paged_cache(pool, block_tables):
    """The dense ``[B, MB*bs, H, D]`` logical window assembled from pool
    blocks: gathered rows land at their logical positions; entries past a
    row's allocation read the garbage block and must be masked."""
    b, mb = block_tables.shape
    _, bs, heads, d = pool.shape
    return pool[block_tables.long()].reshape(b, mb * bs, heads, d)


def gather_paged_cache_int8(pool, scales, block_tables,
                            dtype=torch.float32):
    """The dense ``[B, MB*bs, H, D]`` logical window of an int8 pool,
    dequantized (``int8 x scale`` in fp32) through the block table;
    ``scales`` is the ``[nb, bs, H, 1]`` fp32 side pool."""
    b, mb = block_tables.shape
    _, bs, heads, d = pool.shape
    idx = block_tables.long()
    codes = pool[idx].reshape(b, mb * bs, heads, d).float()
    return (codes * scales[idx].reshape(b, mb * bs, heads, 1)).to(dtype)


def _paged_window(q, block_tables, lengths, nb, bs):
    """``(real [B, S], visible [B, T_q, S])`` of a paged step: the window
    positions whose table entry is a real pool block, and each query row's
    keys ``<= lengths[b] + r`` among them."""
    tables = block_tables.long()
    real = ((tables > GARBAGE_BLOCK) & (tables < nb)).repeat_interleave(
        bs, dim=1)
    visible = cache_attn_mask(real.shape[1], lengths.long(),
                              q.shape[1])[:, 0] & real[:, None, :]
    return real, visible


def decode_attention_paged_reference(q, k_pool, v_pool, block_tables,
                                     lengths, softmax_scale=None):
    """Plain version of :func:`decode_attention_paged`: gather the window,
    then mask each row to keys ``<= lengths[b] + r`` whose table entry is
    a real pool block."""
    d = q.shape[-1]
    nb, bs = k_pool.shape[:2]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    real, visible = _paged_window(q, block_tables, lengths, nb, bs)
    # rows of the garbage block are zeroed, not just masked: the kernel
    # never reads them, so not even a NaN there may reach the output
    k, v = (torch.where(real[:, :, None, None],
                        gather_paged_cache(pool, block_tables.clamp(
                            0, nb - 1)), 0)
            for pool in (k_pool, v_pool))
    return _attend(q, k, v, visible, scale)


def decode_attention_paged_int8_reference(q, k_pool, v_pool, k_scale,
                                          v_scale, block_tables, lengths,
                                          softmax_scale=None):
    """Plain version of :func:`decode_attention_paged_int8`: dequantize
    the window to fp32 (:func:`gather_paged_cache_int8`), then the masked
    fp32 softmax of :func:`decode_attention_paged_reference`; p is not
    rounded before P·V (V is fp32)."""
    d = q.shape[-1]
    nb, bs = k_pool.shape[:2]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    real, visible = _paged_window(q, block_tables, lengths, nb, bs)
    tables = block_tables.clamp(0, nb - 1)
    k, v = (torch.where(real[:, :, None, None],
                        gather_paged_cache_int8(pool, sc, tables), 0)
            for pool, sc in ((k_pool, k_scale), (v_pool, v_scale)))
    return _attend(q, k, v, visible, scale)


def _check_query(q, name):
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {q.device}")
    if q.requires_grad:
        raise NotImplementedError(f"{name} has no backward; call under "
                                  "torch.no_grad()")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} takes bf16 or fp32, got {q.dtype}")
    if q.dim() != 4 or q.shape[1] < 1:
        raise ValueError(f"q must be [B, T_q >= 1, H, D], got "
                         f"{tuple(q.shape)}")
    if q.shape[3] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} not in "
                         f"{SUPPORTED_HEAD_DIMS}")


def _check_buffers(name, device, dtype, tail, tensors):
    """Each tensor: ``dtype`` on ``device``, a contiguous 16-byte aligned
    4-d tensor whose last two dims are ``tail``."""
    for t in tensors:
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} on {device}, got "
                             f"{t.dtype} on {t.device}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name}: q, caches and scales must be "
                             f"contiguous 4-d tensors, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
        if tuple(t.shape[2:]) != tuple(tail):
            raise ValueError(f"{name}: heads/dim {tuple(t.shape[2:])} != "
                             f"{tuple(tail)}")


def _check_common(q, pools, name):
    _check_query(q, name)
    _check_buffers(name, q.device, q.dtype, q.shape[2:], (q, *pools))


def _check_paging(q, block_tables, lengths):
    _int32_on(block_tables, q.device, "block_tables")
    _int32_on(lengths, q.device, "lengths")
    b = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"lengths {tuple(lengths.shape)} do not match "
                         f"batch {b}")


def _int32_on(t, device, name):
    if (t.device != device or t.dtype != torch.int32
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 tensor on "
                         f"{device}, got {t.dtype} on {t.device}")


def decode_splits(b, h, tq, keys, sms, min_keys):
    """The most CTAs that split the keys of each (batch row, head, group
    of :data:`DEC_ROWS` query rows) in the split decode
    (``csrc/decode_split.cuh``), which sizes its grid and workspace:
    enough for two CTAs on each of ``sms`` SMs, no more than ``keys`` (the
    most keys a row can see: the append cache's S, a paged step's MB x
    block size) cut ``min_keys`` (:data:`MIN_SPLIT_KEYS`,
    :data:`PAGED_MIN_SPLIT_KEYS`) at a time holds, at most
    :data:`MAX_SPLITS`. A function of the shapes alone, never of the
    cache index or the lengths, which stay on the device: the launch
    needs no host sync. The kernel itself cuts the keys a row group sees
    into as many of them as hold ``min_keys`` keys each (one where fewer
    are visible); the rest end at once."""
    groups = -(-tq // DEC_ROWS)
    want = -(-2 * sms // (b * h * groups))
    return max(1, min(want, keys // min_keys, MAX_SPLITS,
                      _MAX_GRID_Z // groups))


def int8_source(dtype, tq, d, bs):
    """The kernel source of an int8 paged call, by a rule on its shapes
    alone: ``decode_paged_int8_sm90`` (tensor cores) for bf16 q with head
    dim 64, at least :data:`TC_MIN_ROWS` query rows and a block size of at
    least 2 that divides 64 or is a multiple of it (TMA gathers a 64-key
    tile as whole boxes of a block's rows, each at least the 128 bytes its
    shared-memory address must be aligned to); ``decode_paged_int8`` (the
    split decode) for every other call, fp32 q among them."""
    if (dtype == torch.bfloat16 and d == 64 and tq >= TC_MIN_ROWS
            and bs >= 2 and (64 % bs == 0 or bs % 64 == 0)):
        return "decode_paged_int8_sm90"
    return "decode_paged_int8"


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


# the split decode's fp32 partials and int32 tickets, per (device, stream)
_WORKSPACE = {}


def _split_workspace(key, device, n_partial, n_tickets):
    """The split decode's workspace for ``key`` = (device, stream), one
    for the three kernels that run it: ``n_partial`` fp32 values for the
    splits' partials and ``n_tickets`` int32 counters, cached and grown as
    needed, never allocated per call. The counters start at 0 and each
    merging CTA resets its own, so they are 0 between launches; launches
    on one stream run one after another, so they never share a counter. A
    launch that fails leaves counters it may have taken: the wrapper then
    drops the key's set."""
    ws, tickets = _WORKSPACE.get(key, (None, None))
    if ws is None or ws.numel() < n_partial:
        ws = torch.empty(n_partial, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    _WORKSPACE[key] = (ws, tickets)
    return ws, tickets


def _split_launch(source, sigs, q, keys, min_keys, call):
    """Launch the split decode of kernel ``source`` once, on a grid of
    :func:`decode_splits` splits a row group of at most ``keys`` keys and
    at least ``min_keys`` a split, with the partials and tickets in the
    cached workspace of q's device and current stream. ``call(lib, out,
    ws, tickets, splits, stream)`` makes the C call and returns its code.
    Returns ``(out, splits)``, out ``[B, T_q, H, D]`` in q's dtype."""
    b, tq, h, d = q.shape
    splits = decode_splits(b, h, tq, keys, _sm_count(q.device), min_keys)
    groups = -(-tq // DEC_ROWS)
    stream = _stream(q)
    key = (q.device, stream)
    ws, tickets = _split_workspace(
        key, q.device, b * h * groups * splits * DEC_ROWS * (d + 2),
        b * h * groups)
    out = torch.empty_like(q)
    err = call(load(source, sigs), out, ws, tickets, splits, stream)
    if err:
        _WORKSPACE.pop(key, None)
        raise RuntimeError(f"{source} kernel launch failed: CUDA error "
                           f"{err}")
    return out, splits


def _append_launch(q, k_cache, v_cache, cache_index, scale, pad=None):
    """Launch ``csrc/decode_append.cu`` once (:func:`_split_launch`), with
    each row's first key from ``pad`` (None: key 0). Returns ``[B, T_q, H,
    D]`` in q's dtype."""
    b, tq, h, d = q.shape
    s_len = k_cache.shape[1]
    out, _ = _split_launch(
        "decode_append", _APPEND_SIG, q, s_len, MIN_SPLIT_KEYS,
        lambda lib, out, ws, tickets, splits, stream: lib.ds_decode_append(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_index.data_ptr(), None if pad is None else pad.data_ptr(),
            out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
            int(q.dtype == torch.bfloat16), b, tq, h, d, s_len, splits,
            MIN_SPLIT_KEYS, float(scale), stream))
    decode_attention.launches += 1
    if pad is not None:
        decode_attention.padded_launches += 1
    return out


def _count(wrapper, source, splits):
    """One launch of ``wrapper``'s kernel from ``source`` on a grid of
    ``splits`` splits (None: the tensor-core source, which has none)."""
    wrapper.launches += 1
    wrapper.source_launches[source] = \
        wrapper.source_launches.get(source, 0) + 1
    wrapper.last_splits = splits


def _paged_launch(q, k_pool, v_pool, block_tables, lengths, scale):
    """Launch ``csrc/decode_paged.cu`` once (:func:`_split_launch`, at
    most MB x block size keys a row, :data:`PAGED_MIN_SPLIT_KEYS` a
    split). Returns ``[B, T_q, H, D]``."""
    b, tq, h, d = q.shape
    nb, bs = k_pool.shape[:2]
    mb = block_tables.shape[1]
    out, splits = _split_launch(
        "decode_paged", _PAGED_SIG, q, mb * bs, PAGED_MIN_SPLIT_KEYS,
        lambda lib, out, ws, tickets, splits, stream: lib.ds_decode_paged(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr(), tickets.data_ptr(),
            int(q.dtype == torch.bfloat16), b, tq, h, d, nb, bs, mb, splits,
            PAGED_MIN_SPLIT_KEYS, float(scale), stream))
    _count(decode_attention_paged, "decode_paged", splits)
    return out


def _paged_int8_launch(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                       lengths, scale):
    """Launch the source :func:`int8_source` names once: the tensor-core
    chunk kernel (a grid of 64-row tiles, no workspace) or the split
    decode (:func:`_split_launch`). Returns ``[B, T_q, H, D]``."""
    b, tq, h, d = q.shape
    nb, bs = k_pool.shape[:2]
    mb = block_tables.shape[1]
    source = int8_source(q.dtype, tq, d, bs)
    ptrs = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr())
    if source == "decode_paged_int8_sm90":
        out, splits = torch.empty_like(q), None
        err = load(source, _PAGED_INT8_SM90_SIG).ds_decode_paged_int8_sm90(
            *ptrs, out.data_ptr(), b, tq, h, d, nb, bs, mb, float(scale),
            _stream(q))
        if err:
            raise RuntimeError(f"{source} kernel launch failed: CUDA error "
                               f"{err}")
    else:
        out, splits = _split_launch(
            source, _PAGED_INT8_SIG, q, mb * bs, PAGED_MIN_SPLIT_KEYS,
            lambda lib, out, ws, tickets, splits, stream:
            lib.ds_decode_paged_int8(
                *ptrs, out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
                int(q.dtype == torch.bfloat16), b, tq, h, d, nb, bs, mb,
                splits, PAGED_MIN_SPLIT_KEYS, float(scale), stream))
    _count(decode_attention_paged_int8, source, splits)
    return out


def decode_attention(q, k_cache, v_cache, cache_index, softmax_scale=None,
                     pad=None):
    """Attend a decode step against the valid prefix of an append KV cache.

    q ``[B, T_q, H, D]``; caches ``[B, S, H, D]`` whose rows
    ``[0, cache_index + T_q)`` are valid (this step's keys already
    written at ``[cache_index, cache_index + T_q)``); ``cache_index`` a 0-d
    int32 tensor on q's device (the kernel reads it there, so the host
    never waits on it). ``pad``: None, or a ``[B]`` int32 tensor on q's
    device, row b's left-padded prefix: its keys start at ``pad[b]``
    (read on the device too; its values are not checked). Returns ``[B,
    T_q, H, D]`` in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, cache_index,
                                          softmax_scale, pad)
    _check_common(q, (k_cache, v_cache), "decode_attention")
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != q.shape[0]:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if cache_index.dim() != 0:
        raise ValueError("cache_index must be a 0-d int32 tensor")
    _int32_on(cache_index, q.device, "cache_index")
    if pad is not None:
        _int32_on(pad, q.device, "pad")
        if tuple(pad.shape) != (q.shape[0],):
            raise ValueError(f"pad must be [B] = [{q.shape[0]}], got "
                             f"{tuple(pad.shape)}")
    scale = softmax_scale if softmax_scale is not None else q.shape[3] ** -0.5
    return _append_launch(q, k_cache, v_cache, cache_index, scale, pad)


def decode_attention_paged(q, k_pool, v_pool, block_tables, lengths,
                           softmax_scale=None):
    """Attend a decode (or k-token verify) step against a paged KV cache.

    q ``[B, T_q, H, D]`` — query row r of batch row b sits at absolute
    position ``lengths[b] + r`` and sees keys up to it, including the
    other rows of the same step (their KV must already be in the pool);
    pools ``[num_blocks, block_size, H, D]``; ``block_tables`` ``[B, MB]``
    int32 (entries past the allocation name the garbage block, never
    read); ``lengths`` ``[B]`` int32, valid tokens per row before this
    step. Returns ``[B, T_q, H, D]`` in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_paged_reference(
            q, k_pool, v_pool, block_tables, lengths, softmax_scale)
    _check_common(q, (k_pool, v_pool), "decode_attention_paged")
    if k_pool.shape != v_pool.shape:
        raise ValueError(f"pool shapes differ: {tuple(k_pool.shape)} vs "
                         f"{tuple(v_pool.shape)}")
    _check_paging(q, block_tables, lengths)
    scale = softmax_scale if softmax_scale is not None else q.shape[3] ** -0.5
    return _paged_launch(q, k_pool, v_pool, block_tables, lengths, scale)


def decode_attention_paged_int8(q, k_pool, v_pool, k_scale, v_scale,
                                block_tables, lengths, softmax_scale=None):
    """Attend a decode, chunk or verify step against an int8 paged cache.

    The contract of :func:`decode_attention_paged` (query row r of batch
    row b sees keys ``<= lengths[b] + r``), except that ``k_pool`` /
    ``v_pool`` are ``[num_blocks, block_size, H, D]`` int8 and ``k_scale``
    / ``v_scale`` their ``[num_blocks, block_size, H, 1]`` fp32 per-row
    scales (:func:`~deepspeed_tpu_torch.ops.quantizer.quantize_rowwise`).
    q is bf16 or fp32; the output is in q's dtype. The split decode
    (``decode_paged_int8.cu``) takes the logit ``(q · codes) · k_scale ·
    scale`` in fp32, runs an fp32 online softmax and keeps ``p ·
    v_scale`` in fp32 for P·V; the tensor-core chunk kernel
    (``decode_paged_int8_sm90.cu``, :func:`int8_source`) rounds ``p ·
    v_scale`` to bf16 before P·V, as the bf16 paged kernel rounds p."""
    if q.device.type == "cpu":
        return decode_attention_paged_int8_reference(
            q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths,
            softmax_scale)
    name = "decode_attention_paged_int8"
    _check_query(q, name)
    _check_buffers(name, q.device, q.dtype, q.shape[2:], (q,))
    _check_buffers(name, q.device, torch.int8, q.shape[2:],
                   (k_pool, v_pool))
    _check_buffers(name, q.device, torch.float32, (q.shape[2], 1),
                   (k_scale, v_scale))
    if k_pool.shape != v_pool.shape or (
            k_scale.shape != v_scale.shape
            or k_scale.shape[:2] != k_pool.shape[:2]):
        raise ValueError(f"{name}: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} and scales "
                         f"{tuple(k_scale.shape)} / {tuple(v_scale.shape)} "
                         f"do not match")
    _check_paging(q, block_tables, lengths)
    scale = softmax_scale if softmax_scale is not None else q.shape[3] ** -0.5
    return _paged_int8_launch(q, k_pool, v_pool, k_scale, v_scale,
                              block_tables, lengths, scale)


# kernel launches by each wrapper (chip_smoke.py zeroes and reads them);
# the append wrapper also counts those with a per-row first key, the
# paged wrappers theirs by kernel source, and keep the split count of
# their last launch's grid
decode_attention.launches = 0
decode_attention.padded_launches = 0
decode_attention_paged.launches = 0
decode_attention_paged.source_launches = {}
decode_attention_paged.last_splits = None
decode_attention_paged_int8.launches = 0
decode_attention_paged_int8.source_launches = {}
decode_attention_paged_int8.last_splits = None
