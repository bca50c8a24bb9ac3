"""Quantizers of ``deepspeed_tpu/ops/quantizer.py`` on the card.

Row-wise int8 codec of the paged KV pools (counterpart of
``quantizer.py:83-104``): symmetric int8 with one fp32 scale per row along
``axis``: the serving engine's ``kv_cache_dtype: "int8"`` stores every
pool row (one token x head) as int8 codes plus its scale in a side pool
indexed by the same block table. These are plain array operations in the
JAX package too, not a Pallas kernel. ``torch.round`` rounds half to even
like ``jnp.round``, and the division is a true division (not a multiply
by a reciprocal), so the codes and scales match the JAX package's bit for
bit.

Per-tensor int8 with stochastic rounding (counterpart of the Pallas
kernel ``stochastic_quantize_tpu``, ``quantizer.py:131-164``):
:func:`stochastic_quantize` launches ``csrc/stochastic_quantize.cu`` for a
CUDA tensor, :func:`stochastic_quantize_reference` is its plain version.
No path of the JAX package calls that kernel (its quantized collectives,
``runtime/comm/quantized.py``, round to nearest through
``quantize_chunks``), and no path of the port calls this one: it is the
stand-alone function the JAX package has. The JAX kernel takes fp32
only, and in Pallas' interpret mode on the CPU its PRNG draws all-zero
bits, so there its codes are ``floor(x / scale)``: the CPU tests hold the
plain version with ``u = 0`` to it bit for bit. The TPU's bits cannot be
matched on the card; both versions here draw Philox4x32-10, keyed by
(seed, element index), so the kernel and its plain version agree bit for
bit whatever the launch shape.
"""

import ctypes

import torch

from deepspeed_tpu_torch.ops.op_builder import load

_P = ctypes.c_void_p
_SIG = {"ds_stochastic_quantize": (
    [_P] * 4 + [ctypes.c_longlong, ctypes.c_uint] + [ctypes.c_int] * 2 + [_P],
    ctypes.c_int),
        "ds_stochastic_quantize_grid": ([ctypes.POINTER(ctypes.c_int)],
                                        ctypes.c_int)}
# the cooperative grid of each device (CTAs an SM times SMs), queried once
_GRID = {}

# Philox4x32-10 (Salmon et al. 2011; the constants of PyTorch's
# ATen/core/PhiloxRNGEngine.h): round multipliers and key increments
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK = 0xFFFFFFFF


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


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of the counter words ``c0..c3`` (int64 tensors holding
    uint32 values) under the key ``(k0, k1)`` (Python ints): the four
    output words, int64 tensors holding uint32 values. A product of two
    uint32 values wraps in int64 but keeps its low 64 bits, so the high
    word is ``(p >> 32) & 0xFFFFFFFF`` and the low ``p & 0xFFFFFFFF``."""
    k0, k1 = k0 & _MASK, k1 & _MASK
    for _ in range(10):
        p0, p1 = c0 * PHILOX_M[0], c2 * PHILOX_M[1]
        c0, c1, c2, c3 = (((p1 >> 32) & _MASK) ^ c1 ^ k0, p1 & _MASK,
                          ((p0 >> 32) & _MASK) ^ c3 ^ k1, p0 & _MASK)
        k0, k1 = (k0 + PHILOX_W[0]) & _MASK, (k1 + PHILOX_W[1]) & _MASK
    return c0, c1, c2, c3


def stochastic_uniforms(n, seed, device=None):
    """The kernel's ``u`` in [0, 1) for elements ``0..n-1``: element ``i``
    takes word ``i & 3`` of Philox4x32-10 at counter ``(i >> 2, 0, 0, 0)``
    (the 64-bit ``i >> 2`` in the first two words) under the key ``(seed,
    0)``, and ``u`` is its top 24 bits times 2^-24, as the TPU kernel
    turns its random word into ``u``."""
    ctr = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(ctr)
    words = torch.stack(philox4x32_10(ctr & _MASK, ctr >> 32, zero, zero,
                                      seed, 0), dim=1).reshape(-1)[:n]
    return (words >> 8).to(torch.float32) * 2.0 ** -24


def _check_stochastic(x, num_bits):
    if num_bits != 8:
        raise NotImplementedError("stochastic path supports int8")
    if x.dtype != torch.float32:
        raise ValueError(f"stochastic_quantize takes fp32, as the TPU kernel "
                         f"does, got {x.dtype}")


def stochastic_quantize_reference(x, seed: int, num_bits: int = 8, u=None):
    """Plain version of :func:`stochastic_quantize`: ``(q int8 like x,
    scale fp32 0-d)`` with scale = absmax / 127 (1 where that is 0) and q =
    clip(floor(x / scale + u), -128, 127). ``u`` (x's shape, fp32)
    replaces the Philox draw when given: zeros are what the Pallas kernel
    draws in interpret mode. A NaN in ``x`` makes the scale NaN and every
    code 0, as in the Pallas kernel."""
    _check_stochastic(x, num_bits)
    absmax = x.abs().amax() if x.numel() else x.new_zeros(())
    # a tensor divisor (filled on the device, no upload): torch multiplies
    # a CUDA tensor by the reciprocal of a Python scalar divisor, which can
    # miss the exact quotient by an ulp
    scale = absmax / torch.full_like(absmax, 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    if u is None:
        u = stochastic_uniforms(x.numel(), seed, x.device).view(x.shape)
    q = torch.nan_to_num(torch.floor(x / scale + u), nan=0.0)
    return q.clamp(-128, 127).to(torch.int8), scale


def stochastic_quantize(x, seed: int, num_bits: int = 8):
    """Per-tensor symmetric int8 with stochastic rounding: ``(q int8 like
    x, scale fp32 0-d)``, ``E[q * scale] = x`` inside the clip. fp32 only;
    a CPU tensor takes the plain version, a CUDA tensor launches
    ``csrc/stochastic_quantize.cu`` (one cooperative launch: absmax, a
    grid sync, then the codes) or raises. An empty tensor returns the
    plain version's result and launches nothing."""
    _check_stochastic(x, num_bits)
    if x.device.type == "cpu" or x.numel() == 0:
        return stochastic_quantize_reference(x, seed)
    if x.device.type != "cuda":
        raise ValueError(f"stochastic_quantize runs on cuda or cpu, got "
                         f"{x.device}")
    x = x.contiguous()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    launch_passes(x, q, scale, seed, 3)
    return q, scale


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _grid(lib, device):
    """The cooperative grid of ``device`` (resident CTAs an SM times SMs),
    from the occupancy API once a device."""
    grid = _GRID.get(device.index)
    if grid is None:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.ds_stochastic_quantize_grid(ctypes.byref(blocks))
        if err:
            raise RuntimeError(f"stochastic_quantize: occupancy query "
                               f"failed: CUDA error {err}")
        grid = _GRID[device.index] = blocks.value
    return grid


def launch_passes(x, q, scale, seed: int, passes: int):
    """One launch of the kernel on contiguous fp32 ``x`` (any alignment),
    writing ``q`` and the 0-d ``scale``: ``passes`` 3 is a call of
    :func:`stochastic_quantize`; 1 (absmax and scale only) and 2 (codes
    from the scale already in ``scale``, every tile brought from L2 or
    device memory, the fast path wherever the scale allows it) time the
    passes apart (``tools/time_quantize.py``)."""
    lib = load("stochastic_quantize", _SIG)
    grid = _grid(lib, x.device)
    # two slots a CTA (its absmax, its least nonzero |x|): each CTA writes
    # its own before the grid syncs, so nothing needs zeroing
    partial = torch.empty(2 * grid, dtype=torch.float32, device=x.device)
    err = lib.ds_stochastic_quantize(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), partial.data_ptr(),
        x.numel(), seed & _MASK, passes, grid, _stream(x))
    if err:
        raise RuntimeError(f"stochastic_quantize kernel launch failed: CUDA "
                           f"error {err}")
    stochastic_quantize.launches += 1


# kernel launches by the wrapper (chip_smoke.py zeroes and reads them)
stochastic_quantize.launches = 0
