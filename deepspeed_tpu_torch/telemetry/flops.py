"""FLOP counting through the port's own kernels (the ``step_cost``
collector's counter).

``torch.utils.flop_counter.FlopCounterMode`` counts the aten matmuls a
call dispatches, but a custom op is one opaque op to it and a wrapper
that launches a kernel through ``ctypes`` dispatches nothing. So:

- the custom ops (``deepspeed_tpu_torch::flash_fwd``,
  ``deepspeed_tpu_torch::block_sparse_fwd``) get a FLOP formula
  registered with the counter (:func:`register_formulas`);
- the backward kernels and the decode kernels, which the autograd
  functions and the models call as plain Python wrappers, report their
  FLOPs to the counter of the current counting call through
  :func:`counted`, and run with the counter hidden, so the plain
  version's matmuls on the CPU are not counted a second time.

Attention counts the dense convention of ``bench.py`` (PaLM appendix B):
forward ``4 * B * H * Tq * Tk * D``, backward twice that, halved when
causal; block-sparse attention counts its layout's visible blocks;
decode counts its cache window. Outside a counting call (telemetry off,
or a signature already seen) :func:`counted` is one global read.
"""

import contextlib

_ACTIVE = None  # the FlopCounterMode of the counting call in flight


def counting() -> bool:
    return _ACTIVE is not None


def attention_flops(b, h, tq, tk, d, causal=False, passes=1) -> int:
    """Dense attention FLOPs: ``passes`` = 1 for the forward (QK^T, PV),
    2 for the backward (dV, dP, dQ, dK); causal halves them."""
    flops = 4 * b * h * tq * tk * d * passes
    return flops // 2 if causal else flops


def counted(name: str, flops, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``; inside a counting call, ``flops()`` FLOPs
    are added to the counter under ``name`` and ``fn`` runs with it
    hidden (``flops`` is only called there)."""
    if _ACTIVE is None:
        return fn(*args, **kwargs)
    from torch.utils._python_dispatch import _disable_current_modes

    _ACTIVE.flop_counts["Global"][name] += int(flops())
    with _disable_current_modes():
        return fn(*args, **kwargs)


@contextlib.contextmanager
def counter():
    """A ``FlopCounterMode`` (the port's formulas registered) that also
    receives the wrappers' :func:`counted` FLOPs; yields it."""
    global _ACTIVE
    from torch.utils.flop_counter import FlopCounterMode

    register_formulas()
    mode = FlopCounterMode(display=False)
    prev, _ACTIVE = _ACTIVE, mode
    try:
        with mode:
            yield mode
    finally:
        _ACTIVE = prev


_REGISTERED = False


def register_formulas():
    """Register the custom ops' FLOP formulas with the counter (once)."""
    global _REGISTERED
    if _REGISTERED:
        return
    import torch
    from torch.utils.flop_counter import register_flop_formula

    import deepspeed_tpu_torch.ops.flash_attention  # noqa: F401
    import deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel  # noqa: F401,E501

    @register_flop_formula(torch.ops.deepspeed_tpu_torch.flash_fwd)
    def _flash_fwd(q, k, v, causal, scale, *args, out_shape=None, **kw):
        b, h, tq, d = q
        return attention_flops(b, h, tq, k[2], d, causal)

    @register_flop_formula(torch.ops.deepspeed_tpu_torch.block_sparse_fwd)
    def _block_sparse_fwd(q, k, v, layout, row_ptr, col_idx, *args,
                          out_shape=None, **kw):
        return block_sparse_flops(q, layout, col_idx[0])

    _REGISTERED = True


def block_sparse_flops(q_shape, layout_shape, visible: int,
                       passes=1) -> int:
    """Block-sparse attention FLOPs over the layout's ``visible`` blocks
    (the CSR column list's length: shapes only, no device read); a
    layout of fewer heads than q repeats over them."""
    b, h, sq, d = q_shape
    lh, nq = layout_shape[0], layout_shape[1]
    block = sq // max(1, nq)
    return 4 * b * (visible * h // lh) * block * block * d * passes


def decode_flops(q, window: int) -> int:
    """Decode attention FLOPs (q ``[B, T_q, H, D]``) over the cache
    window a step reads (the whole window: its valid length lives on the
    device, and reading it would sync)."""
    b, tq, h, d = q.shape
    return 4 * b * h * tq * int(window) * d
