"""The port's attention ops against the JAX package's Pallas kernels.

The same numpy inputs (fixed seeds) go through the Pallas kernel, run in
interpret mode on the CPU as the JAX package's own tests run it, and
through the port's wrapper, which on a CPU tensor takes its plain PyTorch
version — the function its CUDA kernel is held against on the card.
Tolerance: float32 on both sides, 1e-5 absolute and relative (the same
math summed in another order).
"""

import os
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import decode_attention as jax_decode
from deepspeed_tpu.ops.attention import (
    attention_reference as jax_attention_reference)
from deepspeed_tpu.models import decode_utils as jax_decode_utils
from deepspeed_tpu.ops import flash_attention as jax_flash
from deepspeed_tpu.ops.flash_attention import _flash_backward, _flash_forward
from deepspeed_tpu.utils.compat import tpu_interpret_mode
from deepspeed_tpu_torch.models.decode_utils import (cache_attn_mask,
                                                     paged_positions,
                                                     paged_write_rows)
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.ops import decode_attention as da
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops.attention import attention, attention_reference
from deepspeed_tpu_torch.ops.decode_attention import (
    GARBAGE_BLOCK, decode_attention, decode_attention_paged,
    gather_paged_cache)
from deepspeed_tpu_torch.ops.flash_attention import (
    FlashAttentionFunction, attention_delta, flash_attention, flash_attention_backward,
    flash_attention_backward_dkv, flash_attention_backward_reference,
    flash_attention_bthd, tma_view_error)

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# flash forward (TPU kernel _fwd_kernel)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tq,tk,block,causal", [
    (24, 24, 8, True),    # several query/key tiles, diagonal masking
    (8, 24, 8, True),     # Tq < Tk: bottom-right causal offset
    (24, 8, 8, True),     # Tq > Tk: fully masked rows get O = 0
    (13, 13, 13, True),   # a length no power of two divides
    (16, 24, 8, False),
])
def test_flash_matches_pallas(tq, tk, block, causal):
    rng = np.random.default_rng(tq * 100 + tk)
    q = rng.normal(size=(2, 2, tq, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, tk, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, tk, 16)).astype(np.float32)
    with tpu_interpret_mode():
        ref_o, ref_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), 0.25, causal, block,
                                        block)
    o, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             softmax_scale=0.25)
    _close(o, ref_o)
    _close(lse, ref_lse)


def test_dispatch_cpu_takes_the_reference():
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(1, 2, 10, 16)).astype(np.float32)
               for _ in range(3))
    mask = rng.random((1, 1, 10, 10)) > 0.3
    mask[..., 0] = True
    ref = jax_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), mask=jnp.asarray(mask))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    _close(attention_reference(*t, mask=torch.from_numpy(mask)), ref)
    # the dispatch takes no mask: on the CPU it is the dense reference
    for causal in (True, False):
        _close(attention(*t, causal=causal),
               jax_attention_reference(*map(jnp.asarray, (q, k, v)),
                                       causal=causal))


def _flash_cotangents(run):
    """The dO that each ``FlashAttentionFunction.backward`` is handed
    while ``run()`` differentiates."""
    seen = []
    real = FlashAttentionFunction.backward

    def backward(ctx, do, dlse):
        seen.append(do)
        return real(ctx, do, dlse)

    with mock.patch.object(FlashAttentionFunction, "backward",
                           staticmethod(backward)):
        run()
    assert seen
    return seen


def _bthd_cotangent():
    """dO as :func:`flash_attention_bthd` hands it: the cotangent of its
    ``[B, T, H, D]`` output, transposed."""
    leaves = [torch.zeros((2, 10, 3, 64), dtype=torch.bfloat16,
                          requires_grad=True) for _ in range(3)]
    return _flash_cotangents(
        lambda: flash_attention_bthd(*leaves).float().square().sum()
        .backward())


def _gpt2_cotangent():
    """dO as GPT-2's training path hands it: the cotangent of the
    attention output ``y4.transpose(1, 2)`` through the reshape and the
    output projection (``models/gpt2.py``), one per layer."""
    model = GPT2LMHeadModel(GPT2Config.tiny(), seed=0)
    ids = torch.randint(0, 256, (2, 24),
                        generator=torch.Generator().manual_seed(0))

    def run():
        out = model(ids)
        logits = out[0] if isinstance(out, tuple) else out
        logits.float().square().mean().backward()

    seen = _flash_cotangents(run)
    assert len(seen) == model.config.n_layer
    return seen


def _views(kind):
    """q, k, v as the port hands them to the bf16 kernels, or dO."""
    B, H, T, D = 2, 3, 10, 64
    if kind == "bhtd":
        return [torch.empty((B, H, T, D), dtype=torch.bfloat16)
                for _ in range(3)]
    if kind == "bthd":  # flash_attention_bthd's transposed views
        return [torch.empty((B, T, H, D), dtype=torch.bfloat16)
                .transpose(1, 2) for _ in range(3)]
    if kind == "bthd_do":
        return _bthd_cotangent()
    if kind == "gpt2_do":
        return _gpt2_cotangent()
    # GPT-2's fused projection: [B, T, 3C] split into q, k, v
    fused = torch.empty((B, T, 3 * H * D), dtype=torch.bfloat16)
    return [t.view(B, T, H, D).transpose(1, 2)
            for t in fused.split(H * D, dim=-1)]


@pytest.mark.parametrize("kind", ["bhtd", "bthd", "fused_qkv", "bthd_do",
                                  "gpt2_do"])
def test_tma_rule_accepts_the_ports_views(kind):
    for t in _views(kind):
        assert t.dtype == torch.bfloat16 and t.stride(-1) == 1
        assert tma_view_error(t.shape, t.stride(), t.element_size(),
                              t.data_ptr()) is None


def _c_arity(source):
    """Parameter count of ``ds_<source>`` in ``csrc/<source>.cu``."""
    path = os.path.join(os.path.dirname(fa.__file__), os.pardir, "csrc",
                        f"{source}.cu")
    with open(path) as f:
        text = f.read()
    params = re.search(rf'extern "C" int ds_{source}\((.*?)\)\s*{{', text,
                       re.S).group(1)
    return params.count(",") + 1


@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, "_sm90"),
                                          (torch.float32, "")])
def test_backward_launch_reaches_its_kernel_symbol(which, dtype, suffix):
    """``_dq_launch``/``_dkv_launch`` on CPU tensors with ``load`` patched
    to a stub library: bf16 calls the tensor-core entry point, fp32 the
    CUDA-core one, with as many arguments as its ctypes signature and its
    C declaration have, and the launch is counted."""
    calls = []

    class Lib:
        def __init__(self, source, sigs):
            self.source, self.sigs = source, sigs

        def __getattr__(self, fn):
            def call(*args):
                calls.append((self.source, fn, len(args),
                              len(self.sigs[fn][0])))
                return 0
            return call

    B, H, T, D = 2, 3, 10, 64
    q, k, v = _views("bthd")  # strided views, as the [B, T, H, D] entry
    q, k, v = (t.to(dtype) if dtype != torch.bfloat16 else t
               for t in (q, k, v))
    do = torch.zeros((B, H, T, D), dtype=dtype)
    lse, delta = (torch.zeros((B, H, T)) for _ in range(2))
    launch = fa._dq_launch if which == "dq" else fa._dkv_launch
    counter = (fa.flash_attention_backward if which == "dq"
               else fa.flash_attention_backward_dkv)
    with mock.patch.object(fa, "load", Lib), \
            mock.patch.object(fa, "_stream", lambda t: 0), \
            mock.patch.object(counter, "launches", 0):
        launch(q, k, v, do, lse, delta, True, 0.125)
        assert counter.launches == 1
    source = f"flash_bwd_{which}{suffix}"
    n = len(fa._SIGS[source][0])
    assert calls == [(source, f"ds_{source}", n, n)]
    assert _c_arity(source) == n


@pytest.mark.parametrize("case", ["row_stride", "base", "last_dim", "width"])
def test_tma_rule_refuses_misaligned_views(case):
    """A view TMA cannot address is refused with its reason: a token
    stride of 65 elements (130 bytes), a base 2 bytes past alignment, a
    strided last dim, rows of 4 bf16 values (8 bytes)."""
    shape, strides, ptr = (2, 3, 10, 64), (3 * 10 * 64, 10 * 64, 64, 1), 0
    if case == "row_stride":
        strides = (3 * 10 * 65, 10 * 65, 65, 1)
    elif case == "base":
        ptr = 2
    elif case == "last_dim":
        strides = (2 * 3 * 10 * 64, 2 * 10 * 64, 2 * 64, 2)
    else:
        shape, strides = (2, 3, 10, 4), (120, 40, 4, 1)
    assert tma_view_error(shape, strides, 2, ptr) is not None
    # a dim of size 1 is never stepped: its stride does not count
    assert tma_view_error((1, 3, 10, 64), (7, 640, 64, 1), 2, 0) is None


# ---------------------------------------------------------------------------
# flash backward (TPU kernels _bwd_dq_kernel, _bwd_dkv_kernel) and the
# autograd function around the forward and backward
# ---------------------------------------------------------------------------
BWD_CASES = [
    (24, 24, 8, True),    # several query/key tiles, diagonal masking
    (8, 24, 8, True),     # Tq < Tk: bottom-right causal offset
    (24, 8, 8, True),     # Tq > Tk: fully masked rows get no gradient
    (13, 13, 13, True),   # a length no power of two divides
    (16, 24, 8, False),
]


@pytest.mark.parametrize("tq,tk,block,causal", BWD_CASES)
def test_flash_backward_matches_pallas(tq, tk, block, causal):
    rng = np.random.default_rng(tq * 100 + tk + 7)
    q = rng.normal(size=(2, 2, tq, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, tk, 16)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(2, 2, tq, 16)).astype(np.float32)
    with tpu_interpret_mode():
        o, lse = _flash_forward(*map(jnp.asarray, (q, k, v)), 0.25, causal,
                                block, block)
        ref = _flash_backward((*map(jnp.asarray, (q, k, v)), o, lse),
                              jnp.asarray(do), 0.25, causal, block, block)
    t = [torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, do)]
    got = flash_attention_backward_reference(*t, causal=causal,
                                             softmax_scale=0.25)
    for g, r in zip(got, ref):
        _close(g, r)
    # the two CPU wrappers take the same plain versions
    qt, kt, vt, ot, lt, dot = t
    delta = attention_delta(dot, ot)
    _close(flash_attention_backward(qt, kt, vt, dot, lt, delta, causal,
                                    0.25), ref[0])
    for g, r in zip(flash_attention_backward_dkv(qt, kt, vt, dot, lt, delta,
                                                 causal, 0.25), ref[1:]):
        _close(g, r)


def _grads_of(fn, arrays, weight):
    """Gradients of sum(fn(q, k, v) * weight) w.r.t. q, k and v."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (fn(*leaves) * torch.from_numpy(weight)).sum().backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
def test_flash_autograd_matches_jax_grad(layout):
    """The autograd function (forward and backward plain versions on the
    CPU) against ``jax.grad`` of the JAX package's custom-vjp flash
    attention, Pallas kernels in interpret mode."""
    rng = np.random.default_rng(11)
    shape = (2, 2, 16, 16) if layout == "bhtd" else (2, 16, 2, 16)
    q, k, v, w = (rng.normal(size=shape).astype(np.float32)
                  for _ in range(4))
    if layout == "bhtd":
        jax_fn, port_fn = jax_flash.flash_attention, (
            lambda *a: flash_attention(*a, causal=True)[0])
    else:
        jax_fn, port_fn = jax_flash.flash_attention_bthd, (
            lambda *a: flash_attention_bthd(*a, causal=True))

    def loss(q_, k_, v_):
        return (jax_fn(q_, k_, v_, True, None, 8, 8) * w).sum()

    with tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                     (q, k, v)))
    for g, r in zip(_grads_of(port_fn, (q, k, v), w), ref):
        _close(g, r)


def test_attention_gradients_match_dense_reference():
    """attention() is differentiable on the CPU through the flash
    function; its gradients equal the dense reference's autograd."""
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=(1, 2, 10, 16)).astype(np.float32)
              for _ in range(4)]
    got = _grads_of(attention, arrays[:3], arrays[3])
    want = _grads_of(attention_reference, arrays[:3], arrays[3])
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL)


# ---------------------------------------------------------------------------
# append-cache decode (TPU kernel _kernel)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("idx,tq", [(0, 1), (63, 1), (64, 1), (65, 3),
                                    (124, 4), (123, 5)])
def test_decode_matches_pallas(idx, tq):
    B, H, D, S = 2, 2, 16, 128
    rng = np.random.default_rng(idx + tq)
    kc = np.zeros((B, S, H, D), np.float32)
    vc = np.zeros((B, S, H, D), np.float32)
    kc[:, :idx + tq] = rng.normal(size=(B, idx + tq, H, D))
    vc[:, :idx + tq] = rng.normal(size=(B, idx + tq, H, D))
    kc[:, idx + tq:] = 1e4   # past the valid prefix: never read
    q = rng.normal(size=(B, tq, H, D)).astype(np.float32)
    with tpu_interpret_mode():
        ref = jax_decode.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                          jnp.asarray(vc), idx, block_k=64)
    out = decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc),
                           torch.tensor(idx, dtype=torch.int32))
    _close(out, ref)


@pytest.mark.parametrize("b,h,tq,s", [
    (2, 12, 1, 1024), (1, 12, 1, 1024), (2, 12, 5, 1024), (2, 12, 1, 192),
    (16, 12, 1, 1024), (1, 1, 1, 100_000), (2, 12, 1, 64), (1, 2, 1, 63),
    (2, 12, 1, 16384)])
def test_append_splits_cover_the_cache(b, h, tq, s):
    """The append kernel's split: from the shapes alone (no cache index
    among its arguments), at most 64. The full cache ``[0, S)`` cut into
    that many splits leaves each at least :data:`MIN_SPLIT_KEYS` >= 64
    keys (one split where the cache holds fewer): at B=2 H=12 S=1024 (the
    timed shape) that bounds it at 4 splits, 96 CTAs; a cache long enough
    takes 264 CTAs or more, two on each of the H100's 132 SMs. How the
    kernel cuts the keys a row group sees is held on the card
    (``chip_smoke.py``'s append cases, a split boundary among them)."""
    splits = da.decode_splits(b, h, tq, s, 132, da.MIN_SPLIT_KEYS)
    assert 1 <= splits <= da.MAX_SPLITS
    assert da.MIN_SPLIT_KEYS >= 64
    assert splits == 1 or s // splits >= da.MIN_SPLIT_KEYS
    ctas = b * h * -(-tq // da.DEC_ROWS) * splits
    if (b, h, tq, s) == (2, 12, 1, 1024):
        assert splits == 1024 // da.MIN_SPLIT_KEYS
    if (b, h, tq, s) == (2, 12, 1, 16384):
        assert ctas >= 2 * 132
    if s >= da.MIN_SPLIT_KEYS * da.MAX_SPLITS:   # a long cache fills the card
        assert ctas >= min(2 * 132, b * h * -(-tq // da.DEC_ROWS)
                           * da.MAX_SPLITS)


def test_append_launch_is_one_call_with_workspace_and_tickets():
    """``_append_launch`` (what :func:`decode_attention` runs on the card)
    with ``load`` patched to a stub library: one call of
    ``ds_decode_append`` per step, with as many arguments as its ctypes
    signature and C declaration, the cached fp32 workspace and zeroed
    int32 tickets of the sizes the split needs, the same split whatever
    the cache index, and the launch counted; a left-padded batch's ``pad``
    goes in as the first-key pointer (null without one) and counts as a
    launch with a first key. The paged kernels' split decode on the same
    stream takes the same workspace and tickets."""
    calls = []

    class Lib:
        def __getattr__(self, fn):
            def call(*args):
                calls.append((fn, args))
                return 0
            return call

    B, S, H, D, tq = 2, 1024, 12, 64, 5
    q = torch.zeros((B, tq, H, D), dtype=torch.bfloat16)
    kc = torch.zeros((B, S, H, D), dtype=torch.bfloat16)
    with mock.patch.object(da, "load", lambda src, sigs: Lib()), \
            mock.patch.object(da, "_stream", lambda t: 0), \
            mock.patch.object(da, "_sm_count", lambda dev: 132), \
            mock.patch.object(da, "_WORKSPACE", {}), \
            mock.patch.object(decode_attention, "launches", 0), \
            mock.patch.object(decode_attention, "padded_launches", 0), \
            mock.patch.object(decode_attention_paged, "launches", 0):
        for idx in (0, 700, S - tq):
            da._append_launch(q, kc, kc, torch.tensor(idx, dtype=torch.int32),
                              0.125)
        pad = torch.tensor([3, 0], dtype=torch.int32)
        da._append_launch(q, kc, kc, torch.tensor(9, dtype=torch.int32),
                          0.125, pad)
        assert decode_attention.launches == 4
        assert decode_attention.padded_launches == 1
        ws, tickets = da._WORKSPACE[(q.device, 0)]
        # a paged step that needs no more of either
        da._paged_launch(q[:1, :1], kc[:, :16], kc[:, :16],
                         torch.ones((1, 4), dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), 0.125)
        assert da._WORKSPACE[(q.device, 0)] == (ws, tickets)
        assert decode_attention_paged.launches == 1
    splits = da.decode_splits(B, H, tq, S, 132, da.MIN_SPLIT_KEYS)
    groups = 2
    n = len(da._APPEND_SIG["ds_decode_append"][0])
    assert _c_arity("decode_append") == n
    assert [fn for fn, _ in calls] == ["ds_decode_append"] * 4 + [
        "ds_decode_paged"]
    for _, args in calls[:4]:
        assert len(args) == n
        assert args[6:8] == (ws.data_ptr(), tickets.data_ptr())
        assert args[8:16] == (1, B, tq, H, D, S, splits, da.MIN_SPLIT_KEYS)
    assert [args[4] for _, args in calls[:4]] == [None] * 3 + [
        pad.data_ptr()]
    assert calls[4][1][6:8] == (ws.data_ptr(), tickets.data_ptr())
    assert ws.dtype == torch.float32
    assert ws.numel() == B * H * groups * splits * da.DEC_ROWS * (D + 2)
    assert tickets.dtype == torch.int32 and tickets.numel() == B * H * groups
    assert not tickets.any()


def test_append_launch_error_drops_its_workspace():
    """A launch that fails raises, and its (device, stream) workspace is
    dropped, so no ticket it may have left taken reaches a later launch:
    the next call gets fresh, zeroed tickets."""
    class Lib:
        def __init__(self, err):
            self.err = err

        def ds_decode_append(self, *args):
            return self.err

    q = torch.zeros((1, 1, 2, 16))
    kc = torch.zeros((1, 256, 2, 16))
    index = torch.tensor(3, dtype=torch.int32)
    with mock.patch.object(da, "_stream", lambda t: 7), \
            mock.patch.object(da, "_sm_count", lambda dev: 132), \
            mock.patch.object(da, "_WORKSPACE", {}), \
            mock.patch.object(decode_attention, "launches", 0):
        with mock.patch.object(da, "load", lambda src, sigs: Lib(0)):
            da._append_launch(q, kc, kc, index, 0.25)
        first = da._WORKSPACE[(q.device, 7)]
        with mock.patch.object(da, "load", lambda src, sigs: Lib(700)):
            with pytest.raises(RuntimeError, match="error 700"):
                da._append_launch(q, kc, kc, index, 0.25)
        assert (q.device, 7) not in da._WORKSPACE
        with mock.patch.object(da, "load", lambda src, sigs: Lib(0)):
            da._append_launch(q, kc, kc, index, 0.25)
        again = da._WORKSPACE[(q.device, 7)]
        assert again[1] is not first[1] and not again[1].any()
        assert decode_attention.launches == 2


# ---------------------------------------------------------------------------
# paged decode (TPU kernel _paged_kernel)
# ---------------------------------------------------------------------------
def _paged_inputs(lengths, tq, bs=16, mb=4, H=2, D=16, seed=0):
    """Random pools and per-row permuted block tables covering each row's
    ``length + tq`` positions; unallocated entries name the garbage
    block."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    nb = 1 + B * mb
    kp = rng.normal(size=(nb, bs, H, D)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, H, D)).astype(np.float32)
    tables = np.full((B, mb), GARBAGE_BLOCK, np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    for b, ln in enumerate(lengths):
        need = -(-(ln + tq) // bs)
        tables[b, :need] = [free.pop() for _ in range(need)]
    q = rng.normal(size=(B, tq, H, D)).astype(np.float32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("lengths,tq", [
    ([0, 15, 16, 17], 1),   # empty row, block boundaries
    ([5, 31, 40], 3),       # T_q > 1: per-row causal (verify step)
    ([0], 80),              # a first prefill chunk, T_q > 64
    ([40], 70),             # a chunk that starts inside a block
])
def test_paged_matches_pallas(lengths, tq):
    mb = max(4, -(-(max(lengths) + tq) // 16))
    arrays = _paged_inputs(lengths, tq, mb=mb, seed=sum(lengths) + tq)
    with tpu_interpret_mode():
        ref = jax_decode.decode_attention_paged(*map(jnp.asarray, arrays))
    out = decode_attention_paged(*map(torch.from_numpy, arrays))
    _close(out, ref)


@pytest.mark.parametrize("tq,dtype", [(1, torch.bfloat16),
                                      (5, torch.bfloat16),
                                      (256, torch.bfloat16),
                                      (5, torch.float32)])
def test_paged_launch_is_one_split_decode(tq, dtype):
    """``_paged_launch`` (what :func:`decode_attention_paged` runs on the
    card) with ``load`` patched to a stub library: decode, verify and
    chunk steps alike are one call of ``ds_decode_paged``, with as many
    arguments as its ctypes signature and C declaration, on a grid of
    :func:`decode_splits` splits for MB x block size keys (the shapes
    alone: the lengths never reach the host), the module's
    ``PAGED_MIN_SPLIT_KEYS`` and the (device, stream) workspace; the
    launch is counted under its source."""
    calls = []

    class Lib:
        def __getattr__(self, fn):
            def call(*args):
                calls.append((fn, args))
                return 0
            return call

    B, H, D, NB, BS, MB = 4, 12, 64, 257, 16, 64
    q = torch.zeros((B, tq, H, D), dtype=dtype)
    pool = torch.zeros((NB, BS, H, D), dtype=dtype)
    tables = torch.ones((B, MB), dtype=torch.int32)
    with mock.patch.object(da, "load", lambda src, sigs: Lib()), \
            mock.patch.object(da, "_stream", lambda t: 3), \
            mock.patch.object(da, "_sm_count", lambda dev: 132), \
            mock.patch.object(da, "_WORKSPACE", {}), \
            mock.patch.object(decode_attention_paged, "launches", 0), \
            mock.patch.object(decode_attention_paged, "source_launches", {}):
        for lengths in ([0, 137, 602, 1000], [8, 40, 100, 230]):
            da._paged_launch(q, pool, pool, tables,
                             torch.tensor(lengths, dtype=torch.int32), 0.125)
        ws, tickets = da._WORKSPACE[(q.device, 3)]
        assert decode_attention_paged.launches == 2
        assert decode_attention_paged.source_launches == {"decode_paged": 2}
        splits = da.decode_splits(B, H, tq, MB * BS, 132,
                                  da.PAGED_MIN_SPLIT_KEYS)
        assert decode_attention_paged.last_splits == splits
    n = len(da._PAGED_SIG["ds_decode_paged"][0])
    assert _c_arity("decode_paged") == n
    assert [fn for fn, _ in calls] == ["ds_decode_paged"] * 2
    assert calls[0][1][6:] == calls[1][1][6:]   # the lengths never count
    args = calls[0][1]
    assert len(args) == n
    assert args[6:8] == (ws.data_ptr(), tickets.data_ptr())
    assert args[8:18] == (int(dtype == torch.bfloat16), B, tq, H, D, NB, BS,
                          MB, splits, da.PAGED_MIN_SPLIT_KEYS)
    assert ws.numel() == B * H * -(-tq // da.DEC_ROWS) * splits \
        * da.DEC_ROWS * (D + 2)
    assert splits == 1 or MB * BS // splits >= da.PAGED_MIN_SPLIT_KEYS


def test_paged_garbage_block_never_contributes():
    q, kp, vp, tables, lengths = _paged_inputs([3, 20], 1, seed=7)
    out = decode_attention_paged(*map(torch.from_numpy,
                                      (q, kp, vp, tables, lengths)))
    kp[GARBAGE_BLOCK] = 1e4
    vp[GARBAGE_BLOCK] = np.nan
    poisoned = decode_attention_paged(*map(torch.from_numpy,
                                           (q, kp, vp, tables, lengths)))
    np.testing.assert_array_equal(out.numpy(), poisoned.numpy())


def test_gather_paged_cache_matches_jax():
    _, kp, _, tables, _ = _paged_inputs([9, 33], 1, seed=2)
    ref = jax_decode.gather_paged_cache(jnp.asarray(kp), jnp.asarray(tables))
    _close(gather_paged_cache(torch.from_numpy(kp),
                              torch.from_numpy(tables)), ref)


# ---------------------------------------------------------------------------
# paged write addressing (decode_utils)
# ---------------------------------------------------------------------------
def test_paged_write_rows_send_pads_to_the_garbage_block():
    """Right-padded prefill tails and idle slots write into block 0, never
    over a real row; real tokens map through the block table."""
    tables = np.array([[3, 5, 0], [2, 0, 0], [0, 0, 0]], np.int32)
    lengths = np.array([0, 6, 0], np.int32)
    num_valid = np.array([5, 1, 0], np.int32)
    ref = jax_decode_utils.paged_write_rows(
        jnp.asarray(tables), jax_decode_utils.paged_positions(
            jnp.asarray(lengths), 8), jnp.asarray(num_valid), 4)
    rows = paged_write_rows(torch.from_numpy(tables),
                            paged_positions(torch.from_numpy(lengths), 8),
                            torch.from_numpy(num_valid), 4)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref))
    assert (rows[0, 5:] < 4).all() and (rows[2] < 4).all()  # garbage block
    assert rows[0, :5].tolist() == [12, 13, 14, 15, 20]


@pytest.mark.parametrize("idx", [3, [0, 2, 7]])
def test_cache_attn_mask_matches_jax(idx):
    ref = jax_decode_utils.cache_attn_mask(10, jnp.asarray(idx), 3)
    np.testing.assert_array_equal(
        cache_attn_mask(10, torch.tensor(idx), 3).numpy(), np.asarray(ref))
