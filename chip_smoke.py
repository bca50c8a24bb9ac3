#!/usr/bin/env python3
"""Drive the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero and prints no result line:

1. build the seventeen CUDA sources from ``deepspeed_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once), print the card, each kernel's ptxas
   registers and spills (for the seven tensor-core sources, the bf16
   flash forward, dQ and dK/dV, the bf16 block-sparse forward, dQ and
   dK/dV, by template instance: head dim and warpgroups, and the int8
   paged chunk kernel), and the count of
   HGMMA (``wgmma``) instructions in each tensor-core source's SASS
   (``cuobjdump -sass``): there must be some, and no spills;
2. hold each kernel against its plain PyTorch version on the card, at the
   serving and training paths' shapes and at ragged ones, in bf16 and
   fp32 — the flash kernels also on ``[B, T, H, D]`` views through
   ``flash_attention_bthd`` and non-causal at BERT's dense shape (the
   forward also at Tq != Tk and head dims 16, 32 and 128, O within the
   dtype's tolerance and lse within 1e-3; the backward also at B=1
   (64 rows a CTA), D=128 over several tiles and T=16; in bf16 the three
   flash kernels run on the tensor cores, in fp32 on the CUDA cores), the
   paged kernels (bf16/fp32 and int8 pools; the split decode, and for
   bf16 chunks of at least 8 rows over int8 pools the tensor-core chunk
   kernel, each row naming the source that ran and its grid's splits)
   also at the verify (T_q = 5) shape, at the fast path's decode step and
   prefill chunks (a first one, a partial last one, one that starts
   inside a block, and T_q at the tensor-core crossover and just below
   it), the block-sparse kernels at the
   BERT slice's shape (fixed per-head layout, block 128, 2 x 16 x 4096),
   at bench_sparse.py's BigBird one (block 256, 1 x 12 x 8192), at a
   fixed layout of block 32 (1 x 4 x 1024) and at a per-head BigBird
   layout of block 64 (2 x 4 x 1024; in bf16 the forward and backward run
   on the tensor cores at blocks 64, 128 and 256 and on the CUDA cores at
   32, each source checked to be the one launched), the append kernel
   (split over the cache) also at T_q = 5 on a full cache, B = 1, D =
   128, an index whose keys end on a split boundary and one inside the
   first split, and twice on the same inputs, bitwise equal; then with a
   per-row first key (left-padded rows, pads 0 / 37 / 500 / 1000 at idx
   1000, so one row sees a single key, at T_q = 1 and 4, and the padded
   phase's first step), the pad rows filled with values it must not
   read, each launch counted as one with a first key; the
   stochastic int8 quantizer (fp32, one cooperative launch a call) bit for
   bit at two seeds on GPT-2 125M's gradient shapes, a ragged one and
   zeros, with its rounding checked against its contract (floor or floor
   + 1, the share rounded up within 5 sigma of the mean fraction) and its
   two passes timed apart, then on inputs that stress its division (x = k
   scale (1 +- 2^-23) at several scales, subnormal x, +-inf) and its
   edges (one element, n = 16 m + 7, an unaligned view; an empty tensor
   launches nothing) — and
   time kernel, plain version and (where one exists) the PyTorch library
   call computing the same function (for block-sparse attention SDPA with
   the layout expanded to a boolean mask), beside the least time the card
   could take (bound). ``ms``, ``plain_ms`` and ``library_ms`` are device
   times (CUDA events around calls the host queued ahead of the device,
   see :func:`device_ms`); ``wrapper_ms`` is the time of back-to-back
   wrapper calls on CUDA events, which the host's launch rate sets for
   the microsecond decode kernels;
3. train GPT-2 125M at full width with ``bench.py``'s configuration
   (batch 16 x 1024, bf16 over fp32 masters, dots remat, fused AdamW
   step, clip 1.0) through ``deepspeed_tpu_torch.initialize``: one
   warm-up step whose loss is within 0.3 of ln V, then 10 timed steps
   (tokens/s, MFU against 989 TF/s) over which the loss falls; then the
   first step's per-tensor gradients and the first three losses against
   a second engine from the same seed run with the plain versions (which
   takes the same 11 steps, its losses printed beside the kernel path's);
4. serve 8 requests through GPT-2 125M at full width (bf16, random
   weights from ``--seed``) with ``init_serving``, after one untimed
   warm-up pass of phases 4 and 5: every request finishes
   with its tokens, the flash and paged-decode kernels were launched, and
   the first token and first decode-step logits agree with the same
   engine run with the plain versions on the card;
5. ``init_inference(model).generate`` on a 2 x 128 prompt through the
   append-decode kernel, with the same logits check; then ("padded_generate",
   5b) ``generate(attention_mask=)`` on four prompts of 128 / 100 / 37 / 1
   tokens left-padded to 128, 32 new, greedy and then keyed: every decode
   launch of the append kernel carries a first key (372 of 372), and each
   row is held to its prompt's solo call (prefill and first-decode logits
   within 0.05 where the first tokens agree, tokens equal until the solo
   run's two best scores lie within 0.05); then a 100-token prompt
   through an engine with a ``serving`` section, which buckets it to 128
   (``bucket_legacy_generate``), against the unbucketed call;
6. the serving fast path on the same model. Leg A
   (``tools/profile_serving.py``'s ``FAST_SERVING``: prefix cache,
   256-token prefill chunks, int8 KV, 8 slots) serves 8 requests sharing
   a 384-token system prompt, the first alone to fill the cache: every
   request finishes with its tokens, requests 2-8 hit at least the
   system prompt, one copies a block on write, the int8 paged kernel ran
   with T_q > 1 (chunks), and prefill / first-decode logits agree with
   the plain-version run as in phase 4; then, for information, the
   stream without the prefix cache (TTFT) and over bf16 pools (token
   agreement, pool bytes). Leg B (speculative decoding, prompt lookup,
   k = 4, bf16 pools, 4 slots) serves tiled-motif prompts: every emitted
   token is within 0.05 of the largest logit at its position in one
   teacher-forced causal forward (flash kernel), and the prefill logits
   and every valid row of each request's first verify step agree with
   the plain-version run; tokens per verify step, acceptance and tokens/s
   against the stream without speculation are printed. With chunking on
   every prompt takes the chunk path, so leg
   A launches no flash forward; leg B's whole-prompt prefills do;
7. keyed sampling on the same model: the keyed draw
   (``ops/sampling.py``) on the card against the same function on the CPU
   over 64 rows of 50257 logits with mixed knobs (equal tokens, or a
   row whose two best perturbed scores lie within 1e-5); then
   ("sampled_serving") a staggered mix of 4 sampled and 2 greedy requests
   through a serving engine with a ``serving.sampling`` block: every
   request finishes, the greedy ones emit a sampling-free engine's tokens
   (and a greedy mix launches the same kernels the same number of times
   with and without the block), a sampled request resubmitted under
   another mix repeats its tokens bit for bit, and not every sampled
   stream is the greedy one; ("sampled_generate") ``generate(do_sample=
   True, seed=...)`` twice, bit for bit; and the host ms of a decode
   step with 4 sampled slots against 4 greedy ones;
8. "bert_sparse": BERT-large MLM at full width and depth through
   ``deepspeed_tpu_torch.initialize`` with ``bench_bert.py``'s keys (Adam,
   clip 1.0, bf16, fused step; ZeRO 0) and the reference's documented
   ``sparse_attention`` section at block 128 (``tools/profile_training.py``
   ``BERT_SPARSE``), 2 x 4096 tokens, dots remat: 3 warm-up and 5 timed
   steps, the first loss within 0.3 of ln V and falling, each block-sparse
   kernel launched 24 times a step (the dots policy saves the forward)
   and no flash kernel; then at 4 of the 24 layers (widths and sequence
   unchanged) the first 3 losses and the step-1 gradients against the
   plain versions; then the dense leg ("bert_dense": bench_bert.py's 64 x
   128, no section; one warm-up and 5 timed steps: ms/step, tokens/s,
   MFU) through the non-causal flash kernels.

Phases 3, 4, 5, 5b, 6, 7 and 8 are the main paths (6, 7 and 8 in two
legs each):
each sets every launch count to 0 just before it runs and reads the counts
just after, before its comparison runs.

The last line is ``{"ok": true, "device": {...}}``; the one before it
the card's name and power limit (``nvidia-smi``), and before that one
JSON object with the 13 rows of the kernel table (TPU kernels 1-13; no
path calls kernel 13, the quantizer, so its launches are 0) and row 7's
padded case (``decode_append_padded``: its launches with a first key):
each one's launches on each path, error, times and bound.
Without a card (``torch.cuda.is_available()`` false) it exits 2.
"""

import argparse
import collections
import contextlib
import json
import os
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np

KERNEL_SOURCES = ("flash_fwd_sm90", "flash_fwd", "flash_bwd_dq_sm90",
                  "flash_bwd_dq", "flash_bwd_dkv_sm90", "flash_bwd_dkv",
                  "decode_append", "decode_paged", "decode_paged_int8",
                  "decode_paged_int8_sm90",
                  "block_sparse_fwd_sm90", "block_sparse_fwd",
                  "block_sparse_bwd_dq_sm90",
                  "block_sparse_bwd_dq", "block_sparse_bwd_dkv_sm90",
                  "block_sparse_bwd_dkv", "stochastic_quantize")
# the tensor-core kernels, whose SASS must hold wgmma (HGMMA) instructions
WGMMA_SOURCES = ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90",
                 "block_sparse_fwd_sm90", "block_sparse_bwd_dq_sm90",
                 "block_sparse_bwd_dkv_sm90", "decode_paged_int8_sm90")
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and flop/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# the paged checks (bf16/fp32 and int8 pools): block size 16, 64 blocks a
# row; (lengths, T_q) — ragged lengths with an empty row, decode (T_q=1),
# verify at k=4 (T_q=5: one full group of 4 query rows and a partial one;
# the last row's table full), one 256-row prefill chunk at length 512;
# then the fast path's leg A: its decode step (8 slots at its requests'
# lengths halfway through their 32 new tokens), a first chunk (length 0,
# T_q=256), the partial last chunk of its 392-token prompt (length 256,
# T_q=136), a chunk that starts inside a block (length 200, T_q=100), and
# T_q at the int8 kernel's tensor-core crossover (decode_attention.
# TC_MIN_ROWS = 8) and just below it, after the 384-token system prompt
PAGED_CASES = (([0, 137, 602, 1000], 1), ([0, 137, 602, 1019], 5),
               ([512], 256),
               ([408, 440, 500, 630, 800, 955, 411, 445], 1),
               ([0], 256), ([256], 136), ([200], 100), ([384], 8),
               ([384], 7))
# Tolerances of kernel vs plain version on the same inputs:
# fp32 — the same math in another summation order (and exp per key or
#   per tile instead of per row): 1e-4 absolute and relative;
# bf16 — both round the unnormalized p to bf16 before P.V (the TPU
#   kernels' p.astype(v.dtype)), but against different running maxima,
#   and O itself rounds to bf16 (an ulp is 2^-8 relative): 2e-2 absolute,
#   1e-2 relative.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2)}
# GPT-2 125M end to end, kernels vs plain versions, bf16: the per-op
# bf16 differences above propagate through 12 layers; fp32 logits of
# |z| ~ 1 may move by a few bf16 ulps of the hidden state
LOGITS_ATOL = 5e-2
REPEATS = 20
# device_ms holds the device in a spin of this many clock cycles (~10 ms
# at the H100's 1.98 GHz boost clock) while the host queues the calls
SPIN_CYCLES = 20_000_000
TRAIN_STEPS = 10
# GPT-2 125M training, kernel path vs plain-version path from the same
# seed, bf16: the first losses agree to the bf16 noise of the forward
# (the logits stay fp32); step-1 gradients of each parameter tensor within
# 5 % relative L2 — both paths round p and ds to bf16 at the same points,
# but flash O differs by bf16 ulps (the running maxima), and the
# differences pass through 12 layers of bf16 backward
TRAIN_LOSS_ATOL = 0.05
TRAIN_GRAD_RTOL = 0.05


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def wrapper_ms(fn, repeats=REPEATS):
    """Mean time of ``fn()`` over ``repeats`` back-to-back calls on CUDA
    events, after two warm-up calls: host work between launches counts
    wherever the device waits for it."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def device_ms(fn, repeats=REPEATS):
    """Mean device time of one ``fn()`` call. The device spins
    (``torch.cuda._sleep``) while the host queues ``repeats`` calls
    between two CUDA events, so the device then runs them back to back
    without waiting for the host. If the spin ended before the host had
    queued the last call (the start event already passed), the time
    would include host gaps: measure again with a 4x longer spin."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / repeats
        spin *= 4
    raise RuntimeError(f"the host could not queue {repeats} calls within a "
                       f"spin of {spin // 4} cycles")


def times(kernel, plain, library=None):
    """The timing keys of one checked shape: device ms of the kernel, its
    plain version and the library call (where there is one), and the
    wrapper's back-to-back ms."""
    return {"ms": device_ms(kernel, REPEATS),
            "plain_ms": device_ms(plain, REPEATS),
            "library_ms": (device_ms(library, REPEATS)
                           if library is not None else None),
            "wrapper_ms": wrapper_ms(kernel)}


def bound(nbytes, flops):
    """The ``bound_ms`` and ``bound_by`` keys of a function that moves
    ``nbytes`` and does ``flops`` = {type: operations}. Each product is
    priced at the peak of the narrowest type that holds both of its
    operands exactly (bf16 q times int8 codes: bf16), whatever unit the
    kernel itself uses."""
    byte_s = nbytes / HBM_BYTES_PER_S
    op_s = sum(n / PEAK_FLOPS[dt] for dt, n in flops.items())
    return {"bound_ms": 1e3 * max(byte_s, op_s),
            "bound_by": "bytes" if byte_s >= op_s else "operations"}


def compare(name, got, want, dtype):
    import torch

    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs().max().item()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output not finite")
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"{name}: max |kernel - plain| = {err} beyond "
                             f"atol {atol} rtol {rtol}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def pairs(tq, tk, causal):
    """Visible (query, key) pairs of one head: the flash kernels' work."""
    if not causal:
        return tq * tk
    return sum(min(tk, max(0, i + tk - tq + 1)) for i in range(tq))


def rand_heads(b, h, t, d, layout, dtype, gen):
    """A random ``[B, H, T, D]`` operand: contiguous for ``bhtd``, a
    transposed view of a contiguous ``[B, T, H, D]`` tensor for ``bthd``
    (what :func:`flash_attention_bthd` hands the kernels)."""
    import torch

    if layout == "bthd":
        return (torch.randn((b, t, h, d), generator=gen, device="cuda")
                .to(dtype).transpose(1, 2))
    return torch.randn((b, h, t, d), generator=gen, device="cuda").to(dtype)


def shape_name(b, h, tq, tk, d, layout, causal=True):
    return (f"B={b} H={h} Tq={tq} Tk={tk} D={d} {layout}"
            + ("" if causal else " non-causal"))


# flash forward: serving prefill shapes (B=1), the training shape (B=16)
# in both layouts, a ragged [B, T, H, D] case, Tq != Tk both ways (rows
# that see no key), head dims 16, 32 and 128 alone (64 query rows a CTA)
# and with 128 rows a CTA (B * H * ceil(Tq / 128) >= 132; at Tq = 50 the
# second warpgroup of each CTA has no row), and BERT's dense leg last
# (bench_bert.py: B=64 T=128, 16 heads, non-causal); (B, H, Tq, Tk, D,
# layout, causal)
FWD_SHAPES = ((1, 12, 16, 16, 64, "bhtd", True),
              (1, 12, 100, 100, 64, "bhtd", True),
              (1, 12, 1024, 1024, 64, "bhtd", True),
              (16, 12, 1024, 1024, 64, "bhtd", True),
              (16, 12, 1024, 1024, 64, "bthd", True),
              (2, 12, 100, 100, 64, "bthd", True),
              (2, 4, 37, 100, 64, "bhtd", True),
              (2, 4, 100, 37, 64, "bthd", True),
              (1, 2, 77, 77, 16, "bhtd", True),
              (1, 2, 77, 77, 32, "bthd", True),
              (1, 2, 77, 77, 128, "bhtd", True),
              (8, 8, 256, 200, 16, "bhtd", True),
              (8, 8, 300, 300, 32, "bthd", True),
              (4, 16, 512, 512, 128, "bhtd", True),
              (16, 12, 50, 80, 64, "bthd", True),
              (64, 16, 128, 128, 64, "bthd", False))
# the flash shapes that are timed: GPT-2 training's and BERT's dense leg
TIMED_FLASH = ((16, 12, 1024), (64, 16, 128))
# flash backward: the training shape in both layouts (timed), then ragged
# and offset cases, B=1 at T=1024 (64 rows a CTA on the tensor cores),
# the other head dims (D=128 over several tiles with 128 rows a CTA), a
# short causal case, and BERT's dense leg last (timed); (B, H, Tq, Tk, D,
# layout, causal)
BWD_SHAPES = ((16, 12, 1024, 1024, 64, "bhtd", True),
              (16, 12, 1024, 1024, 64, "bthd", True),
              (2, 12, 100, 100, 64, "bhtd", True),
              (2, 12, 100, 100, 64, "bthd", True),
              (2, 4, 37, 100, 64, "bhtd", True),
              (2, 4, 100, 37, 64, "bhtd", True),
              (2, 4, 64, 100, 64, "bhtd", False),
              (1, 12, 1024, 1024, 64, "bhtd", True),
              (1, 2, 77, 77, 16, "bhtd", True),
              (1, 2, 77, 77, 32, "bthd", True),
              (1, 2, 77, 77, 128, "bhtd", True),
              (4, 16, 512, 512, 128, "bhtd", True),
              (8, 8, 300, 300, 32, "bthd", True),
              (1, 2, 16, 16, 64, "bhtd", True),
              (64, 16, 128, 128, 64, "bthd", False))


def check_flash(dtype, gen):
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bthd, flash_attention_reference)

    dt = str(dtype)[6:]
    rows = []
    for B, H, Tq, Tk, D, layout, causal in FWD_SHAPES:
        q = rand_heads(B, H, Tq, D, layout, dtype, gen)
        k, v = (rand_heads(B, H, Tk, D, layout, dtype, gen)
                for _ in range(2))
        name = shape_name(B, H, Tq, Tk, D, layout, causal)
        ro, rlse = flash_attention_reference(q, k, v, causal=causal)
        o, lse = flash_attention(q, k, v, causal=causal)
        if layout == "bthd":  # through the [B, T, H, D] entry
            qb, kb, vb = (t.transpose(1, 2) for t in (q, k, v))

            def kernel():
                return flash_attention_bthd(qb, kb, vb, causal=causal)

            o = kernel().transpose(1, 2)
        else:
            def kernel():
                return flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        lse_err = (lse - rlse).abs().max().item()
        if lse_err > 1e-3:
            raise AssertionError(f"flash {name} {dtype} lse error {lse_err}")
        err = compare(f"flash {name} {dtype}", o, ro, dt)
        nbytes = (2 * B * H * (Tq + Tk) * D * q.element_size()
                  + B * H * Tq * 4)
        flops = 4 * D * B * H * pairs(Tq, Tk, causal)
        # SDPA's causal mask is top-left aligned: the same function only
        # where Tq == Tk
        library = (None if causal and Tq != Tk else
                   lambda: F.scaled_dot_product_attention(q, k, v,
                                                          is_causal=causal))
        rows.append({
            "shape": name, "max_abs_err": err, "lse_err": lse_err,
            **times(kernel,
                    lambda: flash_attention_reference(q, k, v, causal),
                    library),
            **bound(nbytes, {dt: flops})})
    return rows


# the stochastic quantizer: fp32 gradients of GPT-2 125M's shapes (an MLP
# weight's, the embedding's), a ragged one, all zeros (scale 1, codes 0)
# and one holding a NaN (scale NaN, codes 0, as max|x| gives), each at two
# seeds
QUANT_SHAPES = (((3072, 768), "randn"), ((50257, 768), "randn"),
                ((1000, 3), "randn"), ((3072, 768), "zeros"),
                ((1000, 3), "nan"))
# QUANT_SHAPES' row reported in the kernel line: the embedding's gradient
QUANT_ROW = 1
# absmax values of the division's stress inputs: scales (absmax / 127) in
# the fast range, a subnormal scale, and scales above 2^100 (IEEE division
# for the whole call)
QUANT_EDGE_ABSMAX = (1.0, 127.0, 3.7e-30, 2.5e20, 6.1e-8, 1e-37, 2.0 ** 110)


def quantize_edge_inputs(gen):
    """(name, x) of the inputs that stress the kernel's division and its
    ragged, unaligned and tiny cases: for each QUANT_EDGE_ABSMAX, x = k
    scale (1 + d) for k in -127..127 and d in {0, +-2^-24, +-2^-23}, their
    float32 neighbours and the absmax itself; subnormal x beside a normal
    absmax, and all subnormal; a +inf and a -inf element; one element;
    n = 16 m + 7; a view one element past a 16-byte boundary."""
    import torch

    out = []
    k = torch.arange(-127, 128, dtype=torch.float64, device="cuda")
    d = torch.tensor([0.0, 2.0 ** -24, -2.0 ** -24, 2.0 ** -23, -2.0 ** -23],
                     dtype=torch.float64, device="cuda")
    for a in QUANT_EDGE_ABSMAX:
        scale = torch.tensor(a, dtype=torch.float32, device="cuda") / \
            torch.tensor(127.0, device="cuda")
        x = (k[:, None] * scale.double() * (1 + d)).reshape(-1).float()
        x = torch.cat([x, torch.nextafter(x, torch.full_like(x, float("inf"))),
                       torch.nextafter(x, torch.full_like(x, -float("inf")))])
        x = x.clamp(-a, a)
        x = torch.cat([torch.tensor([a, -a], device="cuda"), x])
        out.append((f"k scale (1 + d), absmax {a:g}", x))
    tiny = torch.randn(4099, generator=gen, device="cuda") * 1e-39
    out.append(("subnormal x, absmax 1", torch.cat(
        [torch.ones(1, device="cuda"), tiny])))
    out.append(("all subnormal", tiny))
    for sign in (1, -1):
        x = torch.randn(20007, generator=gen, device="cuda")
        x[777] = sign * float("inf")
        out.append((f"{'+' if sign > 0 else '-'}inf element", x))
    out.append(("one element", torch.randn(1, generator=gen, device="cuda")))
    out.append(("n = 16 * 6250 + 7",
                torch.randn(16 * 6250 + 7, generator=gen, device="cuda")))
    base = torch.randn(300001, generator=gen, device="cuda")
    out.append(("view at offset 1 (unaligned)", base[1:]))
    return out


def check_stochastic_quantize(gen, seed):
    """The quantizer kernel against its plain version, bit for bit (codes
    and scale; a NaN scale on both sides for the NaN input), at
    QUANT_SHAPES and two seeds; the two seeds' codes differ; every code is
    floor(x / scale) or one above it (inside the clip); the share rounded
    up is within 5 sigma of the mean of frac(x / scale). No PyTorch call
    computes this function: library_ms is null. The bound is 4 B read and
    1 B written an element."""
    import torch

    from deepspeed_tpu_torch.ops import quantizer as qz

    seeds = (2 * seed + 101, 2 * seed + 102)
    rows = []
    for shape, kind in QUANT_SHAPES:
        if kind == "zeros":
            x = torch.zeros(shape, device="cuda")
        else:
            x = torch.randn(shape, generator=gen, device="cuda")
        if kind == "nan":  # one NaN, inside the kernel's 16-element groups
            x.view(-1)[1234] = float("nan")
        name = f"{list(shape)}{'' if kind == 'randn' else ' ' + kind} fp32"
        codes, shares, err = [], [], 0.0
        for s in seeds:
            q, scale = qz.stochastic_quantize(x, s)
            rq, rscale = qz.stochastic_quantize_reference(x, s)
            torch.cuda.synchronize()
            code_err = (q.int() - rq.int()).abs().max().item()
            if kind == "nan":
                scale_ok = scale.isnan().item() and rscale.isnan().item()
                scale_err = 0.0 if scale_ok else float("inf")
            else:
                scale_ok = (scale.view(torch.int32).item() ==
                            rscale.view(torch.int32).item())
                scale_err = (scale - rscale).abs().item()
            err = max(err, code_err, scale_err)
            if code_err or not scale_ok:
                raise AssertionError(
                    f"stochastic_quantize {name} seed {s}: kernel differs "
                    f"from the plain version ({int((q != rq).sum())} codes, "
                    f"scale {scale.item()} vs {rscale.item()})")
            if kind == "nan":
                if q.any():
                    raise AssertionError(f"stochastic_quantize {name}: "
                                         f"scale {scale.item()}, codes not 0")
                continue
            ratio = x / scale
            lo = torch.floor(ratio)
            if not ((q == lo.clamp(-128, 127)) |
                    (q == (lo + 1).clamp(-128, 127))).all():
                raise AssertionError(f"stochastic_quantize {name}: a code "
                                     f"is not floor(x / scale) or one above")
            if kind == "zeros":
                if scale.item() != 1.0 or q.any():
                    raise AssertionError(f"stochastic_quantize {name}: "
                                         f"scale {scale.item()}, codes not 0")
                continue
            frac = (ratio - lo).double()
            up = (q.double() == lo.double() + 1).double().mean().item()
            want = frac.mean().item()
            sigma = (frac * (1 - frac)).sum().sqrt().item() / x.numel()
            if abs(up - want) > 5 * sigma:
                raise AssertionError(
                    f"stochastic_quantize {name} seed {s}: {up} of the "
                    f"codes rounded up, expected {want} (5 sigma = "
                    f"{5 * sigma})")
            shares.append((round(up, 6), round(want, 6)))
            codes.append(q)
        if len(codes) == 2 and torch.equal(codes[0], codes[1]):
            raise AssertionError(f"stochastic_quantize {name}: seeds {seeds}"
                                 f" gave the same codes")

        def kernel():
            return qz.stochastic_quantize(x, seeds[0])

        def passes(p):
            return lambda: qz.launch_passes(x, q, scale, seeds[0], p)

        rows.append({
            "shape": name, "max_abs_err": err, "seeds": list(seeds),
            "rounded_up_vs_expected": shares,
            # pass 1 alone (absmax, scale), pass 2 alone (codes, every
            # tile read from L2 or device memory)
            "pass1_ms": device_ms(passes(1)), "pass2_ms": device_ms(passes(2)),
            # the plain version launches ~130 elementwise kernels a call:
            # 4 calls keep the host's queue of launches from filling while
            # the device spins
            "ms": device_ms(kernel), "wrapper_ms": wrapper_ms(kernel),
            "plain_ms": device_ms(
                lambda: qz.stochastic_quantize_reference(x, seeds[0]), 4),
            "library_ms": None, **bound(5 * x.numel(), {})})
        del x, codes
        torch.cuda.empty_cache()
    for name, x in quantize_edge_inputs(gen):
        for s in seeds:
            before = qz.stochastic_quantize.launches
            q, scale = qz.stochastic_quantize(x, s)
            launched = qz.stochastic_quantize.launches - before
            if launched != 1:
                raise AssertionError(f"stochastic_quantize {name}: "
                                     f"{launched} launches in one call, "
                                     f"not 1")
            rq, rscale = qz.stochastic_quantize_reference(x, s)
            torch.cuda.synchronize()
            same_scale = (
                (scale.isnan().item() and rscale.isnan().item()) or
                scale.view(torch.int32).item() ==
                rscale.view(torch.int32).item())
            if not (torch.equal(q, rq) and same_scale):
                raise AssertionError(
                    f"stochastic_quantize {name} seed {s}: kernel differs "
                    f"from the plain version ({int((q != rq).sum())} of "
                    f"{q.numel()} codes, scale {scale.item()} vs "
                    f"{rscale.item()})")
    before = qz.stochastic_quantize.launches
    q, scale = qz.stochastic_quantize(torch.empty(0, device="cuda"), 5)
    if qz.stochastic_quantize.launches != before or scale.item() != 1.0:
        raise AssertionError("stochastic_quantize: an empty tensor launched "
                             "the kernel or gave a scale other than 1")
    log(f"stochastic_quantize: {len(QUANT_EDGE_ABSMAX) + 7} edge inputs at "
        f"two seeds bit for bit, one launch a call; empty: no launch")
    return rows


def check_flash_bwd(dtype, gen):
    """The dQ and dK/dV kernels against their plain versions on the same
    inputs (the forward kernel's O and lse). ``[B, T, H, D]`` cases run
    through :func:`flash_attention_bthd` with autograd, checked to launch
    each kernel once. Returns (dq rows, dkv rows); only the training
    shape is timed (SDPA's backward, dQ/dK/dV together, as the library
    yardstick of both)."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa

    dt = str(dtype)[6:]
    dq_rows, dkv_rows = [], []
    for B, H, Tq, Tk, D, layout, causal in BWD_SHAPES:
        name = shape_name(B, H, Tq, Tk, D, layout, causal)
        q = rand_heads(B, H, Tq, D, layout, dtype, gen)
        k, v = (rand_heads(B, H, Tk, D, layout, dtype, gen)
                for _ in range(2))
        do = rand_heads(B, H, Tq, D, layout, dtype, gen)
        if layout == "bthd":  # the whole autograd path through the entry
            leaves = [t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v)]
            before = launch_counts()
            o = fa.flash_attention_bthd(*leaves, causal=causal)
            o.backward(do.transpose(1, 2))
            got = [t.grad.transpose(1, 2) for t in leaves]
            o = o.detach().transpose(1, 2)
            after = launch_counts()
            for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                if after[kname] - before[kname] != 1:
                    raise AssertionError(f"flash_attention_bthd {name}: "
                                         f"{kname} launched "
                                         f"{after[kname] - before[kname]} "
                                         f"times, not once")
            lse = fa.flash_attention(q, k, v, causal=causal)[1]
        else:
            o, lse = fa.flash_attention(q, k, v, causal=causal)
        delta = fa.attention_delta(do, o)
        if layout == "bhtd":
            got = [fa.flash_attention_backward(q, k, v, do, lse, delta,
                                               causal),
                   *fa.flash_attention_backward_dkv(q, k, v, do, lse, delta,
                                                    causal)]
        args = (q, k, v, do, lse, delta, causal)
        want = [fa.flash_attention_backward_dq_reference(*args),
                *fa.flash_attention_backward_dkv_reference(*args)]
        torch.cuda.synchronize()
        errs = [compare(f"flash bwd {n} {name} {dtype}", g, w, dt)
                for n, g, w in zip(("dq", "dk", "dv"), got, want)]
        n_pairs = B * H * pairs(Tq, Tk, causal)
        esize = q.element_size()
        io = B * H * D * esize
        stats = B * H * Tq * 4 * 2  # lse and delta
        dq_row = {"shape": name, "max_abs_err": errs[0],
                  **bound(io * (3 * Tq + 2 * Tk) + stats,
                          {dt: 6 * D * n_pairs})}
        dkv_row = {"shape": name, "max_abs_err": max(errs[1:]),
                   **bound(io * (2 * Tq + 4 * Tk) + stats,
                           {dt: 8 * D * n_pairs})}
        if (B, H, Tq) in TIMED_FLASH:  # a training path's shape
            lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
            lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)

            def library():
                return torch.autograd.grad(lo, (lq, lk, lv), do,
                                           retain_graph=True)

            dq_row.update(times(
                lambda: fa.flash_attention_backward(*args),
                lambda: fa.flash_attention_backward_dq_reference(*args),
                library))
            dkv_row.update(times(
                lambda: fa.flash_attention_backward_dkv(*args),
                lambda: fa.flash_attention_backward_dkv_reference(*args),
                library))
            # like with like: SDPA's backward computes dQ, dK and dV at once
            log(f"flash backward {name} {dtype}: dq + dkv "
                f"{dq_row['ms'] + dkv_row['ms']:.4f} ms, SDPA backward "
                f"{dkv_row['library_ms']:.4f} ms")
            del lo
        dq_rows.append(dq_row)
        dkv_rows.append(dkv_row)
    return dq_rows, dkv_rows


# the block-sparse checks: (B, H, S, sparse_attention section) — the BERT
# slice's fixed per-head layout (block 128), bench_sparse.py:47-68's
# BigBird layout (1 random, 3 window, 1 global block; one layout for every
# head, block 256), a fixed layout of block 32, which keeps the bf16
# backward on the CUDA-core kernels (the tensor-core ones take blocks that
# are a multiple of 64), and a per-head BigBird layout of block 64, whose
# rows and columns have uneven walks, on the tensor-core kernels' one
# warpgroup instances (64 rows a CTA; 128 at blocks of 128 and 256)
SPARSE_CASES = (
    (2, 16, 4096, "BERT_SPARSE"),
    (1, 12, 8192, {"mode": "bigbird", "block": 256, "num_random_blocks": 1,
                   "num_sliding_window_blocks": 3, "num_global_blocks": 1}),
    (1, 4, 1024, {"mode": "fixed", "block": 32, "num_local_blocks": 4,
                  "num_global_blocks": 1}),
    (2, 4, 1024, {"mode": "bigbird", "block": 64, "num_random_blocks": 2,
                  "num_sliding_window_blocks": 3, "num_global_blocks": 1,
                  "different_layout_per_head": True}),
)


def sparse_layout(section, heads, seq):
    """The numpy bool layout of a ``sparse_attention`` section, as BERT's
    shared SparseSelfAttention draws it (bidirectional)."""
    from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
        sparsity_config_from_dict)
    from deepspeed_tpu_torch.tools.profile_training import BERT_SPARSE

    section = dict(BERT_SPARSE if section == "BERT_SPARSE" else section)
    section.setdefault("attention", "bidirectional")
    return sparsity_config_from_dict(section, heads).make_layout(seq) \
        .astype(bool)


def check_block_sparse(dtype, gen):
    """The three block-sparse kernels against their plain versions on the
    same inputs (the forward kernel's O and lse feed the backward ones), on
    ``[B, H, S, D]`` views of ``[B, S, H, D]`` tensors as BERT hands them
    over; then the autograd path, checked to launch each kernel once,
    through the source the wrapper's rule names (``tensor_cores``: the
    ``_sm90`` sources for bf16 at a block that is a multiple of 64), and
    to give the plain versions' gradients. Times kernel, plain version and
    the library yardstick (SDPA with the layout expanded to a boolean
    ``[1, H, S, S]`` mask: its forward for the forward row, its backward
    for the backward rows, and forward + backward beside them). Returns
    (fwd rows, dq rows, dkv rows)."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bs

    D, dt = 64, str(dtype)[6:]
    fwd_rows, dq_rows, dkv_rows = [], [], []
    for B, H, S, section in SPARSE_CASES:
        layout = sparse_layout(section, H, S)
        block = S // layout.shape[1]
        name = (f"B={B} H={H} S={S} D={D} block={block} "
                f"{'per-head' if (layout != layout[:1]).any() else 'shared'}"
                f" layout density={layout.mean():.4f}")
        q, k, v, do = (rand_heads(B, H, S, D, "bthd", dtype, gen)
                       for _ in range(4))
        o, lse = bs.block_sparse_attention_with_lse(q, k, v, layout)
        ro, rlse = bs.block_sparse_attention_reference(q, k, v, layout)
        torch.cuda.synchronize()
        err = compare(f"block-sparse fwd {name} {dtype}", o, ro, dt)
        lse_err = (lse - rlse).abs().max().item()
        if lse_err > 1e-3:
            raise AssertionError(f"block-sparse {name} lse error {lse_err}")
        delta = fa.attention_delta(do, o)
        args = (q, k, v, do, lse, delta, layout)
        got = [bs.block_sparse_backward_dq(*args),
               *bs.block_sparse_backward_dkv(*args)]
        want = [bs.block_sparse_backward_dq_reference(*args),
                *bs.block_sparse_backward_dkv_reference(*args)]
        torch.cuda.synchronize()
        errs = [compare(f"block-sparse bwd {n} {name} {dtype}", g, w, dt)
                for n, g, w in zip(("dq", "dk", "dv"), got, want)]

        # the autograd path: one launch of each kernel, from the source
        # the routing rule names, and the same gradients
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sources, launch = [], bs._launch

        def spy(source, *call, **kw):
            sources.append(source)
            return launch(source, *call, **kw)

        before = launch_counts()
        with mock.patch.object(bs, "_launch", spy):
            bs.block_sparse_attention(*leaves, layout).backward(do)
        after = launch_counts()
        for kname in ("block_sparse_fwd", "block_sparse_bwd_dq",
                      "block_sparse_bwd_dkv"):
            if after[kname] - before[kname] != 1:
                raise AssertionError(f"block_sparse_attention {name}: "
                                     f"{kname} launched "
                                     f"{after[kname] - before[kname]} times")
        suffix = "_sm90" if bs.tensor_cores(dtype, block) else ""
        want_sources = [f"block_sparse_fwd{suffix}",
                        f"block_sparse_bwd_dq{suffix}",
                        f"block_sparse_bwd_dkv{suffix}"]
        if sources != want_sources:
            raise AssertionError(f"block_sparse_attention {name} {dtype}: "
                                 f"launched {sources}, the rule names "
                                 f"{want_sources}")
        for n, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
            compare(f"block-sparse autograd {n} {name} {dtype}", leaf.grad,
                    w, dt)

        # bounds: each input read once, each output written once, and 4 /
        # 6 / 8 D operations a visible pair; the lists are int32
        n_pairs = B * int(layout.sum()) * block * block
        io = B * H * S * D * q.element_size()
        stats = B * H * S * 4
        lists = bs.block_lists(layout, q.device)
        # the plain versions are timed on the cached device layout (a
        # numpy one is uploaded by a blocking copy on every call)
        plain_args = (*args[:-1], lists.layout)
        csr = 4 * (lists.row_ptr.numel() + lists.col_idx.numel())
        csc = 4 * (lists.col_ptr.numel() + lists.row_idx.numel())
        # the tensor-core kernels also read their schedule (the forward
        # dQ's)
        order_dq, order_dkv = ((4 * lists.dq_order.numel(),
                                4 * lists.dkv_order.numel())
                               if suffix else (0, 0))
        mask = bs._token_mask(layout, S, S, q.device)[None]
        lq, lk, lv = leaves
        lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)

        def lib_fwd():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        def lib_bwd():
            return torch.autograd.grad(lo, leaves, do, retain_graph=True)

        def lib_fwd_bwd():
            return torch.autograd.grad(F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=mask), leaves, do)

        fwd_bwd_ms = device_ms(lib_fwd_bwd, REPEATS)
        fwd_rows.append({
            "shape": name, "source": want_sources[0], "max_abs_err": err,
            **times(lambda: bs.block_sparse_attention_with_lse(q, k, v,
                                                               layout),
                    lambda: bs.block_sparse_attention_reference(
                        q, k, v, lists.layout),
                    lib_fwd),
            "library_fwd_bwd_ms": fwd_bwd_ms,
            **bound(4 * io + stats + csr + order_dq,
                    {dt: 4 * D * n_pairs})})
        dq_rows.append({
            "shape": name, "source": want_sources[1], "max_abs_err": errs[0],
            **times(lambda: bs.block_sparse_backward_dq(*args),
                    lambda: bs.block_sparse_backward_dq_reference(
                        *plain_args),
                    lib_bwd),
            "library_fwd_bwd_ms": fwd_bwd_ms,
            **bound(5 * io + 2 * stats + csr + order_dq,
                    {dt: 6 * D * n_pairs})})
        dkv_rows.append({
            "shape": name, "source": want_sources[2],
            "max_abs_err": max(errs[1:]),
            **times(lambda: bs.block_sparse_backward_dkv(*args),
                    lambda: bs.block_sparse_backward_dkv_reference(
                        *plain_args),
                    lib_bwd),
            "library_fwd_bwd_ms": fwd_bwd_ms,
            **bound(6 * io + 2 * stats + csc + order_dkv,
                    {dt: 8 * D * n_pairs})})
        # like with like: SDPA's backward computes dQ, dK and dV at once
        log(f"block-sparse backward {name} {dtype}: dq + dkv "
            f"{dq_rows[-1]['ms'] + dkv_rows[-1]['ms']:.4f} ms "
            f"({want_sources[1]}, {want_sources[2]}), SDPA backward "
            f"{dkv_rows[-1]['library_ms']:.4f} ms")
        del lo, mask
        torch.cuda.empty_cache()
    return fwd_rows, dq_rows, dkv_rows


# the append checks: (B, H, D, S, idx, T_q). The first four as before
# (row 2 is the timed shape); then T_q = 5 on a full cache (idx + T_q =
# S; its two row groups see 1023 and 1024 keys), B = 1, D = 128, keys
# that end on a split boundary (512 keys: two splits of exactly
# MIN_SPLIT_KEYS = 256), keys that end inside the first split (47
# keys: one split, which writes O itself), and generate()'s own first and
# last steps (a 128-token prompt, 32 new tokens: idx 128 and 159)
APPEND_CASES = ((2, 12, 64, 1024, 0, 1), (2, 12, 64, 1024, 255, 1),
                (2, 12, 64, 1024, 1000, 1), (2, 12, 64, 1024, 255, 3),
                (2, 12, 64, 1024, 1019, 5), (1, 12, 64, 1024, 1000, 1),
                (2, 12, 128, 1024, 1000, 1), (2, 12, 64, 1024, 511, 1),
                (2, 12, 64, 1024, 46, 1), (2, 12, 64, 1024, 128, 1),
                (2, 12, 64, 1024, 159, 1))


# the append kernel with a per-row first key (left-padded generate()):
# (B, H, D, S, idx, T_q, pads). idx 1000 with pads 0 / 37 / 500 / 1000,
# so the last row sees its last key alone (T_q = 1) or its 4 query rows 1-4
# keys (T_q = 4); then the padded-generate phase's first decode step (4
# prompts of 128 / 100 / 37 / 1 tokens left-padded to 128)
APPEND_PAD_CASES = ((4, 12, 64, 1024, 1000, 1, (0, 37, 500, 1000)),
                    (4, 12, 64, 1024, 1000, 4, (0, 37, 500, 1000)),
                    (4, 12, 64, 1024, 128, 1, (0, 28, 91, 127)))


def check_append(dtype, gen, padded=False):
    """The append kernel against its plain version at APPEND_CASES, or
    (``padded``) with each row's first key from ``pad`` at
    APPEND_PAD_CASES: the rows past ``idx + T_q`` and a row's pad rows
    ``[0, pad_b)`` hold 1e4 (K) and NaN (V), which it must not read; a
    second call on the same inputs must give the same bits (the partials
    merge in split order), and a padded call counts one launch with a
    first key. The bound counts the keys each row sees, ``[pad_b, idx +
    T_q)``. Each row logs the grid's split count and the least keys a
    split takes."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import decode_attention as da

    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case in APPEND_PAD_CASES if padded else APPEND_CASES:
        B, H, D, S, idx, tq = case[:6]
        pads = case[6] if padded else (0,) * B
        splits = da.decode_splits(B, H, tq, S, sms, da.MIN_SPLIT_KEYS)
        kc, vc = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                  .to(dtype) for _ in range(2))
        # rows outside the valid keys hold garbage the kernel must not read
        kc[:, idx + tq:] = 1e4
        vc[:, idx + tq:] = float("nan")
        for b, p in enumerate(pads):
            kc[b, :p] = 1e4
            vc[b, :p] = float("nan")
        q = torch.randn((B, tq, H, D), generator=gen, device="cuda").to(dtype)
        index = torch.tensor(idx, dtype=torch.int32, device="cuda")
        pad = (torch.tensor(pads, dtype=torch.int32, device="cuda")
               if padded else None)
        before = da.decode_attention.padded_launches
        got = da.decode_attention(q, kc, vc, index, pad=pad)
        again = da.decode_attention(q, kc, vc, index, pad=pad)
        if da.decode_attention.padded_launches - before != 2 * padded:
            raise AssertionError("the append kernel miscounted its launches "
                                 "with a first key")
        want = da.decode_attention_reference(q, kc, vc, index, pad=pad)
        torch.cuda.synchronize()
        shape = (f"B={B} H={H} D={D} S={S} idx={idx} T_q={tq}"
                 + (f" pads={list(pads)}" if padded else ""))
        err = compare(f"append {shape} {dtype}", got, want, str(dtype)[6:])
        if not torch.equal(got, again):
            raise AssertionError(f"append {shape} {dtype}: two calls on the "
                                 f"same inputs differ")
        keys = [min(idx + tq, S) - p for p in pads]
        esize = q.element_size()
        nbytes = (2 * sum(keys) * H * D * esize + 2 * q.numel() * esize + 4
                  + 4 * B * padded)
        flops = 4 * D * H * sum(idx + r + 1 - p for p in pads
                                for r in range(tq))
        pos = torch.arange(S, device="cuda")
        mask = pos[None, :] <= idx + torch.arange(tq, device="cuda")[:, None]
        if padded:
            mask = (mask[None] & (pos[None, None, :]
                                  >= pad[:, None, None]))[:, None]
        rows.append({
            "shape": shape, "max_abs_err": err, "splits": splits,
            **times(lambda: da.decode_attention(q, kc, vc, index, pad=pad),
                    lambda: da.decode_attention_reference(q, kc, vc, index,
                                                          pad=pad),
                    lambda: F.scaled_dot_product_attention(
                        q.transpose(1, 2), kc.transpose(1, 2),
                        vc.transpose(1, 2), attn_mask=mask)),
            **bound(nbytes, {str(dtype)[6:]: flops})})
        log(f"append {shape} {dtype}: a grid of {splits} splits "
            f"({B * H * -(-tq // da.DEC_ROWS) * splits} CTAs) of at least "
            f"{da.MIN_SPLIT_KEYS} keys, the rows' last groups see {keys} "
            f"keys, bitwise equal on a second call, max |kernel - plain| "
            f"{err}")
    return rows


def _paged_tables(lengths, tq, bs, mb, nb, rng):
    """Per-row permuted block tables covering each row's ``length +
    T_q`` positions; unallocated entries name the garbage block."""
    import torch

    from deepspeed_tpu_torch.ops.decode_attention import GARBAGE_BLOCK

    tables = np.full((len(lengths), mb), GARBAGE_BLOCK, np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    for b, ln in enumerate(lengths):
        need = -(-(ln + tq) // bs)
        tables[b, :need] = [free.pop() for _ in range(need)]
    return (torch.tensor(tables, device="cuda"),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def check_paged(dtype, gen, rng, int8=False):
    """The paged kernel against its plain version at PAGED_CASES: over
    pools of q's dtype, or (``int8``) over int8 pools with fp32 scales
    quantized row-wise from random K/V, the garbage block filled with
    values that must never reach the output. Each row names the kernel
    source that ran (from the wrapper's launch counts by source) and the
    split count of the grid it launched (None on the tensor cores). The
    split decode's P.V over int8 pools is fp32 whatever q's dtype (p
    stays fp32), and so is its bound's; the tensor-core source's is
    bf16."""
    import torch

    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops.quantizer import quantize_rowwise

    kernel, plain = ((da.decode_attention_paged_int8,
                      da.decode_attention_paged_int8_reference) if int8 else
                     (da.decode_attention_paged,
                      da.decode_attention_paged_reference))
    bs, mb, H, D = 16, 64, 12, 64
    dt, name = str(dtype)[6:], "paged int8" if int8 else "paged"
    rows = []
    for lengths, tq in PAGED_CASES:
        nb = 1 + max(4, len(lengths)) * mb
        k, v = (torch.randn((nb, bs, H, D), generator=gen, device="cuda")
                for _ in range(2))
        if int8:
            (kp, ks), (vp, vs) = quantize_rowwise(k), quantize_rowwise(v)
            kp[da.GARBAGE_BLOCK] = 127   # the garbage sink never contributes
            ks[da.GARBAGE_BLOCK] = vs[da.GARBAGE_BLOCK] = float("nan")
            pools, key_bytes = (kp, vp, ks, vs), H * (2 * D + 2 * 4)
        else:
            kp, vp = k.to(dtype), v.to(dtype)
            kp[da.GARBAGE_BLOCK] = 1e4   # the garbage sink never contributes
            vp[da.GARBAGE_BLOCK] = float("nan")
            pools, key_bytes = (kp, vp), 2 * H * D * kp.element_size()
        tables, lens = _paged_tables(lengths, tq, bs, mb, nb, rng)
        q = torch.randn((len(lengths), tq, H, D), generator=gen,
                        device="cuda").to(dtype)
        args = (q, *pools, tables, lens)
        before = dict(kernel.source_launches)
        got = kernel(*args)
        ran = [src for src, n in kernel.source_launches.items()
               if n != before.get(src, 0)]
        splits = kernel.last_splits
        want = plain(*args)
        torch.cuda.synchronize()
        shape = (f"slots={len(lengths)} bs={bs} MB={mb} lengths={lengths} "
                 f"T_q={tq}")
        err = compare(f"{name} {shape} {dtype}", got, want, dt)
        if len(ran) != 1:
            raise AssertionError(f"{name} {shape} {dtype}: sources {ran} "
                                 f"launched by one call")
        keys = sum(min(ln + tq, mb * bs) for ln in lengths)
        nbytes = (keys * key_bytes + 2 * q.numel() * q.element_size()
                  + tables.numel() * 4 + len(lengths) * 4)
        # q.K and P.V: 2 D operations a visible (query, key) pair each
        half = 2 * D * H * sum(ln + r + 1 for ln in lengths
                               for r in range(tq))
        flops = {dt: half}
        pv_dt = "float32" if ran[0] == "decode_paged_int8" else dt
        flops[pv_dt] = flops.get(pv_dt, 0) + half
        rows.append({
            "shape": shape, "source": ran[0], "splits": splits,
            "max_abs_err": err,
            **times(lambda: kernel(*args), lambda: plain(*args)),
            **bound(nbytes, flops)})
        log(f"{name} {shape} {dtype}: {ran[0]}, "
            + (f"a grid of {splits} splits" if splits else "64-row tiles")
            + f", max |kernel - plain| {err}")
    return rows


def phase_kernels(seed):
    """Every kernel against its plain version, bf16 and fp32 (the
    quantizer fp32 only). Returns {kernel: rows} for bf16 (the serving
    dtype) and the quantizer."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dq_rows, dkv_rows = check_flash_bwd(dtype, gen)
        sp_fwd, sp_dq, sp_dkv = check_block_sparse(dtype, gen)
        res = {"flash_fwd": check_flash(dtype, gen),
               "flash_bwd_dq": dq_rows, "flash_bwd_dkv": dkv_rows,
               "decode_append": check_append(dtype, gen),
               "decode_append_padded": check_append(dtype, gen,
                                                    padded=True),
               "decode_paged": check_paged(dtype, gen, rng),
               "decode_paged_int8": check_paged(dtype, gen, rng, int8=True),
               "block_sparse_fwd": sp_fwd, "block_sparse_bwd_dq": sp_dq,
               "block_sparse_bwd_dkv": sp_dkv}
        for name, rows in res.items():
            for row in rows:
                log(f"kernel {name} {dtype} {json.dumps(row)}")
        if dtype == torch.bfloat16:
            out = res
    out["stochastic_quantize"] = check_stochastic_quantize(gen, seed)
    for row in out["stochastic_quantize"]:
        log(f"kernel stochastic_quantize torch.float32 {json.dumps(row)}")
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def plain_versions():
    """The same engines with every kernel wrapper swapped for its plain
    PyTorch version, on the card (the comparison run)."""
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bs

    def sparse_fwd(q, k, v, layout, row_ptr, col_idx, order, scale):
        return bs.block_sparse_attention_reference(q, k, v, layout, scale)

    def sparse_dq(q, k, v, do, lse, delta, lists, scale):
        return bs.block_sparse_backward_dq_reference(q, k, v, do, lse, delta,
                                                     lists.layout, scale)

    def sparse_dkv(q, k, v, do, lse, delta, lists, scale):
        return bs.block_sparse_backward_dkv_reference(q, k, v, do, lse,
                                                      delta, lists.layout,
                                                      scale)

    with mock.patch.object(bs, "_fwd_launch", sparse_fwd), \
            mock.patch.object(bs, "_dq_launch", sparse_dq), \
            mock.patch.object(bs, "_dkv_launch", sparse_dkv), \
            mock.patch.object(fa, "_fwd_launch", fa.flash_attention_reference), \
            mock.patch.object(fa, "_dq_launch",
                              fa.flash_attention_backward_dq_reference), \
            mock.patch.object(fa, "_dkv_launch",
                              fa.flash_attention_backward_dkv_reference), \
            mock.patch("deepspeed_tpu_torch.models.gpt2.decode_attention",
                       da.decode_attention_reference), \
            mock.patch("deepspeed_tpu_torch.models.gpt2."
                       "decode_attention_paged",
                       da.decode_attention_paged_reference), \
            mock.patch("deepspeed_tpu_torch.models.gpt2."
                       "decode_attention_paged_int8",
                       da.decode_attention_paged_int8_reference):
        yield


def kernel_wrappers():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_paged, decode_attention_paged_int8)
    from deepspeed_tpu_torch.ops.quantizer import stochastic_quantize
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bs

    return {"flash_fwd": fa.flash_attention,
            "flash_bwd_dq": fa.flash_attention_backward,
            "flash_bwd_dkv": fa.flash_attention_backward_dkv,
            "decode_append": decode_attention,
            "decode_paged": decode_attention_paged,
            "decode_paged_int8": decode_attention_paged_int8,
            "block_sparse_fwd": bs.block_sparse_attention,
            "block_sparse_bwd_dq": bs.block_sparse_backward_dq,
            "block_sparse_bwd_dkv": bs.block_sparse_backward_dkv,
            "stochastic_quantize": stochastic_quantize}


def launch_counts():
    """Each kernel's launches, and the append kernel's launches with a
    per-row first key (``decode_append_padded``)."""
    from deepspeed_tpu_torch.ops.decode_attention import decode_attention

    counts = {name: fn.launches for name, fn in kernel_wrappers().items()}
    counts["decode_append_padded"] = decode_attention.padded_launches
    return counts


def reset_launch_counts():
    from deepspeed_tpu_torch.ops.decode_attention import decode_attention

    for fn in kernel_wrappers().values():
        fn.launches = 0
    decode_attention.padded_launches = 0


def submit_all(prompts, max_new):
    """The serving workload's order: every prompt at once, then drain."""
    def run(srv):
        reqs = [srv.submit(p, max_new_tokens=max_new, request_id=f"r{i}")
                for i, p in enumerate(prompts)]
        srv.drain()
        return reqs

    return run


def serve(srv, run):
    """Serve through the fresh ServingEngine ``srv`` (``run(srv)`` submits
    and drains, returning the requests), recording the logits of every
    prefill (the whole-prompt call, or the final chunk) and of each
    request's first decode step. Returns (requests, seconds, stats,
    prefill_logits {rid: row}, first_decode_logits {rid: rows}): a decode
    step's one row, or a verify step's k + 1 rows."""
    import torch

    prefill_logits, first_decode = {}, {}
    current = {"rid": None}
    sample, prefill, chunk = srv._sample, srv._prefill, srv._chunk_call

    def record(logits):
        rows = logits.float().cpu()
        if current["rid"] is not None:
            prefill_logits[current["rid"]] = rows[0]
        else:
            rows = rows.reshape(srv.config.decode_slots, -1, rows.shape[-1])
            for slot, req in srv.sched.running():
                if slot not in srv._prefilling:
                    first_decode.setdefault(req.request_id, rows[slot])
        return sample(logits)

    def tracked(fn):
        def call(*args):
            req = next(a for a in args if hasattr(a, "request_id"))
            current["rid"] = req.request_id
            try:
                return fn(*args)
            finally:
                current["rid"] = None
        return call

    srv._sample = record
    srv._prefill, srv._chunk_call = tracked(prefill), tracked(chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = run(srv)
    torch.cuda.synchronize()
    return (reqs, time.perf_counter() - t0, srv.stats(), prefill_logits,
            first_decode)


def against_plain(what, reqs, pf, fd, ref_reqs, ref_pf, ref_fd):
    """Hold a kernel-path run against the plain-version run of the same
    stream: prefill logits within LOGITS_ATOL; first-decode logits too
    where the first tokens agree, else the two first tokens must be a
    near tie in the plain run's own prefill logits. Returns (first tokens
    agreeing, all tokens agreeing, max prefill and first-decode error)."""
    agree = sum(a == b for r, q in zip(reqs, ref_reqs)
                for a, b in zip(r.tokens, q.tokens))
    first_agree = 0
    pf_err = fd_err = 0.0
    for r, q in zip(reqs, ref_reqs):
        rid = r.request_id
        pf_err = max(pf_err, check_logits(f"{what} {rid} prefill", pf[rid],
                                          ref_pf[rid]))
        if r.tokens[0] == q.tokens[0]:
            first_agree += 1
            fd_err = max(fd_err, check_logits(f"{what} {rid} first decode",
                                              fd[rid], ref_fd[rid]))
        else:  # a near tie: the plain run's own logits of the two tokens
            z = ref_pf[rid]
            gap = abs(float(z[r.tokens[0]] - z[q.tokens[0]]))
            if gap > LOGITS_ATOL:
                raise AssertionError(f"{what} {rid}: first tokens differ "
                                     f"({r.tokens[0]} vs {q.tokens[0]}) "
                                     f"with logit gap {gap}")
    return first_agree, agree, pf_err, fd_err


def check_logits(what, got, want):
    err = (got - want).abs().max().item()
    if not np.isfinite(err) or err > LOGITS_ATOL:
        raise AssertionError(f"{what}: max |kernel - plain| logits {err} "
                             f"beyond {LOGITS_ATOL}")
    return err


def generate_ids(engine, seed):
    import torch

    rng = np.random.default_rng(seed + 1)
    return torch.tensor(rng.integers(1, engine.model_config.vocab_size,
                                     (2, 128)), device=engine.device)


def warm_up(model, seed):
    """The timed runs below measure a warm process: cuBLAS handles, the
    caching allocator and the kernel libraries are set up here."""
    import torch

    from deepspeed_tpu_torch import init_inference, init_serving
    from deepspeed_tpu_torch.tools.profile_serving import (
        MAX_NEW_TOKENS, SERVING, serving_prompts)

    srv = init_serving(model, serving=SERVING)
    for p in serving_prompts(model.config.vocab_size, seed):
        srv.submit(p, max_new_tokens=MAX_NEW_TOKENS)
    srv.drain()
    engine = init_inference(model)
    engine.generate(generate_ids(engine, seed), max_new_tokens=MAX_NEW_TOKENS)
    torch.cuda.synchronize()


def phase_serving(model, seed, card):
    """The serving path; returns its launch counts."""
    import torch

    from deepspeed_tpu_torch import init_serving
    from deepspeed_tpu_torch.tools.profile_serving import (
        MAX_NEW_TOKENS, SERVING, serving_prompts)

    max_new = MAX_NEW_TOKENS
    prompts = serving_prompts(model.config.vocab_size, seed)
    lens = [len(p) for p in prompts]
    srv = init_serving(model, serving=SERVING)
    reset_launch_counts()
    reqs, secs, stats, pf, fd = serve(srv, submit_all(prompts, max_new))
    counts = launch_counts()
    for r, n in zip(reqs, lens):
        if r.state != "finished" or len(r.tokens) != max_new:
            raise AssertionError(f"{r.request_id} (prompt {n}): state "
                                 f"{r.state} reason {r.finish_reason}, "
                                 f"{len(r.tokens)} tokens")
    for rows in (pf, fd):
        for rid, row in rows.items():
            if not torch.isfinite(row).all():
                raise AssertionError(f"{rid}: non-finite logits")
    if counts["flash_fwd"] <= 0 or counts["decode_paged"] <= 0:
        raise AssertionError(f"serving did not launch the kernels: {counts}")
    tokens = sum(len(r.tokens) for r in reqs)
    log(f"serving: {len(reqs)} requests, {tokens} tokens in {secs:.3f} s "
        f"({tokens / secs:.1f} tokens/s aggregate), decode steps "
        f"{stats['decode_steps']}, p50 TTFT {stats['ttft_ms_p50']:.3f} ms, "
        f"p95 TTFT {stats['ttft_ms_p95']:.3f} ms, mean per-request decode "
        f"{stats['tokens_per_sec_mean']:.1f} tokens/s, launches {counts} "
        f"[{card}]")

    with plain_versions():
        ref_reqs, ref_secs, _, ref_pf, ref_fd = serve(
            init_serving(srv.engine), submit_all(prompts, max_new))
    first_agree, agree, pf_err, fd_err = against_plain(
        "serving", reqs, pf, fd, ref_reqs, ref_pf, ref_fd)
    log(f"serving vs plain versions: first tokens agree {first_agree}/"
        f"{len(reqs)}, all tokens agree {agree}/{len(reqs) * max_new} "
        f"({agree / (len(reqs) * max_new):.3f}), max |logit diff| prefill "
        f"{pf_err:.4g}, first decode {fd_err:.4g} (tolerance "
        f"{LOGITS_ATOL}); plain run took {ref_secs:.3f} s")
    return counts


def run_generate(engine, ids, max_new, **kwargs):
    """engine.generate with every step's logits recorded (the greedy and
    the keyed sampler's alike)."""
    from deepspeed_tpu_torch.inference import engine as eng_mod

    calls = []
    sample, keyed = eng_mod.sample_logits, eng_mod.keyed_sample

    def record(fn):
        def call(logits, *args, **kw):
            calls.append(logits.float().cpu())
            return fn(logits, *args, **kw)
        return call

    with mock.patch.object(eng_mod, "sample_logits", record(sample)), \
            mock.patch.object(eng_mod, "keyed_sample", record(keyed)):
        out = engine.generate(ids, max_new_tokens=max_new, **kwargs)
    return out.cpu(), calls


def phase_generate(model, seed, card):
    """The generate() path; returns its launch counts."""
    import torch

    from deepspeed_tpu_torch import init_inference

    engine = init_inference(model)
    ids = generate_ids(engine, seed)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out, calls = run_generate(engine, ids, 32)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    if counts["flash_fwd"] <= 0 or counts["decode_append"] <= 0:
        raise AssertionError(f"generate() did not launch the kernels: "
                             f"{counts}")
    if out.shape != (2, 160) or not all(torch.isfinite(c).all()
                                        for c in calls):
        raise AssertionError(f"generate: shape {tuple(out.shape)} or "
                             f"non-finite logits")
    with plain_versions():
        ref_out, ref_calls = run_generate(engine, ids, 32)
    err = check_logits("generate prefill", calls[0], ref_calls[0])
    first_same = torch.equal(out[:, 128], ref_out[:, 128])
    if first_same:
        err = max(err, check_logits("generate first decode", calls[1],
                                    ref_calls[1]))
    agree = (out[:, 128:] == ref_out[:, 128:]).float().mean().item()
    log(f"generate: 2 x 128 prompt + 32 tokens in {secs:.3f} s "
        f"({64 / secs:.1f} tokens/s), tokens agree with plain versions "
        f"{agree:.3f}, max |logit diff| {err:.4g}, launches {counts} "
        f"[{card}]")
    return counts


# ---------------------------------------------------------------------------
# phase 5b: padded generate
# ---------------------------------------------------------------------------
# real prompt lengths of the padded batch, left-padded to the longest
PADDED_LENS = (128, 100, 37, 1)
PADDED_NEW = 32


def top2_gap(logits, knobs, position):
    """The gap between the two best scores a step's token was chosen by:
    the logits (greedy) or, with ``knobs`` (keyed), the gumbel-perturbed
    filtered logits at ``position`` times the temperature (logit units)."""
    from deepspeed_tpu_torch.ops import sampling

    row = logits.reshape(1, -1).float()
    if knobs is not None:
        temp = knobs.get("temperature", 1.0)
        key = sampling.fold_in_key(int(knobs["seed"]), int(position))
        row = (sampling.gumbel(sampling.uniform(sampling.random_bits(
            key[None], row.shape[-1]))) + sampling.keyed_filter_logits(
                row, [temp], [knobs.get("top_k", 0)],
                [knobs.get("top_p", 0.0)])) * temp
    top = row.flatten().topk(2).values
    return (top[0] - top[1]).item()


def agree_until_tie(what, got, want, want_calls, prompt_len, knobs=None):
    """Hold ``got``'s new tokens to ``want``'s (one row each) up to the
    first step where ``want``'s own two best scores lie within
    LOGITS_ATOL: there another rounding may pick the other token, and the
    streams may part. Returns (tokens agreeing, steps held)."""
    held = len(want)
    for t in range(len(want)):
        if top2_gap(want_calls[t][0], knobs, prompt_len + t) < LOGITS_ATOL:
            held = t
            break
        if got[t] != want[t]:
            raise AssertionError(f"{what}: token {t} is {got[t]}, the solo "
                                 f"run's {want[t]} (top-2 gap above "
                                 f"{LOGITS_ATOL})")
    return sum(a == b for a, b in zip(got, want)), held


def phase_padded_generate(model, seed, card):
    """``generate(attention_mask=)`` on four prompts of PADDED_LENS real
    tokens left-padded to 128 (greedy, then keyed): the decode steps run
    the append kernel with each row's first key, and each row is held to
    its prompt's solo call (prefill and first-decode logits within
    LOGITS_ATOL where the first tokens agree; tokens up to a near tie);
    then a 100-token prompt through an engine with a ``serving`` section,
    which buckets it to 128, against the same prompt unbucketed. Returns
    the padded batch's launch counts."""
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.tools.profile_serving import SERVING

    engine = init_inference(model)
    rng = np.random.default_rng(seed + 17)
    T = max(PADDED_LENS)
    prompts = [rng.integers(1, model.config.vocab_size, n)
               for n in PADDED_LENS]
    ids = torch.zeros((len(prompts), T), dtype=torch.long)
    mask = torch.zeros((len(prompts), T), dtype=torch.int32)
    for b, p in enumerate(prompts):
        ids[b, T - len(p):] = torch.from_numpy(p)
        mask[b, T - len(p):] = 1
    ids, mask = ids.cuda(), mask.cuda()
    solo_in = [torch.from_numpy(p)[None].cuda() for p in prompts]
    keyed = dict(do_sample=True, **SAMPLED_KNOBS[0])
    summary = []
    for label, kw in (("greedy", {}), ("keyed", keyed)):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out, calls = run_generate(engine, ids, PADDED_NEW,
                                  attention_mask=mask, **kw)
        secs = time.perf_counter() - t0
        counts = launch_counts()
        if label == "greedy":
            padded_counts = counts
        steps = PADDED_NEW - 1
        want = {"decode_append": steps * model.config.n_layer,
                "decode_append_padded": steps * model.config.n_layer}
        if any(counts[k] != n for k, n in want.items()):
            raise AssertionError(f"padded generate ({label}) launched "
                                 f"{counts}, not {want}")
        if out.shape != (len(prompts), T + PADDED_NEW) or not all(
                torch.isfinite(c).all() for c in calls):
            raise AssertionError(f"padded generate ({label}): shape "
                                 f"{tuple(out.shape)} or non-finite logits")
        agree = held = 0
        err = 0.0
        for b, p in enumerate(solo_in):
            solo, solo_calls = run_generate(engine, p, PADDED_NEW, **kw)
            what = f"padded generate ({label}) row {b} ({p.shape[1]} tokens)"
            err = max(err, check_logits(f"{what} prefill", calls[0][b],
                                        solo_calls[0][0]))
            if out[b, T] == solo[0, p.shape[1]]:
                err = max(err, check_logits(f"{what} first decode",
                                            calls[1][b], solo_calls[1][0]))
            a, h = agree_until_tie(
                what, out[b, T:].tolist(), solo[0, p.shape[1]:].tolist(),
                [c[:1] for c in solo_calls], p.shape[1],
                kw or None)
            agree, held = agree + a, held + h
        summary.append(
            f"{label}: {len(prompts)} x ({'/'.join(map(str, PADDED_LENS))} "
            f"left-padded to {T}) + {PADDED_NEW} tokens in {secs:.3f} s, "
            f"tokens equal to the solo runs {agree}/"
            f"{len(prompts) * PADDED_NEW} (held {held} steps before a near "
            f"tie), max "
            f"|logit diff| prefill and first decode {err:.4g}, launches "
            f"{counts}")

    bucketed = init_inference(model, serving=SERVING)
    prompt = torch.from_numpy(rng.integers(1, model.config.vocab_size,
                                           100))[None].cuda()
    reset_launch_counts()
    out, _ = run_generate(bucketed, prompt, PADDED_NEW)
    b_counts = launch_counts()
    ref, ref_calls = run_generate(engine, prompt, PADDED_NEW)
    if out.shape != ref.shape or not torch.equal(out[:, :100], ref[:, :100]):
        raise AssertionError(f"bucketed generate returned {tuple(out.shape)}"
                             f", not the prompt and {PADDED_NEW} tokens")
    if b_counts["decode_append_padded"] <= 0:
        raise AssertionError(f"the bucketed prompt did not take the padded "
                             f"path: {b_counts}")
    agree, held = agree_until_tie("bucketed generate", out[0, 100:].tolist(),
                                  ref[0, 100:].tolist(), ref_calls, 100)
    for line in summary:
        log(f"padded generate {line} [{card}]")
    log(f"bucketed generate: a 100-token prompt through serving "
        f"{SERVING} (bucket 128): tokens equal to the unbucketed call "
        f"{agree}/{PADDED_NEW} (held {held} steps before a near tie), "
        f"launches {b_counts}")
    return padded_counts


# ---------------------------------------------------------------------------
# phase 6: the serving fast path
# ---------------------------------------------------------------------------
# leg B: speculative decoding with the prompt-lookup proposer over bf16
# pools; prompts tile one motif each (lengths SPEC_MOTIFS) to ~SPEC_LEN
# tokens
SPEC_SERVING = {"block_size": 16, "decode_slots": 4,
                "speculative": {"num_speculative_tokens": 4}}
SPEC_MOTIFS = (3, 5, 8, 13, 2, 6)
SPEC_LEN = 200


def spec_prompts(vocab_size, seed):
    rng = np.random.default_rng(seed + 11)
    return [np.tile(rng.integers(1, vocab_size, n), -(-SPEC_LEN // n))
            for n in SPEC_MOTIFS]


def pool_bytes(srv):
    return sum(t.numel() * t.element_size() for t in srv.cache.pools())


def add_counts(a, b):
    return {k: a[k] + b[k] for k in a}


def leg_prefix_chunk_int8(model, seed, card):
    """Leg A: prefix cache, 256-token chunks and int8 KV together on the
    stream of ``tools/profile_serving.py --fast-path``. Returns its
    launch counts."""
    import torch

    from deepspeed_tpu_torch import init_inference, init_serving
    from deepspeed_tpu_torch.models import gpt2 as gpt2_mod
    from deepspeed_tpu_torch.tools.profile_serving import (
        FAST_SERVING, MAX_NEW_TOKENS, SYSTEM_LEN, fast_path_prompts,
        serve_fast_path)

    max_new = MAX_NEW_TOKENS
    prompts = fast_path_prompts(model.config.vocab_size, seed)

    def stream(srv):
        return serve_fast_path(srv, prompts, max_new)

    def engine(**change):
        return init_inference(model, serving={**FAST_SERVING, **change})

    int8 = engine()
    serve(init_serving(int8), stream)  # warm-up: uncounted, untimed
    rows_seen = []
    int8_kernel = gpt2_mod.decode_attention_paged_int8

    def spy(q, *args, **kwargs):
        rows_seen.append(q.shape[1])
        return int8_kernel(q, *args, **kwargs)

    srv = init_serving(int8)
    with mock.patch.object(gpt2_mod, "decode_attention_paged_int8", spy):
        reset_launch_counts()
        reqs, secs, stats, pf, fd = serve(srv, stream)
        counts = launch_counts()
    for r in reqs:
        if r.state != "finished" or len(r.tokens) != max_new:
            raise AssertionError(f"fast path {r.request_id}: state "
                                 f"{r.state} reason {r.finish_reason}, "
                                 f"{len(r.tokens)} tokens")
        if r is not reqs[0] and r.prefix_hit_tokens < SYSTEM_LEN:
            raise AssertionError(f"fast path {r.request_id}: prefix hit "
                                 f"{r.prefix_hit_tokens} < {SYSTEM_LEN}")
    if not any(r.cow is not None for r in reqs):
        raise AssertionError("fast path: no request copied a block on write")
    for rows in (pf, fd):
        for rid, row in rows.items():
            if not torch.isfinite(row).all():
                raise AssertionError(f"fast path {rid}: non-finite logits")
    chunk_calls = sum(t > 1 for t in rows_seen)
    if counts["decode_paged_int8"] <= 0 or not chunk_calls:
        raise AssertionError(f"fast path leg A did not launch the int8 "
                             f"kernel with T_q > 1: {counts}, T_q seen "
                             f"{sorted(set(rows_seen))}")
    tokens = sum(len(r.tokens) for r in reqs)
    log(f"fast path A (prefix cache + 256-token chunks + int8 KV, 8 slots):"
        f" {len(reqs)} requests (prompts {[len(p) for p in prompts]}), "
        f"{tokens} tokens in {secs:.3f} s ({tokens / secs:.1f} tokens/s), "
        f"p50 TTFT {stats['ttft_ms_p50']:.3f} ms, p95 "
        f"{stats['ttft_ms_p95']:.3f} ms, decode steps "
        f"{stats['decode_steps']}; prefix hits "
        f"{[r.prefix_hit_tokens for r in reqs]}, chunks "
        f"{[r.prefill_chunks for r in reqs]}, cow "
        f"{[r.cow is not None for r in reqs]}; int8 kernel calls by T_q "
        f"{ {t: rows_seen.count(t) for t in sorted(set(rows_seen))} }; "
        f"launches {counts} [{card}]")

    with plain_versions():
        ref_reqs, ref_secs, _, ref_pf, ref_fd = serve(init_serving(int8),
                                                      stream)
    first_agree, agree, pf_err, fd_err = against_plain(
        "fast path", reqs, pf, fd, ref_reqs, ref_pf, ref_fd)
    log(f"fast path A vs plain versions: first tokens agree {first_agree}/"
        f"{len(reqs)}, all tokens agree {agree}/{tokens}, max |logit diff| "
        f"prefill {pf_err:.4g}, first decode {fd_err:.4g} (tolerance "
        f"{LOGITS_ATOL}); plain run took {ref_secs:.3f} s")

    # for information: the same stream without the prefix cache, and over
    # bf16 pools
    off_srv = init_serving(engine(prefix_cache=False))
    _, off_secs, off_stats, _, _ = serve(off_srv, stream)
    bf16_srv = init_serving(engine(kv_cache_dtype=""))
    bf16_reqs, bf16_secs, _, _, _ = serve(bf16_srv, stream)
    same = sum(a == b for r, q in zip(reqs, bf16_reqs)
               for a, b in zip(r.tokens, q.tokens))
    log(f"fast path A, prefix cache off: p50 TTFT "
        f"{off_stats['ttft_ms_p50']:.3f} ms, p95 "
        f"{off_stats['ttft_ms_p95']:.3f} ms in {off_secs:.3f} s (on: "
        f"{stats['ttft_ms_p50']:.3f} / {stats['ttft_ms_p95']:.3f} ms in "
        f"{secs:.3f} s); bf16 pools: tokens agree with int8 {same}/{tokens}"
        f" in {bf16_secs:.3f} s; pool bytes int8 {pool_bytes(srv)} (scales "
        f"included) vs bf16 {pool_bytes(bf16_srv)} [{card}]")
    return counts


def leg_speculative(model, seed, card):
    """Leg B: speculative decoding (prompt lookup, k = 4) over bf16
    pools. Every emitted token must be within LOGITS_ATOL of the largest
    logit at its position in one teacher-forced causal forward (flash
    kernel) of prompt + tokens. Returns its launch counts."""
    import torch

    from deepspeed_tpu_torch import init_inference, init_serving
    from deepspeed_tpu_torch.tools.profile_serving import MAX_NEW_TOKENS

    max_new = MAX_NEW_TOKENS
    prompts = spec_prompts(model.config.vocab_size, seed)
    stream = submit_all(prompts, max_new)
    spec = init_inference(model, serving=SPEC_SERVING)

    def verify_stream(srv):
        """serve() with each request's first verify logits cut to its
        valid rows: the pending token and that step's drafts (the rest
        pad the step against the garbage block)."""
        drafts, propose = {}, srv._proposer.propose

        def spy(req, k):
            out = propose(req, k)
            drafts.setdefault(req.request_id, len(out[:k]))
            return out

        srv._proposer.propose = spy
        reqs, secs, stats, pf, fd = serve(srv, stream)
        return (reqs, secs, stats, pf,
                {rid: rows[:1 + drafts[rid]] for rid, rows in fd.items()})

    serve(init_serving(spec), stream)  # warm-up: uncounted, untimed
    reset_launch_counts()
    reqs, secs, stats, pf, fd = verify_stream(init_serving(spec))
    counts = launch_counts()
    if counts["flash_fwd"] <= 0 or counts["decode_paged"] <= 0:
        raise AssertionError(f"fast path leg B did not launch the kernels: "
                             f"{counts}")
    worst = 0.0
    for r in reqs:
        if r.state != "finished" or len(r.tokens) != max_new:
            raise AssertionError(f"speculative {r.request_id}: state "
                                 f"{r.state}, {len(r.tokens)} tokens")
        ids = list(r.prompt) + r.tokens[:-1]
        logits = spec.forward(torch.tensor(ids, device=spec.device))[0]
        at = logits[len(r.prompt) - 1:].float()
        gap = (at.max(dim=-1).values
               - at.gather(1, torch.tensor(r.tokens, device=at.device)[:, None]
                           )[:, 0])
        worst = max(worst, gap.max().item())
        if not torch.isfinite(at).all() or gap.max().item() > LOGITS_ATOL:
            raise AssertionError(f"speculative {r.request_id}: a token "
                                 f"{gap.max().item()} below its position's "
                                 f"largest teacher-forced logit")
    with plain_versions():
        ref_reqs, ref_secs, _, ref_pf, ref_fd = verify_stream(
            init_serving(spec))
    first_agree, agree, pf_err, fd_err = against_plain(
        "speculative", reqs, pf, fd, ref_reqs, ref_pf, ref_fd)
    plain = init_serving(init_inference(model, serving={
        k: v for k, v in SPEC_SERVING.items() if k != "speculative"}))
    base_reqs, base_secs, base_stats, _, _ = serve(plain, stream)
    tokens = sum(len(r.tokens) for r in reqs)
    sp = stats["speculative"]
    decode_tokens = tokens - len(reqs)
    slot_steps = decode_tokens - sp["accepted_tokens"]
    same = sum(a == b for r, q in zip(reqs, base_reqs)
               for a, b in zip(r.tokens, q.tokens))
    log(f"fast path B (speculative, prompt lookup k=4, bf16 pools, 4 slots):"
        f" {len(reqs)} requests, {tokens} tokens in {secs:.3f} s "
        f"({tokens / secs:.1f} tokens/s) vs {base_secs:.3f} s "
        f"({tokens / base_secs:.1f} tokens/s) without speculation; verify "
        f"steps {stats['decode_steps']} vs decode steps "
        f"{base_stats['decode_steps']}; drafts {sp['draft_tokens']}, "
        f"accepted {sp['accepted_tokens']} (rate {sp['acceptance_rate']}), "
        f"{decode_tokens / max(1, slot_steps):.3f} tokens per slot verify "
        f"step, {sp['accepted_tokens_per_step']} accepted per verify step; "
        f"worst teacher-forced logit gap {worst:.4g} (limit {LOGITS_ATOL});"
        f" tokens equal to non-speculative decode {same}/{tokens}; launches"
        f" {counts} [{card}]")
    log(f"fast path B vs plain versions: first tokens agree {first_agree}/"
        f"{len(reqs)}, all tokens agree {agree}/{tokens}, max |logit diff| "
        f"prefill {pf_err:.4g}, first verify step (every valid row) "
        f"{fd_err:.4g} (tolerance {LOGITS_ATOL}); plain run took "
        f"{ref_secs:.3f} s")
    return counts


def phase_fast_path(model, seed, card):
    """The serving fast path: leg A then leg B, each with the launch
    counts zeroed just before its counted run and read just after.
    Returns the two legs' counts summed."""
    return add_counts(leg_prefix_chunk_int8(model, seed, card),
                      leg_speculative(model, seed, card))


# keyed sampling (phase 7): the knobs of the sampled requests, and the
# draw check's rows
SAMPLED_KNOBS = (dict(seed=101, temperature=0.8, top_p=0.9),
                 dict(seed=202, temperature=1.0, top_k=50),
                 dict(seed=303, temperature=1.3, top_k=7),
                 dict(seed=404))
DRAW_ROWS = 64
DRAW_TIE = 1e-5
HOST_STEPS = 30


def check_keyed_draw(vocab, seed):
    """The keyed draw on the card against the same function on the CPU
    over DRAW_ROWS logits rows of the vocabulary, mixed greedy and sampled
    rows and knobs: the tokens must be equal, except in a row whose two
    best perturbed scores (gumbel + filtered logit, on the CPU) lie within
    DRAW_TIE of each other, where the card's other rounding of the filter
    may pick the other one. Returns (rows that differ, ms of a 4-row draw
    with its host work)."""
    import torch

    from deepspeed_tpu_torch.ops import sampling

    rng = np.random.default_rng(seed + 11)
    n = DRAW_ROWS
    logits = torch.from_numpy(
        (3 * rng.standard_normal((n, vocab))).astype(np.float32))
    knobs = (rng.integers(0, 2 ** 32, n), rng.integers(0, 1024, n),
             rng.integers(0, 4, n) > 0, rng.choice([0.7, 1.0, 1.3], n),
             rng.choice([0, 7, 50], n), rng.choice([0.0, 0.9], n))
    cpu = sampling.keyed_sample(logits, *knobs)
    gpu = sampling.keyed_sample(logits.cuda(), *knobs).cpu()
    differ = (cpu != gpu).nonzero().flatten().tolist()
    for i in differ:
        key = sampling.fold_in_key(int(knobs[0][i]), int(knobs[1][i]))
        row = sampling.keyed_filter_logits(
            logits[i:i + 1], [knobs[3][i]], [knobs[4][i]], [knobs[5][i]])
        scores = sampling.gumbel(sampling.uniform(sampling.random_bits(
            key[None], vocab))) + row
        top = scores.flatten().topk(2).values
        if not knobs[2][i] or (top[0] - top[1]).item() > DRAW_TIE:
            raise AssertionError(
                f"keyed draw row {i}: card token {int(gpu[i])}, CPU token "
                f"{int(cpu[i])}, best perturbed scores {top.tolist()}")
    four = logits[:4].cuda()
    on = [1, 1, 1, 1]
    # back to back on CUDA events: each call uploads its knobs, which
    # holds the host, so this is the draw's time with its host work
    ms = wrapper_ms(lambda: sampling.keyed_sample(
        four, knobs[0][:4], knobs[1][:4], on, knobs[3][:4], knobs[4][:4],
        knobs[5][:4]))
    return differ, ms


def mixed_requests(srv, prompts, max_new, sampled):
    """A staggered mix on ``srv``: requests 0 and 1, two steps, 2 and 3,
    a step, 4, a step, 5, then a drain. When ``sampled``, requests 0, 2,
    3 and 5 sample with SAMPLED_KNOBS 0-3; 1 and 4 are greedy. Returns
    the requests."""
    order = (0, None, 1, 2, None, 3)
    reqs = []
    for i, p in enumerate(prompts):
        k = order[i]
        kw = dict(do_sample=True, **SAMPLED_KNOBS[k]) \
            if sampled and k is not None else {}
        reqs.append(srv.submit(p, max_new_tokens=max_new,
                               request_id=f"m{i}", **kw))
        for _ in range({1: 2, 3: 1, 4: 1}.get(i, 0)):
            srv.step()
    srv.drain()
    return reqs


def decode_step_ms(srv, prompts, max_new, sampled):
    """Host ms of each of HOST_STEPS decode steps of ``srv`` once every
    request of ``prompts`` (one a slot) is past its prefill; a step ends
    in the host sync of its tokens."""
    for i, p in enumerate(prompts):
        kw = dict(do_sample=True, **SAMPLED_KNOBS[i]) if sampled else {}
        srv.submit(p, max_new_tokens=max_new, **kw)
    srv.step()
    out = []
    for _ in range(HOST_STEPS):
        t0 = time.perf_counter()
        srv.step()
        out.append(1e3 * (time.perf_counter() - t0))
    srv.drain()
    return out


def phase_sampling(model, seed, card):
    """Keyed sampling on the card: the draw against the CPU's, a staggered
    mix of 4 sampled and 2 greedy requests (each finishes; the greedy ones
    emit a sampling-free engine's tokens; a sampled one repeats its tokens
    under another mix; not every sampled stream is the greedy one),
    ``generate(seed=)`` twice, bit for bit, and the host ms of a decode
    step with 4 sampled slots against 4 greedy ones. Returns the launch
    counts of the mixed serving run and of generate."""
    import torch

    from deepspeed_tpu_torch import init_inference, init_serving
    from deepspeed_tpu_torch.tools.profile_serving import (
        MAX_NEW_TOKENS, SERVING)

    vocab = model.config.vocab_size
    differ, draw_ms = check_keyed_draw(vocab, seed)
    log(f"keyed draw: {DRAW_ROWS} rows of {vocab} logits, card against "
        f"CPU: {len(differ)} rows differ (each within {DRAW_TIE} of a tie: "
        f"{differ}); a draw of 4 sampled rows {draw_ms:.4f} ms back to "
        f"back, host work included [{card}]")

    rng = np.random.default_rng(seed + 13)
    prompts = [rng.integers(1, vocab, n) for n in (37, 300, 8, 129, 64, 511)]
    max_new = MAX_NEW_TOKENS
    keyed = {**SERVING, "sampling": {"enabled": True}}
    srv = init_serving(model, serving=keyed)
    torch.cuda.synchronize()
    reset_launch_counts()
    reqs = mixed_requests(srv, prompts, max_new, sampled=True)
    counts = launch_counts()
    for r in reqs:
        if r.state != "finished" or len(r.tokens) != max_new:
            raise AssertionError(f"sampled mix {r.request_id}: state "
                                 f"{r.state} reason {r.finish_reason}, "
                                 f"{len(r.tokens)} tokens")
    if counts["flash_fwd"] <= 0 or counts["decode_paged"] <= 0:
        raise AssertionError(f"sampled serving did not launch the kernels: "
                             f"{counts}")
    plain = init_serving(model, serving=SERVING)
    reset_launch_counts()
    greedy = mixed_requests(plain, prompts, max_new, sampled=False)
    plain_counts = launch_counts()
    reset_launch_counts()
    keyed_greedy = mixed_requests(srv, prompts, max_new, sampled=False)
    if launch_counts() != plain_counts:
        raise AssertionError(f"a greedy mix launched {launch_counts()} with "
                             f"the sampling block, {plain_counts} without")
    sampled_idx = (0, 2, 3, 5)
    for i in (1, 4):
        if reqs[i].tokens != greedy[i].tokens or \
                keyed_greedy[i].tokens != greedy[i].tokens:
            raise AssertionError(f"greedy request {i} in the sampled mix "
                                 f"differs from the sampling-free engine")
    same = [reqs[i].tokens == greedy[i].tokens for i in sampled_idx]
    if all(same):
        raise AssertionError("every sampled stream equals the greedy one")
    again = srv.submit(prompts[0], max_new_tokens=max_new, do_sample=True,
                       **SAMPLED_KNOBS[0])
    srv.submit(prompts[4], max_new_tokens=max_new)
    srv.submit(prompts[1], max_new_tokens=max_new // 2)
    srv.drain()
    if again.tokens != reqs[0].tokens:
        raise AssertionError("a sampled request resubmitted under another "
                             "mix changed its tokens")
    log(f"sampled serving: 6 requests (4 sampled, 2 greedy) finished, "
        f"greedy tokens equal the sampling-free engine's, sampled streams "
        f"equal to greedy {same}, resubmitted stream repeats; launches "
        f"{counts}; a greedy mix with and without the block {plain_counts}")

    engine = init_inference(model)
    ids = generate_ids(engine, seed)
    torch.cuda.synchronize()
    reset_launch_counts()
    first = engine.generate(ids, max_new_tokens=max_new, do_sample=True,
                            **SAMPLED_KNOBS[0]).cpu()
    gen_counts = launch_counts()
    second = engine.generate(ids, max_new_tokens=max_new, do_sample=True,
                             **SAMPLED_KNOBS[0]).cpu()
    if first.shape != (2, 128 + max_new) or not torch.equal(first, second):
        raise AssertionError("generate(seed=) is not repeatable")
    if gen_counts["flash_fwd"] <= 0 or gen_counts["decode_append"] <= 0:
        raise AssertionError(f"generate(seed=) did not launch the kernels: "
                             f"{gen_counts}")

    host = {}
    step_prompts = [rng.integers(1, vocab, 128) for _ in range(4)]
    for name, cfg, sampled in (("sampled", keyed, True),
                               ("greedy", keyed, False),
                               ("greedy, no block", SERVING, False)):
        ms = decode_step_ms(init_serving(model, serving=cfg),
                            step_prompts, HOST_STEPS + 2, sampled)
        host[name] = (float(np.median(ms)), float(np.mean(ms)))
    log(f"host ms a decode step, 4 slots (p50, mean over {HOST_STEPS}): "
        + "; ".join(f"{k} {v[0]:.3f}, {v[1]:.3f}" for k, v in host.items())
        + f"; the draw adds {host['sampled'][0] - host['greedy'][0]:.3f} ms "
        f"p50 [{card}]")
    log(f"generate(seed=): 2 x {max_new} tokens twice, bit for bit; "
        f"launches {gen_counts}")
    return counts, gen_counts


def first_grads(engine, batch):
    """Per-parameter gradients of the first step's loss (the engine's
    model, before any update); leaves the engine's gradients clear."""
    engine.module(batch).backward()
    grads = {n: p.grad.clone() for n, p in engine.module.named_parameters()}
    engine.zero_grad()
    return grads


def phase_training(seed, card):
    """The training path: bench.py's configuration on GPT-2 125M at full
    width through ``deepspeed_tpu_torch.initialize``. One warm-up step
    (its loss is the first loss: within 0.3 of ln V), then 10 timed steps
    with the launch counts zeroed just before and read just after; the
    loss must fall. Then a second engine from the same seed runs with the
    plain versions on the card: the first step's per-tensor gradients and
    the first three losses are held against the kernel path's. Returns
    the training path's launch counts."""
    import torch

    from deepspeed_tpu_torch.tools.profile_training import (
        BATCH, PEAK_BF16_FLOPS, SEQ, bench_batch, bench_engine, bench_model,
        flops_per_token, timed_steps, train_steps)

    engine = bench_engine(bench_model(seed))
    batch = bench_batch(engine.module.config.vocab_size, seed, engine.device)
    kernel_grads = first_grads(engine, batch)
    first, _ = timed_steps(engine, batch, 1)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, secs = timed_steps(engine, batch, TRAIN_STEPS)
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = first + losses
    n_layer = engine.module.config.n_layer
    log_v = float(np.log(engine.module.config.vocab_size))
    if not all(np.isfinite(losses)) or abs(losses[0] - log_v) > 0.3:
        raise AssertionError(f"training: first loss {losses[0]} not within "
                             f"0.3 of ln V = {log_v}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training: the loss did not fall: {losses}")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        if counts[name] != TRAIN_STEPS * n_layer:
            raise AssertionError(f"training: {name} launched {counts[name]}"
                                 f" times in {TRAIN_STEPS} steps, not "
                                 f"{n_layer} a step")
    if counts["flash_fwd"] not in (TRAIN_STEPS * n_layer,
                                   2 * TRAIN_STEPS * n_layer):
        raise AssertionError(f"training: flash_fwd launched "
                             f"{counts['flash_fwd']} times")
    tokens_per_s = TRAIN_STEPS * BATCH * SEQ / secs
    mfu = tokens_per_s * flops_per_token(engine.module) / PEAK_BF16_FLOPS
    log(f"training: GPT-2 125M, batch {BATCH} x {SEQ}, bf16, dots remat, "
        f"fused AdamW step; {TRAIN_STEPS} steps in {secs:.3f} s "
        f"({1e3 * secs / TRAIN_STEPS:.1f} ms/step, {tokens_per_s:.0f} "
        f"tokens/s, MFU {mfu:.4f} of 989 TF/s), peak memory {peak_gb:.2f} "
        f"GB; losses {[round(x, 4) for x in losses]} (ln V = {log_v:.4f}); "
        f"launches per step flash_fwd {counts['flash_fwd'] / TRAIN_STEPS} "
        f"({'saved' if counts['flash_fwd'] == TRAIN_STEPS * n_layer else 'recomputed'} "
        f"by the dots policy), flash_bwd_dq "
        f"{counts['flash_bwd_dq'] / TRAIN_STEPS}, flash_bwd_dkv "
        f"{counts['flash_bwd_dkv'] / TRAIN_STEPS} [{card}]")
    del engine

    with plain_versions():
        plain = bench_engine(bench_model(seed))
        plain_grads = first_grads(plain, batch)
        plain_losses = [float(x) for x in
                        train_steps(plain, batch, 1 + TRAIN_STEPS)]
    grad_err = {}
    for name, g in kernel_grads.items():
        ref = plain_grads[name].float()
        grad_err[name] = ((g.float() - ref).norm()
                          / ref.norm().clamp_min(1e-30)).item()
    worst = max(grad_err, key=grad_err.get)
    loss_err = max(abs(a - b) for a, b in zip(losses[:3], plain_losses))
    if loss_err > TRAIN_LOSS_ATOL or grad_err[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError(
            f"training kernels vs plain versions: losses {losses[:3]} vs "
            f"{plain_losses[:3]} (max diff {loss_err}, limit "
            f"{TRAIN_LOSS_ATOL}); worst gradient {worst} relative L2 "
            f"{grad_err[worst]} (limit {TRAIN_GRAD_RTOL})")
    log(f"training vs plain versions: plain-path losses "
        f"{[round(x, 4) for x in plain_losses]}; first 3 max |diff| "
        f"{loss_err:.3g} (limit {TRAIN_LOSS_ATOL}); step-1 gradients"
        f" relative L2 max {grad_err[worst]:.3g} at {worst}, median "
        f"{float(np.median(list(grad_err.values()))):.3g} (limit "
        f"{TRAIN_GRAD_RTOL})")
    return counts


# phase 8: BERT-large MLM with the sparse_attention section. 3 warm-up and
# 5 timed steps of the sparse workload (every launch count per step:
# forward, dQ and dK/dV once a layer, the forward saved by the dots policy,
# no flash); the kernel-vs-plain comparison at BERT_PLAIN_LAYERS of the 24
# layers (widths and sequence unchanged: the plain versions' [B, H, S, S]
# fp32 scores take 2.1 GB a tensor); one warm-up and 5 timed steps of the
# dense leg
BERT_WARMUP, BERT_STEPS, BERT_DENSE_STEPS = 3, 5, 5
BERT_PLAIN_LAYERS = 4
# the largest key-bias gradient norm, in either path, as a share of the
# same layer's query-bias gradient norm in the plain path: the key biases'
# exact gradient is zero, and bf16 rounding of ds leaves a few percent
# (0.0391 on the H100, PERF.md); the limit is about three times that. The
# control beside it reads the share from above: the plain path with delta
# zeroed, so that no dS row sums to zero, must read above the limit
KEY_BIAS_NOISE = 0.12


def check_losses(what, losses, log_v):
    """First loss within 0.3 of ln V (random weights), falling on the
    repeated batch."""
    if not all(np.isfinite(losses)) or abs(losses[0] - log_v) > 0.3:
        raise AssertionError(f"{what}: first loss {losses[0]} not within 0.3"
                             f" of ln V = {log_v}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss did not fall: {losses}")


def check_per_step(what, counts, steps, want):
    """Each kernel of ``want`` launched ``want[name]`` times a step."""
    for name, n in want.items():
        if counts[name] != steps * n:
            raise AssertionError(f"{what}: {name} launched {counts[name]} "
                                 f"times in {steps} steps, not {n} a step")


def key_bias_shares(grads, ref):
    """Each layer's key-bias gradient norm in ``grads`` over its
    query-bias gradient norm in ``ref``."""
    return {name: (grads[name].float().norm() / ref[name.replace(
                "key.bias", "query.bias")].float().norm()).item()
            for name in grads if name.endswith("attention.self.key.bias")}


def phase_bert(seed, card):
    """BERT-large MLM training through ``deepspeed_tpu_torch.initialize``
    with bench_bert.py's keys: the sparse workload (``sparse_attention``
    section, 2 x 4096) at full width and depth, its kernel path against
    the plain versions at reduced depth, and the dense leg (64 x 128, no
    section). Returns the launch counts of the sparse and dense legs."""
    import torch

    from deepspeed_tpu_torch.tools.profile_training import (
        BERT_DENSE_SHAPE, BERT_SPARSE_SHAPE, PEAK_BF16_FLOPS, bert_batch,
        bert_engine, bert_flops_per_token, bert_model, sparse_density,
        timed_steps, train_steps)

    engine = bert_engine(bert_model(seed))
    cfg = engine.module.config
    n_layer, log_v = cfg.num_hidden_layers, float(np.log(cfg.vocab_size))
    batch = bert_batch(cfg.vocab_size, seed, engine.device)
    warm, _ = timed_steps(engine, batch, BERT_WARMUP)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, secs = timed_steps(engine, batch, BERT_STEPS)
    sparse_counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = warm + losses
    check_losses("bert sparse", losses, log_v)
    check_per_step("bert sparse", sparse_counts, BERT_STEPS, {
        "block_sparse_fwd": n_layer, "block_sparse_bwd_dq": n_layer,
        "block_sparse_bwd_dkv": n_layer, "flash_fwd": 0, "flash_bwd_dq": 0,
        "flash_bwd_dkv": 0})
    tokens = BERT_SPARSE_SHAPE[0] * BERT_SPARSE_SHAPE[1]
    density = sparse_density(BERT_SPARSE_SHAPE[1])
    tokens_per_s = BERT_STEPS * tokens / secs
    mfu = tokens_per_s * bert_flops_per_token(
        engine.module, BERT_SPARSE_SHAPE[1], density) / PEAK_BF16_FLOPS
    log(f"bert sparse: BERT-large, batch {BERT_SPARSE_SHAPE[0]} x "
        f"{BERT_SPARSE_SHAPE[1]}, fixed per-head layout block 128 (density "
        f"{density:.4f}), bf16, dots remat, fused Adam step; {BERT_STEPS} "
        f"steps in {secs:.3f} s ({1e3 * secs / BERT_STEPS:.1f} ms/step, "
        f"{tokens_per_s:.0f} tokens/s, MFU {mfu:.4f} of 989 TF/s), peak "
        f"memory {peak_gb:.2f} GB; losses {[round(x, 4) for x in losses]} "
        f"(ln V = {log_v:.4f}); launches per step "
        f"{ {k: v / BERT_STEPS for k, v in sparse_counts.items() if v} } "
        f"[{card}]")
    del engine
    torch.cuda.empty_cache()

    # kernels against plain versions at reduced depth, the same batch
    kernel = bert_engine(bert_model(seed, layers=BERT_PLAIN_LAYERS))
    kernel_grads = first_grads(kernel, batch)
    kernel_losses = [float(x) for x in train_steps(kernel, batch, 3)]
    del kernel
    torch.cuda.empty_cache()
    with plain_versions():
        plain = bert_engine(bert_model(seed, layers=BERT_PLAIN_LAYERS))
        plain_grads = first_grads(plain, batch)
        plain_losses = [float(x) for x in train_steps(plain, batch, 3)]
    del plain
    torch.cuda.empty_cache()
    # the control: the plain path with delta = rowsum(dO * O) zeroed
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bs
    with plain_versions(), mock.patch.object(
            bs, "attention_delta",
            lambda do, o: torch.zeros(o.shape[:-1], dtype=torch.float32,
                                      device=o.device)):
        faulty = bert_engine(bert_model(seed, layers=BERT_PLAIN_LAYERS))
        faulty_grads = first_grads(faulty, batch)
    del faulty
    torch.cuda.empty_cache()
    # the key biases' exact gradient is zero: a bias shared by every key
    # of a row shifts all its scores alike, and softmax ignores the shift.
    # Both paths give rounding noise there (bf16 ds), which is held below
    # KEY_BIAS_NOISE of the same layer's query-bias gradient in each path
    # instead of to the other path's noise
    kernel_kb = key_bias_shares(kernel_grads, plain_grads)
    plain_kb = key_bias_shares(plain_grads, plain_grads)
    key_bias = {name: max(kernel_kb[name], plain_kb[name])
                for name in kernel_kb}
    control = min(key_bias_shares(faulty_grads, plain_grads).values())
    if not control > KEY_BIAS_NOISE:
        raise AssertionError(
            f"bert sparse: with delta zeroed the key-bias gradients read "
            f"{control} of their query bias's, not above the limit "
            f"{KEY_BIAS_NOISE}: the key-bias check cannot see that fault")
    grad_err = {name: ((g.float() - plain_grads[name].float()).norm()
                       / plain_grads[name].float().norm().clamp_min(1e-30)
                       ).item() for name, g in kernel_grads.items()
                if name not in key_bias}
    worst = max(grad_err, key=grad_err.get)
    noisiest = max(key_bias, key=key_bias.get)
    loss_err = max(abs(a - b) for a, b in zip(kernel_losses, plain_losses))
    if loss_err > TRAIN_LOSS_ATOL or grad_err[worst] > TRAIN_GRAD_RTOL \
            or key_bias[noisiest] > KEY_BIAS_NOISE:
        raise AssertionError(
            f"bert sparse kernels vs plain versions ({BERT_PLAIN_LAYERS} "
            f"layers): losses {kernel_losses} vs {plain_losses} (max diff "
            f"{loss_err}, limit {TRAIN_LOSS_ATOL}); worst gradient {worst} "
            f"relative L2 {grad_err[worst]} (limit {TRAIN_GRAD_RTOL}); "
            f"largest key-bias gradient {noisiest} {key_bias[noisiest]} of "
            f"its query bias's (limit {KEY_BIAS_NOISE})")
    log(f"bert sparse vs plain versions ({BERT_PLAIN_LAYERS} of {n_layer} "
        f"layers, full width and sequence): losses "
        f"{[round(x, 4) for x in kernel_losses]} vs "
        f"{[round(x, 4) for x in plain_losses]}, max |diff| {loss_err:.3g} "
        f"(limit {TRAIN_LOSS_ATOL}); step-1 gradients relative L2 max "
        f"{grad_err[worst]:.3g} at {worst}, median "
        f"{float(np.median(list(grad_err.values()))):.3g} (limit "
        f"{TRAIN_GRAD_RTOL}); key-bias gradients (exactly zero in exact "
        f"arithmetic) at most {key_bias[noisiest]:.3g} of their layer's "
        f"query-bias gradient, {noisiest} (limit {KEY_BIAS_NOISE}; with "
        f"delta zeroed in the plain path at least {control:.3g})")

    # the dense leg: bench_bert.py's shape, no sparse_attention section
    dense = bert_engine(bert_model(seed, sparse=False), sparse=False)
    dense_batch = bert_batch(cfg.vocab_size, seed, dense.device,
                             sparse=False)
    dense_warm, _ = timed_steps(dense, dense_batch, 1)
    reset_launch_counts()
    dense_losses, dense_secs = timed_steps(dense, dense_batch,
                                           BERT_DENSE_STEPS)
    dense_counts = launch_counts()
    dense_losses = dense_warm + dense_losses
    check_losses("bert dense", dense_losses, log_v)
    check_per_step("bert dense", dense_counts, BERT_DENSE_STEPS, {
        "flash_fwd": n_layer, "flash_bwd_dq": n_layer,
        "flash_bwd_dkv": n_layer, "block_sparse_fwd": 0,
        "block_sparse_bwd_dq": 0, "block_sparse_bwd_dkv": 0})
    dense_tokens_per_s = (BERT_DENSE_STEPS * BERT_DENSE_SHAPE[0]
                          * BERT_DENSE_SHAPE[1] / dense_secs)
    dense_mfu = dense_tokens_per_s * bert_flops_per_token(
        dense.module, BERT_DENSE_SHAPE[1], 1.0) / PEAK_BF16_FLOPS
    log(f"bert dense: BERT-large, batch {BERT_DENSE_SHAPE[0]} x "
        f"{BERT_DENSE_SHAPE[1]}, non-causal flash kernels; one warm-up "
        f"step, then {BERT_DENSE_STEPS} steps in {dense_secs:.3f} s "
        f"({1e3 * dense_secs / BERT_DENSE_STEPS:.1f} ms/step, "
        f"{dense_tokens_per_s:.0f} tokens/s, MFU {dense_mfu:.4f} of 989 "
        f"TF/s); losses {[round(x, 4) for x in dense_losses]}; "
        f"launches per step "
        f"{ {k: v / BERT_DENSE_STEPS for k, v in dense_counts.items() if v} }"
        f" [{card}]")
    del dense
    torch.cuda.empty_cache()
    return sparse_counts, dense_counts


# the thirteen TPU kernels, rows 1-13 of PERF.md's table, each with: its
# port source, the TPU kernel it replaces, the path whose count is
# "launches" (None: no path calls it, and "launches" sums every path's),
# the port kernel's name in the checks and in the counts, the row of its
# checks reported (the flash kernels at GPT-2's training shape, B=16 H=12
# T=1024 D=64; append decode at idx=1000 T_q=1; the paged kernels at
# T_q=1; the block-sparse kernels at the BERT slice's shape; the quantizer
# at the embedding gradient's), the dtype of that row, the row keys
# listed for every timed row of its checks (None: no list), whether the
# non-causal row (BERT's dense leg, the checks' last) is reported, and the
# source of its fp32 variant where that differs (for the block-sparse
# backward also bf16 at blocks that are not a multiple of 64: each timed
# row names the source it ran). Rows 4-6 are kernels 1-3
# through the [B, T, H, D] views every training path hands them (one
# wrapper and count serve both layouts)
Kernel = collections.namedtuple(
    "Kernel", "source replaces path port row dtype rows noncausal "
    "fp32_source", defaults=("bfloat16", None, False, None))
_FLASH = "deepspeed_tpu/ops/flash_attention.py"
_DECODE = "deepspeed_tpu/ops/decode_attention.py"
_SPARSE = "deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py"
KERNEL_TABLE = {
    "flash_fwd": Kernel("flash_fwd_sm90.cu", f"{_FLASH}:77", "training",
                        "flash_fwd", 3, rows=("lse_err",), noncausal=True,
                        fp32_source="flash_fwd.cu"),
    "flash_bwd_dq": Kernel("flash_bwd_dq_sm90.cu", f"{_FLASH}:196",
                           "training", "flash_bwd_dq", 0, noncausal=True,
                           fp32_source="flash_bwd_dq.cu"),
    "flash_bwd_dkv": Kernel("flash_bwd_dkv_sm90.cu", f"{_FLASH}:252",
                            "training", "flash_bwd_dkv", 0, noncausal=True,
                            fp32_source="flash_bwd_dkv.cu"),
    "flash_fwd_bthd": Kernel("flash_fwd_sm90.cu", f"{_FLASH}:504",
                             "training", "flash_fwd", 4,
                             fp32_source="flash_fwd.cu"),
    "flash_bwd_dq_bthd": Kernel("flash_bwd_dq_sm90.cu", f"{_FLASH}:509",
                                "training", "flash_bwd_dq", 1,
                                fp32_source="flash_bwd_dq.cu"),
    "flash_bwd_dkv_bthd": Kernel("flash_bwd_dkv_sm90.cu", f"{_FLASH}:516",
                                 "training", "flash_bwd_dkv", 1,
                                 fp32_source="flash_bwd_dkv.cu"),
    "decode_append": Kernel("decode_append.cu", f"{_DECODE}:39", "generate",
                            "decode_append", 2, rows=("splits",)),
    "decode_append_padded": Kernel("decode_append.cu", f"{_DECODE}:39",
                                   "padded_generate", "decode_append_padded",
                                   0, rows=("splits",)),
    "decode_paged": Kernel("decode_paged.cu", f"{_DECODE}:194", "serving",
                           "decode_paged", 0, rows=("source", "splits")),
    "decode_paged_int8": Kernel("decode_paged_int8.cu", f"{_DECODE}:319",
                                "fast_path", "decode_paged_int8", 0,
                                rows=("source", "splits")),
    "block_sparse_fwd": Kernel("block_sparse_fwd_sm90.cu", f"{_SPARSE}:79",
                               "bert_sparse", "block_sparse_fwd", 0,
                               rows=("source",),
                               fp32_source="block_sparse_fwd.cu"),
    "block_sparse_bwd_dq": Kernel("block_sparse_bwd_dq_sm90.cu",
                                  f"{_SPARSE}:175", "bert_sparse",
                                  "block_sparse_bwd_dq", 0,
                                  rows=("source",),
                                  fp32_source="block_sparse_bwd_dq.cu"),
    "block_sparse_bwd_dkv": Kernel("block_sparse_bwd_dkv_sm90.cu",
                                   f"{_SPARSE}:214", "bert_sparse",
                                   "block_sparse_bwd_dkv", 0,
                                   rows=("source",),
                                   fp32_source="block_sparse_bwd_dkv.cu"),
    "stochastic_quantize": Kernel("stochastic_quantize.cu",
                                  "deepspeed_tpu/ops/quantizer.py:141", None,
                                  "stochastic_quantize", QUANT_ROW,
                                  dtype="float32",
                                  rows=("pass1_ms", "pass2_ms")),
}


def kernel_line(kernel_rows, by_path):
    """The ``{"kernels": [...]}`` entries: every row of the kernel table
    with its launches on its path (summed over every path where no path
    calls it) and on every path, its largest error over all checked
    shapes, and the times and bound of its reported row, as
    KERNEL_TABLE's columns ask."""
    keys = ("shape", "ms", "wrapper_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")
    src = "deepspeed_tpu_torch/csrc/"
    out = []
    for name, k in KERNEL_TABLE.items():
        rows = kernel_rows[k.port]
        row = rows[k.row]
        counts = {p: c[k.port] for p, c in by_path.items()}
        entry = {
            "name": name, "route": "cuda", "source": src + k.source,
            "replaces": k.replaces, "path": k.path,
            "launches": counts[k.path] if k.path else sum(counts.values()),
            "launches_by_path": counts,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{key: row[key] for key in keys if key != "shape"},
            "shape": row["shape"], "dtype": k.dtype}
        if k.fp32_source:
            entry["fp32_source"] = src + k.fp32_source
        if k.noncausal:
            entry["noncausal"] = {key: rows[-1][key] for key in keys}
        if k.rows is not None:
            entry["rows"] = [{key: r[key] for key in keys + k.rows
                              if key in r} for r in rows if "ms" in r]
        out.append(entry)
    return out


def ptxas_instances(out):
    """``{function: (registers, spill bytes)}`` from ptxas's ``-v``
    output, each template instance of a kernel named by its ``<D, NWG>``
    arguments (``D=64 NWG=2``; ``NWG=2`` for the block-sparse kernels,
    whose head dim is 64 alone)."""
    found, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            fn = m.group(1)
            args = re.search(r"kernelILi(\d+)ELi(\d+)E", fn)
            one = re.search(r"kernelILi(\d+)EE", fn)
            if args:
                fn = f"D={args.group(1)} NWG={args.group(2)}"
            elif one:
                fn = f"NWG={one.group(1)}"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            regs = found.get(fn, (None, 0))[0]
            found[fn] = (regs, int(m.group(1)) + int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            found[fn] = (int(m.group(1)), found.get(fn, (None, 0))[1])
    return found


def check_builds(builder):
    """Logs each kernel's ptxas registers and spills (the tensor-core
    kernels' by template instance) and each tensor-core kernel's count of
    HGMMA (wgmma) instructions in its SASS: there must be some, and no
    spills."""
    for name, out in builder.build_logs.items():
        for line in out.splitlines():
            if "setmaxnreg" in line or "arning" in line or (
                    name not in WGMMA_SOURCES
                    and ("registers" in line or "spill" in line)):
                log(f"  ptxas {name}: {line.strip()}")
    cuobjdump = os.path.join(os.path.dirname(builder.nvcc_path()),
                             "cuobjdump")
    for name in WGMMA_SOURCES:
        instances = ptxas_instances(builder.build_logs.get(name, ""))
        log(f"  ptxas {name}: " + "; ".join(
            f"{fn} {regs} registers, {spill} bytes spilled"
            for fn, (regs, spill) in sorted(instances.items())))
        sass = subprocess.run(
            [cuobjdump, "-sass", builder.library_path(name)],
            capture_output=True, text=True, check=True, timeout=300).stdout
        hgmma = sum("HGMMA" in line for line in sass.splitlines())
        log(f"  {name}: {hgmma} HGMMA instructions in the SASS")
        if hgmma == 0:
            raise AssertionError(f"{name}: no HGMMA instruction in the SASS")
        spills = [line.strip() for line in
                  builder.build_logs.get(name, "").splitlines()
                  if re.search(r"[1-9]\d* bytes spill (stores|loads)", line)]
        if spills:
            raise AssertionError(f"{name}: ptxas spills: {spills}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "drives the port on an NVIDIA card", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.ops.op_builder import builder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch.cuda.get_device_name(): "
        f"{torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    builder.build(KERNEL_SOURCES)
    log(f"phase 1: built {KERNEL_SOURCES} in "
        f"{time.perf_counter() - t0:.1f} s into {builder.BUILD_DIR}")
    check_builds(builder)

    t0 = time.perf_counter()
    kernel_rows = phase_kernels(args.seed)
    log(f"phase 2: kernels hold against plain versions (bf16, fp32) in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    by_path = {"training": phase_training(args.seed, card)}
    log(f"phase 3: training in {time.perf_counter() - t0:.1f} s")

    model = GPT2LMHeadModel(GPT2Config.gpt2_125m(), seed=args.seed)
    t0 = time.perf_counter()
    warm_up(model, args.seed)
    log(f"warm-up (one serving drain, one generate; untimed, uncounted) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["serving"] = phase_serving(model, args.seed, card)
    log(f"phase 4: serving in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["generate"] = phase_generate(model, args.seed, card)
    log(f"phase 5: generate in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["padded_generate"] = phase_padded_generate(model, args.seed,
                                                       card)
    log(f"phase 5b: padded generate in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["fast_path"] = phase_fast_path(model, args.seed, card)
    log(f"phase 6: serving fast path in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["sampled_serving"], by_path["sampled_generate"] = \
        phase_sampling(model, args.seed, card)
    log(f"phase 7: keyed sampling in {time.perf_counter() - t0:.1f} s")
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    by_path["bert_sparse"], by_path["bert_dense"] = phase_bert(args.seed,
                                                               card)
    log(f"phase 8: BERT-large sparse and dense training in "
        f"{time.perf_counter() - t0:.1f} s")

    log(json.dumps({"kernels": kernel_line(kernel_rows, by_path)}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
