#!/usr/bin/env python3
"""Drive the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero and prints no result line:

1. build the five CUDA kernels from ``deepspeed_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once) and print the card;
2. hold each kernel against its plain PyTorch version on the card, at the
   serving and training paths' shapes and at ragged ones, in bf16 and
   fp32 — the flash kernels also on ``[B, T, H, D]`` views through
   ``flash_attention_bthd`` — and time kernel, plain version and (where
   one exists) the PyTorch library call computing the same function,
   beside the least time the card could take (bound). ``ms``,
   ``plain_ms`` and ``library_ms`` are device times (CUDA events around
   calls the host queued ahead of the device, see :func:`device_ms`);
   ``wrapper_ms`` is the time of back-to-back wrapper calls on CUDA
   events, which the host's launch rate sets for the microsecond decode
   kernels;
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
   append-decode kernel, with the same logits check.

Phases 3, 4 and 5 are the three main paths: each sets every launch count
to 0 just before it runs and reads the counts just after, before its
comparison run with the plain versions.

The last line is ``{"ok": true, "device": {...}}``; the one before it
the card's name and power limit (``nvidia-smi``), and before that one
JSON object with every kernel's launches on each path, error, times and
bound. Without a card (``torch.cuda.is_available()`` false) it exits 2.
"""

import argparse
import contextlib
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

KERNEL_SOURCES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                  "decode_append", "decode_paged")
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and flop/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
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
# the row of each kernel's checks reported in the {"kernels": ...} line:
# the flash kernels at the training shape (B=16 H=12 T=1024 D=64), append
# decode at idx=1000 T_q=1, paged decode at T_q=1; and the flash kernels'
# training-shape row through the [B, T, H, D] entry
MAIN_ROW = {"flash_fwd": 3, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "decode_append": 2, "decode_paged": 0}
BTHD_ROW = {"flash_fwd": 4, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
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


def bound_ms(nbytes, flops, dtype):
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def bound_by(nbytes, flops, dtype):
    return ("bytes" if nbytes / HBM_BYTES_PER_S
            >= flops / PEAK_FLOPS[dtype] else "operations")


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
# in both layouts, and a ragged [B, T, H, D] case; (B, H, T, layout)
FWD_SHAPES = ((1, 12, 16, "bhtd"), (1, 12, 100, "bhtd"),
              (1, 12, 1024, "bhtd"), (16, 12, 1024, "bhtd"),
              (16, 12, 1024, "bthd"), (2, 12, 100, "bthd"))
# flash backward: the training shape in both layouts (timed), then ragged
# and offset cases and the other head dims; (B, H, Tq, Tk, D, layout,
# causal)
BWD_SHAPES = ((16, 12, 1024, 1024, 64, "bhtd", True),
              (16, 12, 1024, 1024, 64, "bthd", True),
              (2, 12, 100, 100, 64, "bhtd", True),
              (2, 12, 100, 100, 64, "bthd", True),
              (2, 4, 37, 100, 64, "bhtd", True),
              (2, 4, 100, 37, 64, "bhtd", True),
              (2, 4, 64, 100, 64, "bhtd", False),
              (1, 2, 77, 77, 16, "bhtd", True),
              (1, 2, 77, 77, 32, "bthd", True),
              (1, 2, 77, 77, 128, "bhtd", True))


def check_flash(dtype, gen):
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bthd, flash_attention_reference)

    D, dt = 64, str(dtype)[6:]
    rows = []
    for B, H, T, layout in FWD_SHAPES:
        q, k, v = (rand_heads(B, H, T, D, layout, dtype, gen)
                   for _ in range(3))
        name = shape_name(B, H, T, T, D, layout)
        ro, rlse = flash_attention_reference(q, k, v, causal=True)
        if layout == "bthd":  # through the [B, T, H, D] entry
            qb, kb, vb = (t.transpose(1, 2) for t in (q, k, v))

            def kernel():
                return flash_attention_bthd(qb, kb, vb)

            o = kernel().transpose(1, 2)
        else:
            def kernel():
                return flash_attention(q, k, v)

            o, lse = kernel()
            torch.cuda.synchronize()
            lse_err = (lse - rlse).abs().max().item()
            if lse_err > 1e-3:
                raise AssertionError(f"flash {name} lse error {lse_err}")
        torch.cuda.synchronize()
        err = compare(f"flash {name} {dtype}", o, ro, dt)
        nbytes = 4 * B * H * T * D * q.element_size() + B * H * T * 4
        flops = 4 * D * B * H * pairs(T, T, True)
        rows.append({
            "shape": name, "max_abs_err": err,
            **times(kernel, lambda: flash_attention_reference(q, k, v),
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True)),
            "bound_ms": bound_ms(nbytes, flops, dt),
            "bound_by": bound_by(nbytes, flops, dt)})
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
                  "bound_ms": None, "bound_by": None}
        dkv_row = {"shape": name, "max_abs_err": max(errs[1:]),
                   "bound_ms": None, "bound_by": None}
        for row, nbytes, flops in (
                (dq_row, io * (3 * Tq + 2 * Tk) + stats, 6 * D * n_pairs),
                (dkv_row, io * (2 * Tq + 4 * Tk) + stats, 8 * D * n_pairs)):
            row["bound_ms"] = bound_ms(nbytes, flops, dt)
            row["bound_by"] = bound_by(nbytes, flops, dt)
        if Tq == 1024:  # the training shape: time it
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
            del lo
        dq_rows.append(dq_row)
        dkv_rows.append(dkv_row)
    return dq_rows, dkv_rows


def check_append(dtype, gen):
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)

    B, S, H, D = 2, 1024, 12, 64
    rows = []
    for idx, tq in ((0, 1), (255, 1), (1000, 1), (255, 3)):
        kc, vc = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                  .to(dtype) for _ in range(2))
        # rows past the valid prefix hold garbage the kernel must not read
        kc[:, idx + tq:] = 1e4
        vc[:, idx + tq:] = float("nan")
        q = torch.randn((B, tq, H, D), generator=gen, device="cuda").to(dtype)
        index = torch.tensor(idx, dtype=torch.int32, device="cuda")
        got = decode_attention(q, kc, vc, index)
        want = decode_attention_reference(q, kc, vc, index)
        torch.cuda.synchronize()
        err = compare(f"append idx={idx} tq={tq} {dtype}", got, want,
                      str(dtype)[6:])
        keys = idx + tq
        esize = q.element_size()
        nbytes = 2 * B * keys * H * D * esize + 2 * q.numel() * esize + 4
        flops = 4 * D * H * B * sum(idx + r + 1 for r in range(tq))
        pos = torch.arange(S, device="cuda")
        mask = pos[None, :] <= idx + torch.arange(tq, device="cuda")[:, None]
        rows.append({
            "shape": f"B={B} S={S} idx={idx} T_q={tq}", "max_abs_err": err,
            **times(lambda: decode_attention(q, kc, vc, index),
                    lambda: decode_attention_reference(q, kc, vc, index),
                    lambda: F.scaled_dot_product_attention(
                        q.transpose(1, 2), kc.transpose(1, 2),
                        vc.transpose(1, 2), attn_mask=mask)),
            "bound_ms": bound_ms(nbytes, flops, str(dtype)[6:]),
            "bound_by": bound_by(nbytes, flops, str(dtype)[6:])})
    return rows


def check_paged(dtype, gen, rng):
    import torch

    from deepspeed_tpu_torch.ops.decode_attention import (
        GARBAGE_BLOCK, decode_attention_paged,
        decode_attention_paged_reference)

    slots, bs, mb, H, D = 4, 16, 64, 12, 64
    nb = 1 + slots * mb
    lengths = [0, 137, 602, 1000]  # ragged across 0...1000
    rows = []
    for tq in (1, 3):
        kp, vp = (torch.randn((nb, bs, H, D), generator=gen, device="cuda")
                  .to(dtype) for _ in range(2))
        kp[GARBAGE_BLOCK] = 1e4   # the garbage sink never contributes
        vp[GARBAGE_BLOCK] = float("nan")
        tables = np.full((slots, mb), GARBAGE_BLOCK, np.int32)
        free = list(rng.permutation(np.arange(1, nb)))
        for b, ln in enumerate(lengths):
            need = -(-(ln + tq) // bs)
            tables[b, :need] = [free.pop() for _ in range(need)]
        tables = torch.tensor(tables, device="cuda")
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q = torch.randn((slots, tq, H, D), generator=gen,
                        device="cuda").to(dtype)
        got = decode_attention_paged(q, kp, vp, tables, lens)
        want = decode_attention_paged_reference(q, kp, vp, tables, lens)
        torch.cuda.synchronize()
        err = compare(f"paged tq={tq} {dtype}", got, want, str(dtype)[6:])
        esize = q.element_size()
        keys = sum(ln + tq for ln in lengths)
        nbytes = (2 * keys * H * D * esize + 2 * q.numel() * esize
                  + tables.numel() * 4 + slots * 4)
        flops = 4 * D * H * sum(ln + r + 1 for ln in lengths
                                for r in range(tq))
        rows.append({
            "shape": f"slots={slots} bs={bs} MB={mb} lengths={lengths} "
                     f"T_q={tq}", "max_abs_err": err,
            **times(lambda: decode_attention_paged(q, kp, vp, tables, lens),
                    lambda: decode_attention_paged_reference(
                        q, kp, vp, tables, lens)),
            "bound_ms": bound_ms(nbytes, flops, str(dtype)[6:]),
            "bound_by": bound_by(nbytes, flops, str(dtype)[6:])})
    return rows


def phase_kernels(seed):
    """Every kernel against its plain version, bf16 and fp32. Returns
    {kernel: rows} for bf16 (the serving dtype)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dq_rows, dkv_rows = check_flash_bwd(dtype, gen)
        res = {"flash_fwd": check_flash(dtype, gen),
               "flash_bwd_dq": dq_rows, "flash_bwd_dkv": dkv_rows,
               "decode_append": check_append(dtype, gen),
               "decode_paged": check_paged(dtype, gen, rng)}
        for name, rows in res.items():
            for row in rows:
                log(f"kernel {name} {dtype} {json.dumps(row)}")
        if dtype == torch.bfloat16:
            out = res
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

    with mock.patch.object(fa, "_fwd_launch", fa.flash_attention_reference), \
            mock.patch.object(fa, "_dq_launch",
                              fa.flash_attention_backward_dq_reference), \
            mock.patch.object(fa, "_dkv_launch",
                              fa.flash_attention_backward_dkv_reference), \
            mock.patch("deepspeed_tpu_torch.models.gpt2.decode_attention",
                       da.decode_attention_reference), \
            mock.patch("deepspeed_tpu_torch.models.gpt2."
                       "decode_attention_paged",
                       da.decode_attention_paged_reference):
        yield


def kernel_wrappers():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_paged)

    return {"flash_fwd": fa.flash_attention,
            "flash_bwd_dq": fa.flash_attention_backward,
            "flash_bwd_dkv": fa.flash_attention_backward_dkv,
            "decode_append": decode_attention,
            "decode_paged": decode_attention_paged}


def launch_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def serve(srv, prompts, max_new):
    """Serve ``prompts`` through the fresh ServingEngine ``srv``, recording
    the logits of every prefill and decode step. Returns (requests,
    seconds, stats, prefill_logits {rid: row}, first_decode_logits {rid:
    row})."""
    import torch

    prefill_logits, first_decode = {}, {}
    current = {"rid": None}
    sample, prefill = srv._sample, srv._prefill

    def record(logits):
        rows = logits.float().cpu()
        if current["rid"] is not None:
            prefill_logits[current["rid"]] = rows[0]
        else:
            for slot, req in srv.sched.running():
                first_decode.setdefault(req.request_id, rows[slot])
        return sample(logits)

    def prefill_of(slot, req, table, done):
        current["rid"] = req.request_id
        try:
            prefill(slot, req, table, done)
        finally:
            current["rid"] = None

    srv._sample, srv._prefill = record, prefill_of
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [srv.submit(p, max_new_tokens=max_new, request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    srv.drain()
    torch.cuda.synchronize()
    return (reqs, time.perf_counter() - t0, srv.stats(), prefill_logits,
            first_decode)


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
    reqs, secs, stats, pf, fd = serve(srv, prompts, max_new)
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
            init_serving(srv.engine), prompts, max_new)
    agree = sum(a == b for r, q in zip(reqs, ref_reqs)
                for a, b in zip(r.tokens, q.tokens))
    first_agree = 0
    pf_err = fd_err = 0.0
    for r, q in zip(reqs, ref_reqs):
        rid = r.request_id
        pf_err = max(pf_err, check_logits(f"{rid} prefill", pf[rid],
                                          ref_pf[rid]))
        if r.tokens[0] == q.tokens[0]:
            first_agree += 1
            fd_err = max(fd_err, check_logits(f"{rid} first decode",
                                              fd[rid], ref_fd[rid]))
        else:  # a near tie: the plain run's own logits of the two tokens
            z = ref_pf[rid]
            gap = abs(float(z[r.tokens[0]] - z[q.tokens[0]]))
            if gap > LOGITS_ATOL:
                raise AssertionError(f"{rid}: first tokens differ "
                                     f"({r.tokens[0]} vs {q.tokens[0]}) "
                                     f"with logit gap {gap}")
    log(f"serving vs plain versions: first tokens agree {first_agree}/"
        f"{len(reqs)}, all tokens agree {agree}/{len(reqs) * max_new} "
        f"({agree / (len(reqs) * max_new):.3f}), max |logit diff| prefill "
        f"{pf_err:.4g}, first decode {fd_err:.4g} (tolerance "
        f"{LOGITS_ATOL}); plain run took {ref_secs:.3f} s")
    return counts


def run_generate(engine, ids, max_new):
    """engine.generate with every step's logits recorded."""
    from deepspeed_tpu_torch.inference import engine as eng_mod

    calls = []
    sample = eng_mod.sample_logits

    def record(logits, *args, **kwargs):
        calls.append(logits.float().cpu())
        return sample(logits, *args, **kwargs)

    with mock.patch.object(eng_mod, "sample_logits", record):
        out = engine.generate(ids, max_new_tokens=max_new)
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
    for name, out in builder.build_logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

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

    # name: (source, TPU kernel it replaces, the path that needs it;
    # "launches" is that path's count, "launches_by_path" every path's)
    sources = {"flash_fwd": ("deepspeed_tpu_torch/csrc/flash_fwd.cu",
                             "deepspeed_tpu/ops/flash_attention.py:77",
                             "training"),
               "flash_bwd_dq": ("deepspeed_tpu_torch/csrc/flash_bwd_dq.cu",
                                "deepspeed_tpu/ops/flash_attention.py:196",
                                "training"),
               "flash_bwd_dkv": ("deepspeed_tpu_torch/csrc/flash_bwd_dkv.cu",
                                 "deepspeed_tpu/ops/flash_attention.py:252",
                                 "training"),
               "decode_append": ("deepspeed_tpu_torch/csrc/decode_append.cu",
                                 "deepspeed_tpu/ops/decode_attention.py:39",
                                 "generate"),
               "decode_paged": ("deepspeed_tpu_torch/csrc/decode_paged.cu",
                                "deepspeed_tpu/ops/decode_attention.py:194",
                                "serving")}
    kernels = []
    for name, (source, replaces, path) in sources.items():
        row = kernel_rows[name][MAIN_ROW[name]]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": path,
            "launches": by_path[path][name],
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in kernel_rows[name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "wrapper_ms": row["wrapper_ms"], "shape": row["shape"],
            "dtype": "bfloat16"})
        if name in BTHD_ROW:  # the same kernel through the [B, T, H, D] entry
            bthd = kernel_rows[name][BTHD_ROW[name]]
            kernels[-1]["bthd"] = {k: bthd[k] for k in (
                "shape", "ms", "plain_ms", "library_ms", "wrapper_ms",
                "bound_ms")}
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
