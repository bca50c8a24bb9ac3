#!/usr/bin/env python3
"""Drive the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero and prints no result line:

1. build the three CUDA kernels from ``deepspeed_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once) and print the card;
2. hold each kernel against its plain PyTorch version on the card, at the
   serving path's shapes, in bf16 and fp32, and time kernel, plain
   version and (where one exists) the PyTorch library call computing the
   same function, beside the least time the card could take (bound).
   ``ms``, ``plain_ms`` and ``library_ms`` are device times (CUDA events
   around calls the host queued ahead of the device, see
   :func:`device_ms`); ``wrapper_ms`` is the time of back-to-back wrapper
   calls on CUDA events, which the host's launch rate sets for the
   microsecond decode kernels;
3. serve 8 requests through GPT-2 125M at full width (bf16, random
   weights from ``--seed``) with ``init_serving``, after one untimed
   warm-up pass of phases 3 and 4: every request finishes
   with its tokens, the flash and paged-decode kernels were launched, and
   the first token and first decode-step logits agree with the same
   engine run with the plain versions on the card;
4. ``init_inference(model).generate`` on a 2 x 128 prompt through the
   append-decode kernel, with the same logits check.

Phases 3 and 4 are the two main paths: each sets every launch count to 0
just before it runs and reads the counts just after, before its
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

KERNEL_SOURCES = ("flash_fwd", "decode_append", "decode_paged")
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
# flash at T=1024, append decode at idx=1000 T_q=1, paged decode at T_q=1
MAIN_ROW = {"flash_fwd": 2, "decode_append": 2, "decode_paged": 0}


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
def check_flash(dtype, gen):
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    B, H, D = 1, 12, 64
    rows = []
    for T in (16, 100, 1024):
        q, k, v = (torch.randn((B, H, T, D), generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        o, lse = flash_attention(q, k, v, causal=True)
        ro, rlse = flash_attention_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = compare(f"flash T={T} {dtype}", o, ro, str(dtype)[6:])
        lse_err = (lse - rlse).abs().max().item()
        if lse_err > 1e-3:
            raise AssertionError(f"flash T={T} lse error {lse_err}")
        esize = q.element_size()
        nbytes = 4 * B * H * T * D * esize + B * H * T * 4
        flops = 4 * D * B * H * T * (T + 1) // 2
        rows.append({
            "shape": f"B={B} H={H} T={T} D={D}", "max_abs_err": err,
            **times(lambda: flash_attention(q, k, v),
                    lambda: flash_attention_reference(q, k, v),
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True)),
            "bound_ms": bound_ms(nbytes, flops, str(dtype)[6:]),
            "bound_by": bound_by(nbytes, flops, str(dtype)[6:])})
    return rows


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
        res = {"flash_fwd": check_flash(dtype, gen),
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

    with mock.patch("deepspeed_tpu_torch.ops.attention.flash_attention",
                    fa.flash_attention_reference), \
            mock.patch("deepspeed_tpu_torch.models.gpt2.decode_attention",
                       da.decode_attention_reference), \
            mock.patch("deepspeed_tpu_torch.models.gpt2."
                       "decode_attention_paged",
                       da.decode_attention_paged_reference):
        yield


def kernel_wrappers():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from deepspeed_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_paged)
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention

    return {"flash_fwd": flash_attention, "decode_append": decode_attention,
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

    model = GPT2LMHeadModel(GPT2Config.gpt2_125m(), seed=args.seed)
    t0 = time.perf_counter()
    warm_up(model, args.seed)
    log(f"warm-up (one serving drain, one generate; untimed, uncounted) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path = {"serving": phase_serving(model, args.seed, card)}
    log(f"phase 3: serving in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["generate"] = phase_generate(model, args.seed, card)
    log(f"phase 4: generate in {time.perf_counter() - t0:.1f} s")

    # name: (source, TPU kernel it replaces, the path that needs it;
    # "launches" is that path's count, "launches_by_path" every path's)
    sources = {"flash_fwd": ("deepspeed_tpu_torch/csrc/flash_fwd.cu",
                             "deepspeed_tpu/ops/flash_attention.py:77",
                             "serving"),
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
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
