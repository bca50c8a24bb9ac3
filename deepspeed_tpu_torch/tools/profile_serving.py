"""Where serving time goes on the card, on the serving workloads that
``chip_smoke.py`` also drives (GPT-2 125M, bf16, random weights, 32 new
tokens a request, block size 16).

    python -m deepspeed_tpu_torch.tools.profile_serving [--seed N] [--out F]
    python -m deepspeed_tpu_torch.tools.profile_serving --fast-path [...]

Without ``--fast-path``: 8 requests of 8-900 prompt tokens, 4 decode
slots. The workload is drained once to warm up, once with the prefills
and decode steps timed one by one (host clock after a synchronize; each
step ends in a host sync of its sampled tokens anyway), and once under
``torch.profiler``. Prints one JSON object: the timed run's wall time,
prefill and per-decode-step times, TTFT and tokens/s; the profiled run's
wall time, its device time summed over every kernel and the device's busy
share of that same wall time (the profiler slows the host, so this share
is a lower bound of the unprofiled one); the port's kernels' launches
and device time; and the top kernels and host-side operators.

With ``--fast-path``: ``chip_smoke.py`` phase 6's leg A (:data:`
FAST_SERVING`: prefix cache, 256-token prefill chunks, int8 KV, 8 decode
slots; 8 requests sharing a 384-token system prompt, the first served
alone to fill the cache). Each drain runs on a fresh serving engine (an
empty prefix cache) over one inference engine: one warm-up drain, one
timed on the host clock, one under ``torch.profiler``, whose device time
is also broken down by kernel family (the port's kernels, the GEMMs, the
int8 quantize-on-write elementwise kernels, the pool writes, ...).

Needs a card.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from deepspeed_tpu_torch import init_inference, init_serving
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel

# the serving workload (chip_smoke.py serves the same one)
PROMPT_LENS = (8, 40, 100, 230, 400, 555, 720, 900)
MAX_NEW_TOKENS = 32
SERVING = {"block_size": 16, "decode_slots": 4}
# the serving fast path's workload (chip_smoke.py phase 6, leg A): every
# request shares a SYSTEM_LEN-token system prompt, followed by a tail of
# each FAST_TAILS length; then the first two prompts, extended by
# COW_EXTEND tokens (the first one's inside its partial last block, so
# its admission copies that block on write)
FAST_SERVING = {"block_size": 16, "decode_slots": 8, "prefix_cache": True,
                "prefill_chunk_tokens": 256, "kv_cache_dtype": "int8"}
SYSTEM_LEN = 384
FAST_TAILS = (8, 40, 100, 230, 400, 555)
COW_EXTEND = (3, 5)
# the port's kernels (csrc/*.cu), by kernel name
OUR_KERNELS = ("flash_fwd_sm90_kernel", "flash_fwd_kernel",
               "decode_append_kernel", "decode_paged_kernel",
               "decode_paged_int8_kernel", "decode_paged_int8_sm90_kernel")
# kernel families of the fast path's device-time breakdown, by lower-case
# fragment of the kernel name (the first family that matches takes it)
FAMILIES = (
    ("decode_paged_int8_kernel", ("decode_paged_int8_kernel",)),
    ("decode_paged_int8_sm90_kernel", ("decode_paged_int8_sm90_kernel",)),
    ("decode_paged_kernel", ("decode_paged_kernel",)),
    ("flash_fwd_kernel", ("flash_fwd_kernel", "flash_fwd_sm90_kernel")),
    ("GEMM", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("quantize-on-write (abs, amax, ==, /, where, round, clamp)",
     ("absfunctor", "maxops", "compareeq", "divfunctor", "where_kernel",
      "round", "clamp")),
    ("pool writes (index_copy_)", ("index_copy", "indexcopy")),
    ("layer norm", ("layer_norm", "layernorm")),
    ("casts / copies", ("copy_kernel",)),
)


def serving_prompts(vocab_size, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab_size, n) for n in PROMPT_LENS]


def fast_path_prompts(vocab_size, seed):
    """Leg A's 8 prompts (see :data:`FAST_TAILS`); the first is served
    alone, before the others."""
    rng = np.random.default_rng(seed + 7)
    system = rng.integers(1, vocab_size, SYSTEM_LEN)
    prompts = [np.concatenate([system, rng.integers(1, vocab_size, n)])
               for n in FAST_TAILS]
    return prompts + [np.concatenate([p, rng.integers(1, vocab_size, n)])
                      for p, n in zip(prompts, COW_EXTEND)]


def serve_fast_path(srv, prompts, max_new=MAX_NEW_TOKENS):
    """Leg A's order on the fresh engine ``srv``: the first prompt alone
    (it fills the prefix cache), then the rest at once. Returns the
    requests."""
    reqs = [srv.submit(prompts[0], max_new_tokens=max_new,
                       request_id="f0")]
    srv.drain()
    reqs += [srv.submit(p, max_new_tokens=max_new, request_id=f"f{i}")
             for i, p in enumerate(prompts[1:], 1)]
    srv.drain()
    return reqs


def _device_us(evt):
    return (getattr(evt, "self_device_time_total", None)
            or getattr(evt, "self_cuda_time_total", 0) or 0)


def _kernel_events(prof):
    """Device-side events (kernels, copies, memsets) only: an operator's
    entry repeats the time of the kernels it launched."""
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _port_kernels(kernels):
    ours = {}
    for e in kernels:
        for k in OUR_KERNELS:
            if k in e.key:
                d = ours.setdefault(k, {"launches": 0, "device_ms": 0.0})
                d["launches"] += e.count
                d["device_ms"] += _device_us(e) / 1e3
    return ours


def run(seed: int):
    card = _card()
    model = GPT2LMHeadModel(GPT2Config.gpt2_125m(), seed=seed)
    srv = init_serving(model, serving=SERVING)
    prompts = serving_prompts(model.config.vocab_size, seed)

    def drain():
        for p in prompts:
            srv.submit(p, max_new_tokens=MAX_NEW_TOKENS)
        srv.drain()
        torch.cuda.synchronize()

    drain()  # warm-up: cuBLAS handles, allocator, kernel libraries

    # the timed run: each prefill and decode step on the host clock
    prefill_ms, decode_ms = [], []
    prefill, decode_step = srv._prefill, srv._decode_step

    def timed(fn, out):
        def wrapper(*args):
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return wrapper

    srv._prefill = timed(prefill, prefill_ms)
    srv._decode_step = timed(decode_step, decode_ms)
    srv.reset_stats()
    t0 = time.perf_counter()
    drain()
    timed_s = time.perf_counter() - t0
    warm = srv.stats()
    srv._prefill, srv._decode_step = prefill, decode_step

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drain()
        wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = _kernel_events(prof)
    host_ops = [e for e in events if e.device_type == DeviceType.CPU]
    device_us = sum(_device_us(e) for e in kernels)
    ours = _port_kernels(kernels)
    top_device = sorted(kernels, key=_device_us, reverse=True)[:12]
    top_host = sorted(host_ops, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:12]
    new_tokens = MAX_NEW_TOKENS * len(prompts)
    return {
        "card": card, "requests": len(prompts), "new_tokens": new_tokens,
        "timed_run": {
            "wall_ms": 1e3 * timed_s,
            "prefills": len(prefill_ms),
            "prefill_ms_total": sum(prefill_ms),
            "prefill_ms": prefill_ms,
            "decode_steps": len(decode_ms),
            "decode_ms_total": sum(decode_ms),
            "decode_step_ms_mean": float(np.mean(decode_ms)),
            "decode_step_ms_p50": float(np.percentile(decode_ms, 50)),
            "decode_step_ms_p95": float(np.percentile(decode_ms, 95)),
            "ttft_ms_p50": warm["ttft_ms_p50"],
            "ttft_ms_p95": warm["ttft_ms_p95"],
            "tokens_per_s": new_tokens / timed_s},
        "profiled_run": {
            "wall_ms": 1e3 * wall_s,
            "device_kernel_ms": device_us / 1e3,
            "device_busy_share": device_us / 1e6 / wall_s,
            "kernel_launches": sum(e.count for e in kernels),
            "port_kernels": ours,
            "top_device_ms": [(e.key[:80], e.count, _device_us(e) / 1e3)
                              for e in top_device],
            "top_host_self_ms": [(e.key[:80], e.count,
                                  e.self_cpu_time_total / 1e3)
                                 for e in top_host]},
    }


def run_fast_path(seed: int):
    """Leg A's workload: warm-up, timed and profiled drains, each on a
    fresh serving engine over one inference engine."""
    card = _card()
    model = GPT2LMHeadModel(GPT2Config.gpt2_125m(), seed=seed)
    engine = init_inference(model, serving=FAST_SERVING)
    prompts = fast_path_prompts(model.config.vocab_size, seed)

    def drain():
        srv = init_serving(engine)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = serve_fast_path(srv, prompts)
        torch.cuda.synchronize()
        return srv, reqs, time.perf_counter() - t0

    drain()  # warm-up: cuBLAS handles, allocator, kernel libraries
    srv, reqs, timed_s = drain()
    stats = srv.stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall_s = drain()
    kernels = _kernel_events(prof)
    device_us = sum(_device_us(e) for e in kernels)
    families = {name: {"launches": 0, "device_ms": 0.0}
                for name, _ in FAMILIES}
    families["other"] = {"launches": 0, "device_ms": 0.0}
    for e in kernels:
        name = next((n for n, frags in FAMILIES
                     if any(f in e.key.lower() for f in frags)), "other")
        families[name]["launches"] += e.count
        families[name]["device_ms"] += _device_us(e) / 1e3
    top_device = sorted(kernels, key=_device_us, reverse=True)[:15]
    new_tokens = sum(len(r.tokens) for r in reqs)
    return {
        "card": card, "serving": FAST_SERVING, "requests": len(prompts),
        "prompt_lens": [len(p) for p in prompts], "new_tokens": new_tokens,
        "timed_run": {
            "wall_ms": 1e3 * timed_s,
            "decode_steps": stats["decode_steps"],
            "ttft_ms_p50": stats["ttft_ms_p50"],
            "ttft_ms_p95": stats["ttft_ms_p95"],
            "prefix_hit_tokens": [r.prefix_hit_tokens for r in reqs],
            "prefill_chunks": [r.prefill_chunks for r in reqs],
            "cow": [r.cow is not None for r in reqs],
            "tokens_per_s": new_tokens / timed_s},
        "profiled_run": {
            "wall_ms": 1e3 * wall_s,
            "device_kernel_ms": device_us / 1e3,
            "device_busy_share": device_us / 1e6 / wall_s,
            "kernel_launches": sum(e.count for e in kernels),
            "families": families,
            "port_kernels": _port_kernels(kernels),
            "top_device_ms": [(e.key[:100], e.count, _device_us(e) / 1e3)
                              for e in top_device]},
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--fast-path", action="store_true",
                        help="profile chip_smoke.py phase 6's leg A (prefix "
                             "cache, chunked prefill, int8 KV)")
    parser.add_argument("--out", default="",
                        help="also write the JSON object to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a card")
    result = run_fast_path(args.seed) if args.fast_path else run(args.seed)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
