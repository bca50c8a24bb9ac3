"""Where serving time goes on the card, on the serving workload that
``chip_smoke.py`` also drives (GPT-2 125M, bf16, random weights, 8
requests of 8-900 prompt tokens, 32 new tokens each, 4 decode slots,
block size 16).

    python -m deepspeed_tpu_torch.tools.profile_serving [--seed N] [--out F]

The workload is drained once to warm up, once with the prefills and
decode steps timed one by one (host clock after a synchronize; each step
ends in a host sync of its sampled tokens anyway), and once under
``torch.profiler``. Prints one JSON object: the timed run's wall time,
prefill and per-decode-step times, TTFT and tokens/s; the profiled run's
wall time, its device time summed over every kernel and the device's busy
share of that same wall time (the profiler slows the host, so this share
is a lower bound of the unprofiled one); the port's three kernels'
launches and device time; and the top kernels and host-side operators.
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

from deepspeed_tpu_torch import init_serving
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel

# the serving workload (chip_smoke.py serves the same one)
PROMPT_LENS = (8, 40, 100, 230, 400, 555, 720, 900)
MAX_NEW_TOKENS = 32
SERVING = {"block_size": 16, "decode_slots": 4}
OUR_KERNELS = ("flash_fwd_kernel", "decode_append_kernel",
               "decode_paged_kernel")


def serving_prompts(vocab_size, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab_size, n) for n in PROMPT_LENS]


def _device_us(evt):
    return (getattr(evt, "self_device_time_total", None)
            or getattr(evt, "self_cuda_time_total", 0) or 0)


def _kernel_events(prof):
    """Device-side events (kernels, copies, memsets) only: an operator's
    entry repeats the time of the kernels it launched."""
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def run(seed: int):
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
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
    ours = {}
    for e in kernels:
        for k in OUR_KERNELS:
            if k in e.key:
                d = ours.setdefault(k, {"launches": 0, "device_ms": 0.0})
                d["launches"] += e.count
                d["device_ms"] += _device_us(e) / 1e3
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="",
                        help="also write the JSON object to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a card")
    result = run(args.seed)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
