"""Where a training step's time goes on the card, on the training workload
``chip_smoke.py`` also drives: ``bench.py``'s configuration — GPT-2 125M
at full width, batch 16 x 1024, bf16 compute over fp32 master weights,
"dots" remat, fused forward+backward+AdamW step (lr 6e-4, weight decay
0.1), gradient clipping 1.0, ZeRO stage 0 — with random weights and
tokens from a seed, the same batch every step as ``bench.py`` does.

    python -m deepspeed_tpu_torch.tools.profile_training [--seed N]
        [--steps N] [--out F]

Two warm-up steps, then ``--steps`` steps on the host clock (ended by a
synchronize): tokens/s and MFU against the H100's 989 TF/s bf16 dense
peak, with ``bench.py``'s flops per token (6N + 6·L·T·C). Then three steps
under ``torch.profiler``: device time summed by kernel family (the port's
three flash kernels, GEMMs, the rest), and the device's busy share of the
profiled wall time (the profiler slows the host, so this share is a lower
bound of the unprofiled one). Last, on CUDA events, the dense LM-head
loss (forward and backward) and the optimizer apply each alone. Prints
one JSON object. Needs a card.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2ForTraining,
                                             lm_head_loss, shift_labels)

BATCH, SEQ = 16, 1024
# bench.py:122-134 on one card
BENCH_CONFIG = {
    "train_micro_batch_size_per_gpu": BATCH,
    "gradient_accumulation_steps": 1,
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 6e-4, "weight_decay": 0.1}},
    "gradient_clipping": 1.0,
    "bf16": {"enabled": True},
    "fused_step": True,
    "zero_optimization": {"stage": 0},
    "steps_per_print": 10_000,
}
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense (NVIDIA data sheet)
# kernel families of the device-time breakdown, by lower-case fragment of
# the kernel name (the first family that matches takes the kernel)
FAMILIES = (
    ("flash forward", ("flash_fwd_kernel",)),
    ("flash dQ", ("flash_bwd_dq_kernel",)),
    ("flash dK/dV", ("flash_bwd_dkv_kernel",)),
    ("GEMM", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("optimizer (foreach)", ("multi_tensor_apply", "foreach")),
    ("softmax / cross-entropy", ("softmax", "nll_loss", "cross_entropy")),
    ("layer norm", ("layer_norm", "layernorm", "gammabeta")),
    ("casts / copies", ("copy_kernel",)),
)


def bench_model(seed):
    return GPT2ForTraining(GPT2Config.gpt2_125m(remat=True,
                                                remat_policy="dots"),
                           seed=seed)


def bench_engine(model, device=None):
    engine, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                config=BENCH_CONFIG,
                                                device=device)
    return engine


def bench_batch(vocab_size, seed, device):
    rng = np.random.default_rng(seed + 2)
    ids = rng.integers(0, vocab_size, (BATCH, SEQ))
    return {"input_ids": torch.from_numpy(ids).to(device)}


def flops_per_token(model):
    """bench.py's accounting: 6N matmul flops (forward + backward) plus
    causal attention, 6·L·T·C."""
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    return 6 * n_params + 6 * cfg.n_layer * SEQ * cfg.n_embd


def train_steps(engine, batch, n):
    """``n`` steps through the engine's public seams; returns the loss
    tensors (no host sync)."""
    losses = []
    for _ in range(n):
        loss = engine(batch)
        engine.backward(loss)
        engine.step()
        losses.append(loss)
    return losses


def timed_steps(engine, batch, n):
    """``(losses, seconds)`` of ``n`` steps, synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = train_steps(engine, batch, n)
    torch.cuda.synchronize()
    return [float(x) for x in losses], time.perf_counter() - t0


def _device_us(evt):
    return (getattr(evt, "self_device_time_total", None)
            or getattr(evt, "self_cuda_time_total", 0) or 0)


def event_ms(fn, repeats=5):
    """Mean ms of ``fn()`` on CUDA events, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def run(seed: int, steps: int):
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    model = bench_model(seed)
    engine = bench_engine(model)
    batch = bench_batch(model.config.vocab_size, seed, engine.device)
    warm, _ = timed_steps(engine, batch, 2)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = timed_steps(engine, batch, steps)
    tokens_per_s = steps * BATCH * SEQ / secs
    fpt = flops_per_token(model)

    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_secs = timed_steps(engine, batch, n_prof)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_us = sum(_device_us(e) for e in kernels)
    families = {name: 0.0 for name, _ in FAMILIES}
    families["other"] = 0.0
    for e in kernels:
        name = next((n for n, frags in FAMILIES
                     if any(f in e.key.lower() for f in frags)), "other")
        families[name] += _device_us(e) / 1e3 / n_prof
    top = sorted(kernels, key=_device_us, reverse=True)[:15]

    # the dense LM head (forward + backward) and the optimizer, each alone
    hidden = torch.randn((BATCH, SEQ, model.config.n_embd),
                         dtype=model.config.dtype, device=engine.device,
                         requires_grad=True)
    labels = shift_labels(batch["input_ids"])
    wte = model.model.wte

    def head():
        lm_head_loss(hidden, wte, labels,
                     dense_budget=3_500_000_000).backward()

    head_ms = event_ms(head)
    grads = [torch.randn_like(p) for p in engine._params]

    def apply():
        for p, g in zip(engine._params, grads):
            p.grad = g
        engine._apply_math()

    optimizer_ms = event_ms(apply)
    return {
        "card": card,
        "config": {"model": "gpt2_125m", "batch": BATCH, "seq": SEQ,
                   **BENCH_CONFIG},
        "warmup_losses": warm, "losses": losses,
        "step_ms": 1e3 * secs / steps,
        "tokens_per_s": tokens_per_s,
        "flops_per_token": fpt,
        "mfu": tokens_per_s * fpt / PEAK_BF16_FLOPS,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profiled": {
            "step_wall_ms": 1e3 * prof_secs / n_prof,
            "device_kernel_ms_per_step": device_us / 1e3 / n_prof,
            "device_busy_share": device_us / 1e6 / prof_secs,
            "kernel_launches_per_step": sum(e.count for e in kernels)
            / n_prof,
            "device_ms_per_step_by_family": families,
            "top_device_ms_per_step": [
                (e.key[:90], e.count / n_prof, _device_us(e) / 1e3 / n_prof)
                for e in top]},
        "alone_ms": {"lm_head_loss_fwd_bwd": head_ms,
                     "optimizer_apply": optimizer_ms},
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--out", default="",
                        help="also write the JSON object to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a card")
    line = json.dumps(run(args.seed, args.steps))
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
