"""Where a training step's time goes on the card, on the training workloads
``chip_smoke.py`` also drives, with random weights and tokens from a seed
and the same batch every step, as the bench scripts run them:

- ``--model gpt2-125m`` (default): ``bench.py``'s configuration — GPT-2
  125M at full width, batch 16 x 1024, bf16 compute over fp32 master
  weights, "dots" remat, fused forward+backward+AdamW step (lr 6e-4,
  weight decay 0.1), gradient clipping 1.0, ZeRO stage 0;
- ``--model bert-large-sparse``: ``bench_bert.py``'s configuration (Adam
  lr 1e-4, weight decay 0.01, clip 1.0, bf16, fused step; ZeRO stage 0 on
  one card) on BERT-large (24 layers, hidden 1024, 16 heads, FFN 4096,
  vocab 30522) with a 4096-token position table, "dots" remat and the
  reference's documented ``sparse_attention`` section (fixed, per-head
  layouts with 4 global patterns, 4 local blocks, 1 global block,
  bidirectional) at block 128: micro-batch 2 x 4096, MLM labels on 15 %
  of the tokens (``bench_bert.py:56-59``);
- ``--model bert-large-dense``: the same without the section, at
  ``bench_bert.py``'s 64 x 128 (the non-causal flash kernels).

``--zero-stage K`` runs the workload under ZeRO stage K on an NCCL
process group of one rank (``init_distributed`` over a ``FileStore``):
the stage's reduce-scatters, gathers and copies at world size 1, whose
device time the ``collectives (NCCL)`` and ``concatenation`` families
show.

    python -m deepspeed_tpu_torch.tools.profile_training [--model M]
        [--seed N] [--steps N] [--zero-stage K] [--out F]

Two warm-up steps, then ``--steps`` steps on the host clock (ended by a
synchronize): tokens/s and MFU against the H100's 989 TF/s bf16 dense
peak, with the bench's flops per token (GPT-2: 6N + 6·L·T·C; BERT: 6N +
12·L·C·T·density, the visible keys of a query). Then three steps under
``torch.profiler``: device time summed by kernel family (the port's
attention kernels, GEMMs, the rest), and the device's busy share of the
profiled wall time (the profiler slows the host, so this share is a lower
bound of the unprofiled one), and the host's operators and runtime calls
by their own CPU time. Last, on CUDA events, the dense LM / MLM
head loss (forward and backward) and the optimizer apply each alone.
Prints one JSON object. Needs a card.
"""

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.bert import BertConfig, BertForTraining
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2ForTraining,
                                             cross_entropy_loss, lm_head_loss,
                                             shift_labels)

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
# bench_bert.py:45-55 on one card (ZeRO stage 0)
BERT_CONFIG = {
    "gradient_accumulation_steps": 1,
    "optimizer": {"type": "Adam",
                  "params": {"lr": 1e-4, "weight_decay": 0.01}},
    "gradient_clipping": 1.0,
    "bf16": {"enabled": True},
    "fused_step": True,
    "zero_optimization": {"stage": 0},
    "steps_per_print": 10_000,
}
# the reference's documented "Sparse Attention" example (DeepSpeed
# docs/_pages/config-json.md) with its block raised from 16 to 128, the
# smallest block the kernel path takes (SparseSelfAttention._use_kernel)
BERT_SPARSE = {"mode": "fixed", "block": 128,
               "different_layout_per_head": True, "num_local_blocks": 4,
               "num_global_blocks": 1, "attention": "bidirectional",
               "horizontal_global_attention": False,
               "num_different_global_patterns": 4}
# (micro-batch, sequence): the sparse workload's 8192 tokens a step, as
# bench_bert.py's dense 64 x 128
BERT_SPARSE_SHAPE = (2, 4096)
BERT_DENSE_SHAPE = (64, 128)
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense (NVIDIA data sheet)
# kernel families of the device-time breakdown, by lower-case fragment of
# the kernel name (the first family that matches takes the kernel)
FAMILIES = (
    ("flash forward", ("flash_fwd_kernel", "flash_fwd_sm90_kernel")),
    ("flash dQ", ("flash_bwd_dq_kernel", "flash_bwd_dq_sm90_kernel")),
    ("flash dK/dV", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_sm90_kernel")),
    ("block-sparse forward", ("block_sparse_fwd_kernel",
                              "block_sparse_fwd_sm90_kernel")),
    ("block-sparse dQ", ("block_sparse_bwd_dq_kernel",
                         "block_sparse_bwd_dq_sm90_kernel")),
    ("block-sparse dK/dV", ("block_sparse_bwd_dkv_kernel",
                            "block_sparse_bwd_dkv_sm90_kernel")),
    ("collectives (NCCL)", ("nccl",)),
    ("concatenation", ("catarraybatchedcopy",)),
    ("GEMM", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("optimizer (foreach)", ("multi_tensor_apply", "foreach")),
    ("softmax / cross-entropy", ("softmax", "nll_loss", "cross_entropy")),
    ("layer norm", ("layer_norm", "layernorm", "gammabeta")),
    ("GELU", ("gelu",)),
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


def bert_model(seed, sparse=True, layers=None, **extra):
    """BERT-large MLM at full width (bf16 compute, "dots" remat); the
    sparse workload's 4096-token position table or bench_bert.py's 512;
    ``layers`` cuts the depth (the plain-version comparison); ``extra``:
    other config fields (``dtype``, ``partition_activations``)."""
    cfg = BertConfig.bert_large(**{
        "max_position_embeddings": 4096 if sparse else 512,
        "dtype": torch.bfloat16, "remat": True, "remat_policy": "dots",
        **extra})
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    return BertForTraining(cfg, seed=seed)


def bert_engine(model, sparse=True, device=None):
    batch = (BERT_SPARSE_SHAPE if sparse else BERT_DENSE_SHAPE)[0]
    config = {"train_micro_batch_size_per_gpu": batch, **BERT_CONFIG}
    if sparse:
        config["sparse_attention"] = dict(BERT_SPARSE)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                device=device)
    return engine


def bert_batch(vocab_size, seed, device, sparse=True):
    """bench_bert.py's batch: ids in [4, V), labels on ~15 % of the
    tokens (-100 elsewhere)."""
    batch, seq = BERT_SPARSE_SHAPE if sparse else BERT_DENSE_SHAPE
    rng = np.random.default_rng(seed + 3)
    ids = rng.integers(4, vocab_size, (batch, seq))
    labels = np.where(rng.random((batch, seq)) < 0.15, ids, -100)
    return {"input_ids": torch.from_numpy(ids).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def sparse_density(seq):
    """Share of (query, key) pairs the BERT_SPARSE layout lets attend."""
    from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
        sparsity_config_from_dict)

    return float(sparsity_config_from_dict(BERT_SPARSE, 16)
                 .make_layout(seq).mean())


def bert_flops_per_token(model, seq, density=1.0):
    """bench_bert.py's accounting, 6N + 12·L·T·C, with the attention term
    counted on the visible keys of a query (T·density)."""
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    return (6 * n_params
            + 12 * cfg.num_hidden_layers * seq * density * cfg.hidden_size)


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


def _workload(name, seed, zero_stage=0):
    """(engine, batch, config summary, flops per token, head loss) of a
    workload; the head loss is ``fn(hidden) -> loss`` on the model's real
    labels, for timing the LM / MLM head alone."""
    if name == "gpt2-125m":
        model = bench_model(seed)
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=model, config={**BENCH_CONFIG, "zero_optimization":
                                 {"stage": zero_stage}})
        batch = bench_batch(model.config.vocab_size, seed, engine.device)
        labels = shift_labels(batch["input_ids"])
        wte = model.model.wte

        def head(hidden):
            return lm_head_loss(hidden, wte, labels,
                                dense_budget=3_500_000_000)

        return (engine, batch,
                {"model": "gpt2_125m", "batch": BATCH, "seq": SEQ,
                 **BENCH_CONFIG, "zero_optimization": {"stage": zero_stage}},
                flops_per_token(model), head)
    if zero_stage:
        raise ValueError("--zero-stage runs the gpt2-125m workload")
    sparse = name == "bert-large-sparse"
    model = bert_model(seed, sparse=sparse)
    engine = bert_engine(model, sparse=sparse)
    batch = bert_batch(model.config.vocab_size, seed, engine.device,
                       sparse=sparse)
    mlm = engine.module.model
    shape = BERT_SPARSE_SHAPE if sparse else BERT_DENSE_SHAPE
    density = sparse_density(shape[1]) if sparse else 1.0

    def head(hidden):
        return cross_entropy_loss(mlm.head(hidden), batch["labels"])

    section = {"sparse_attention": BERT_SPARSE} if sparse else {}
    return (engine, batch,
            {"model": name.replace("-", "_"), "batch": shape[0],
             "seq": shape[1], "density": density, **section,
             **BERT_CONFIG},
            bert_flops_per_token(engine.module, shape[1], density), head)


def run(seed: int, steps: int, model: str = "gpt2-125m",
        zero_stage: int = 0):
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    engine, batch, summary, fpt, head_loss = _workload(model, seed,
                                                       zero_stage)
    tokens_per_step = batch["input_ids"].numel()
    warm, _ = timed_steps(engine, batch, 2)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = timed_steps(engine, batch, steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens_per_s = steps * tokens_per_step / secs

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
    # the host's side of the same window: operators and runtime calls by
    # their own CPU time (the profiler's overhead included)
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:15]

    # the dense LM / MLM head (forward + backward) and the optimizer, each
    # alone
    width = engine.module.config
    width = getattr(width, "n_embd", None) or width.hidden_size
    hidden = torch.randn((*batch["input_ids"].shape, width),
                         dtype=torch.bfloat16, device=engine.device,
                         requires_grad=True)
    head_ms = event_ms(lambda: head_loss(hidden).backward())
    grads = [torch.randn_like(p) for p in engine.module.parameters()]

    def apply():
        for p, g in zip(engine.module.parameters(), grads):
            p.grad = g
        if engine._zero is not None:  # as a ZeRO step reduces them
            engine._zero.after_micro_step()
        engine._apply_math()

    optimizer_ms = event_ms(apply)
    return {
        "card": card,
        "config": summary,
        "warmup_losses": warm, "losses": losses,
        "step_ms": 1e3 * secs / steps,
        "tokens_per_s": tokens_per_s,
        "flops_per_token": fpt,
        "mfu": tokens_per_s * fpt / PEAK_BF16_FLOPS,
        "peak_memory_gb": peak_gb,
        "profiled": {
            "step_wall_ms": 1e3 * prof_secs / n_prof,
            "device_kernel_ms_per_step": device_us / 1e3 / n_prof,
            "device_busy_share": device_us / 1e6 / prof_secs,
            "kernel_launches_per_step": sum(e.count for e in kernels)
            / n_prof,
            "device_ms_per_step_by_family": families,
            "top_device_ms_per_step": [
                (e.key[:90], e.count / n_prof, _device_us(e) / 1e3 / n_prof)
                for e in top],
            "top_host_self_ms_per_step": [
                (e.key[:90], e.count / n_prof,
                 e.self_cpu_time_total / 1e3 / n_prof) for e in host]},
        "alone_ms": {"lm_head_loss_fwd_bwd": head_ms,
                     "optimizer_apply": optimizer_ms},
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", default="gpt2-125m",
                        choices=("gpt2-125m", "bert-large-sparse",
                                 "bert-large-dense"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--zero-stage", type=int, default=0,
                        choices=(0, 1, 2, 3))
    parser.add_argument("--out", default="",
                        help="also write the JSON object to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a card")
    if args.zero_stage:
        import os
        import tempfile

        from deepspeed_tpu_torch import comm

        store = os.path.join(tempfile.mkdtemp(prefix="profile_zero"),
                             "store")
        comm.init_distributed(init_method=f"file://{store}", rank=0,
                              world_size=1)
    try:
        line = json.dumps(run(args.seed, args.steps, args.model,
                              args.zero_stage))
    finally:
        if args.zero_stage:
            comm.destroy_process_group()
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
