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
   the flash forward, append, paged and int8 paged kernels also at
   tensor-parallel serving's 6 heads a rank (GPT-2 125M at tp=2, phase
   9: generate's 2 x 128 prefill and a 1024-token one on views cut from
   the fused QKV projection, generate's idx 128 / 159 steps, serving's
   and leg A's decode steps, leg A's first and last chunks) — and
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
   then ("zero", 3b) the same model, seed and batch under ZeRO stages 1,
   2 and 3 through ``initialize`` on an NCCL process group of one rank
   (``init_distributed`` over a ``FileStore``; no gloo and no group-less
   fallback): per stage the step-1 gradients as the stage reduces and
   gathers them within 1e-4 relative L2 of phase 3's, one warm-up and 5
   timed steps whose losses are within 1e-3 of phase 3's first six
   (printed with whether they are bit-equal), 12 launches of each flash
   kernel a step, the all-gather, reduce-scatter and all-reduce calls a
   step equal to the stage's plan (``ZeroPartition.comm_plan``), and at
   stage 3 no gathered weight left on a module after the steps and a
   peak memory at most phase 3's plus the gathered weights of the root
   unit (embeddings, final norm) and of one block; ms/step,
   peak memory and the counts are printed with the card's line;
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
   MFU) through the non-causal flash kernels;
9. "tensor_parallel": GPT-2 125M (bf16, weights from ``--seed``) at
   ``tensor_parallel={"tp_size": 2}``: 2 spawned ranks on ``cuda:0``,
   joined through a ``FileStore`` on an explicit gloo group (NCCL refuses
   two ranks on one device; gloo carries CUDA tensors through the host),
   each calling ``init_inference`` / ``init_serving`` with the same
   arguments: ``generate`` on phase 5's 2 x 128 prompt (32 new), phase
   4's requests, and leg A's stream on 4 requests. Both ranks' tokens
   bit for bit equal; tokens equal to this process's tp=1 run of the same
   workloads until its two best scores lie within 0.05, each step's
   logits within 0.05 of tp=1's while the tokens before it agree; every
   launch of kernels 1, 7, 8 and 9 at 6 heads (kernel 9 from both
   sources); 24 all-reduces a forward and no all-gather (vocab 50257
   does not split); each rank's split weights and pools half of tp=1's
   bytes. The ms of a decode step per rank is
   printed for information: host-staged gloo, nothing of NCCL's speed;
10. "tp_training": GPT-2 125M (bf16, dots remat, fused AdamW, clip 1.0,
   weights from ``--seed``) trained through ``initialize(config={"mesh":
   {"tp": 2}})`` on 2 spawned gloo ranks on ``cuda:0``, micro-batch 4 x
   1024, three engines: ZeRO stage 0, stage 3, and stage 0 with
   ``partition_activations``; each one's step-1 gradients (merged whole
   from the ranks' slices), one warm-up and 3 timed steps. Both ranks'
   losses and replicated parameters bit-equal; stage 0's losses within
   0.05 of a tp=1 engine's on the same seed and batch (run first, in this
   process) and its step-1 gradients within 5 % relative L2 a tensor;
   stage 3 within 1e-3 (losses) and 1e-4 (gradients) of stage 0;
   ``partition_activations`` bit-equal to stage 0; collectives a step
   equal to the plan (``ZeroPartition.comm_plan`` plus
   ``GPT2ForTraining.comm_plan``); 12 launches a step of each flash
   kernel, every one at 6 heads; no dO copied for TMA; the split weights
   half of tp=1's bytes a rank. Phase 2 holds kernels 1-3 at this shape
   (B=4 H=6, q, k and v cut from one fused projection, dO as the
   row-parallel projection hands it back) and at tp=4's one head a rank
   (B=2 H=1 T=64 D=16). ms a step and peak memory a rank are printed for
   information: host-staged gloo;
11. "fleet" (run after phase 7, on its model): the serving fleet through
   ``init_serving`` on GPT-2 125M (bf16, phase 4's serving block with a
   ``sampling`` block): (a) phase 4's 8 requests and one keyed request
   through a ``ReplicaRouter`` of 2 replicas: the greedy tokens equal
   phase 4's single engine's, every replica serves; (b) the same stream
   with replica 1 a ``ChaosReplica(crash_at_step=6)``: every client's
   stream equals (a)'s, each position delivered once,
   ``replay_divergence`` 0, some replayed positions swallowed; (c)
   ``serving.migration`` on, ``migrate_work(1)`` after 4 steps on bf16
   and on int8 pools: the moved requests finish with (a)'s tokens (int8:
   an unmigrated run's) and kernel 1 launches 0 times from the move to
   the end; the wire bytes a block (int8 / bf16 = (64 + 4) / 128) and
   export + import ms of one sequence at 4, 16 and 63 blocks are
   printed; then ``crash_during_migration=1`` falls back to one replay;
   (d) a ``FleetManager`` scales up through the default factory and
   down (drain, park), tokens unchanged, the peak memory of 3 replicas
   printed; (e) the gateway on loopback (``127.0.0.1``, port 0) with two
   tenants: SSE tokens equal (a)'s, 401 without a key, 429 over a quota;
   TTFT over HTTP against a direct submit printed for information. One
   card steps the replicas in turn: nothing here is fleet scaling.
12. "llama" (run last): the Llama family at Llama-2 7B's width, weights
   drawn on the card from ``--seed``, bf16. (a) ``init_inference`` on
   Llama-2 7B at full depth (6.7 B parameters): one greedy ``generate``
   of 32 tokens a prompt of 128 / 256 / 512 / 1024 tokens (B = 1; kernel
   1 at each prefill, kernel 7 at every decode step at D = 128 over a
   4096-position cache), prefill ms and decode tokens/s, peak memory;
   (b) the same at 8 KV heads (GQA), depth cut to 4, then the four
   prompts left-padded into one batch (kernel 7 with each row's first
   key), and the device ms of one decode step's KV-head repeat of a [4,
   4096, 8, 128] cache beside kernel 7's; (c) ``initialize(
   LlamaForTraining)`` at 7B width, depth cut to 4, micro-batch 4 x
   1024, bench.py's keys with "dots" remat, at ZeRO stage 0 and then
   stage 3 on an NCCL group of one rank: step-1 gradients, one warm-up
   and 3 timed steps (ms a step, tokens/s, MFU, peak memory), 4 launches
   of each flash kernel a step, stage 3's collectives equal to its plan,
   its losses within 0.05 and step-1 gradients within 5 % of stage 0's;
   (d) ``tensor_parallel={"tp_size": 2}`` on 2 spawned gloo ranks of
   ``cuda:0`` at 7B width, depth cut to 2: ``generate`` of 16 tokens,
   both ranks bit-equal, kernels 1 and 7 at 16 heads on every launch,
   2 L + 1 all-reduces and one all-gather a forward (the vocabulary
   splits); (e) (c)'s trained weights at 2 layers written as an HF
   directory in bf16 (``save_hf_llama``) and read by ``from_pretrained``:
   logits bit for bit the source model's; the directory is deleted. At
   this width bf16 rounding alone parts two correct paths by more than
   LOGITS_ATOL, so (a), (b) and (d) teacher-force the reference path
   (the plain versions, or tp=1) and an fp32 forward on the same weights
   on each path's own tokens and hold every step's logits to the fp32
   forward within LLAMA_NOISE_RATIO times the reference's distance at
   that step, and each token to fp32's best where its two best scores
   lie at least twice that distance apart; (a) and (b) then plant faults
   in the decode steps (the D=64 softmax scale; query heads on the wrong
   KV heads) that this gate must refuse. Phase 2 holds kernels 1-3 at
   B=4 H=32 T=1024 D=128 and kernel 7 at B=4 S=4096 D=128, idx=1000 and,
   with first keys, the padded batch's first step, timed beside SDPA.
13. "bert_tp" (run after phase 10): BERT-large at its published widths
   (hidden 1024, 16 heads of 64, FFN 4096, vocab 30522, 4096 positions;
   bf16, dots remat, bench_bert.py's keys, weights from ``--seed``)
   through ``initialize(config={"mesh": {"tp": 2}, "tensor_parallel":
   {...}})`` on 2 spawned gloo ranks on ``cuda:0``, 8 heads a rank:
   (a) phase 8's sparse workload (block 128, 2 x 4096, 24 layers, the
   ``"bert"`` policy: q/k/v, ``intermediate`` column- and
   ``output_dense``, ``output`` row-parallel, the vocabulary split):
   losses within 0.05 and step-1 gradients (merged from the slices)
   within 5 % relative L2 a tensor of a tp=1 engine on the same seed and
   batch (run first, here), or, past that, no further from an fp32
   forward's gradient (through the plain versions) than twice tp=1's
   distance (bf16 noise alone parts two correct paths by more than 5 % on
   the deep layers' query biases), kernels 10-12 once a layer a step, no
   flash;
   (b) ZeRO 3 with ``partition_activations`` at 4 layers, within 1e-3
   (losses) and 1e-4 (gradients) of (a)'s stage 0 at 4 layers; (c) phase
   8's dense 64 x 128 leg at 4 layers under ``"auto"`` (split heads
   gathered before a whole ``output_dense``, the MLP whole), held to its
   tp=1 leg, kernels 1-3 non-causal once a layer a step; (d)
   ``eval_batch`` on (a)'s engine: a no-grad forward's loss bit for bit,
   parameters unchanged; (e) two tp faults planted in (a)'s step-1
   gradients (no f before q/k/v; the decoder bias's gradient left as the
   rank's slice), each of which (a)'s gradient gate must refuse. Both
   ranks' losses and replicated parameters
   bit-equal, every attention launch at 8 heads, collectives a step equal
   to the plan (``ZeroPartition.comm_plan`` plus ``BertForTraining.
   comm_plan``), the split weights half of tp=1's bytes. Key biases are
   held as in phase 8 (their exact gradient is zero). Phase 2 holds
   kernels 10-12 on rank 1's 8-head rows of the 2 x 16 x 4096 layout and
   kernels 1-3 at B=64 H=8 T=128 non-causal. ms a step and peak memory a
   rank are printed for information: host-staged gloo.

14. "dp_generate" and "group_replicas" (run after phase 12): [7e] on
   GPT-2 125M at its published widths (bf16, 12 layers, 6 heads a rank),
   4 spawned gloo ranks on ``cuda:0``: (a) ``init_inference(
   tensor_parallel={"tp_size": 2})`` on the world of 4 builds data=2 x
   tp=2; ``generate`` of 32 tokens for 8 prompts of 128 tokens, for 7 of
   them (a batch that does not divide over data) and keyed for the 8:
   tokens equal to a tp=1 run's (here, first) up to a near tie, the whole
   tokens on every rank and bit-equal across ranks, kernels 1 and 7 at 6
   heads on a rank's 4 rows only, as many launches as tp=1's; (b) two
   tp=2 replicas (the data groups) behind ``init_serving(replicas=
   [engine])``, rank 0 the controller: phase 11's 9 requests (tokens
   equal to a one-process engine's up to a near tie), replica 1 crashing
   mid-decode (failover replay, replay_divergence 0, the streams
   unchanged, replica 1 dead), a drain migrating live sequences on bf16
   and int8 pools as one chunk a rank (0 kernel-1 launches on the
   target's rank 0, tokens of the unmigrated run, wire bytes int8 : bf16
   = 0.53125), kernels 8 and 9 at 6 heads on every rank; prints ms per
   generated token a rank, requests a second through the router, export
   + import ms at 4 and 16 blocks and the peak memory a rank, all over
   host-staged gloo.
15. "telemetry_serving" (after phase 11, on its model) and
   "telemetry_training" (last): (b) phase 4's serving engine behind a
   one-replica router with ``telemetry`` (tracing, ``metrics_file``):
   phase 4's tokens, each ``request.finish``'s TTFT and queue wait the
   records ``stats()`` reads, the request / serve / queue / prefill /
   decode spans of every request, a ``.prom`` that parses; (a) phase
   3's engine at ZeRO 1 on an NCCL world of one with ``telemetry`` (a
   2-step ``torch.profiler`` window, tracing), ``wall_clock_breakdown``,
   ``memory_breakdown``, ``comms_logger`` and ``csv_monitor``: one
   ``step`` span a step with ``fwd_bwd`` and ``optimizer``, a memory event
   a step, ``step_cost`` FLOPs within 1 % of 6N + 6·L·T·C, kernel-build
   ``compile`` events, an exposed-comm reading naming its source,
   kernels 1-3 in the window's Chrome trace; the same engine with
   telemetry off: its launches a step the same, its step ms printed
   beside phase 3's.
16. "checkpoint_resume" and "handoff" (after phase 3b): checkpoints and
   resilience on GPT-2 125M at bench.py's keys, in a temporary directory
   removed at the end (a tag holds ~1.5 GB; at most 3 live at once):
   (a) engine A takes 3 steps, saves with integrity on (save and load
   seconds, bytes, the manifest's sha256 ms printed), takes 3 more; a
   fresh engine B loads ``latest`` and takes the same 3 steps: its losses
   A's bit for bit, kernels 1-3 12 times a step (the
   ``checkpoint_resume`` window); the key's advance over 10,000 micro
   steps timed; (b) a save at ZeRO 3 on an NCCL world of one loads at
   ZeRO 0: the Adam step and whole slots as loaded bit-equal to the
   saved ones, the next 3 losses within ZERO_LOSS_ATOL of the ZeRO 3
   run's, the parameters after them within 2 lr a step; (c) the sentinel's rollback after a batch poisoned by
   ``chaos.nan_batches`` restores the saved weights bit for bit, the next
   loss is finite, the fault events are in the telemetry sink; (d) a
   corrupted newest tag falls back to the previous verified one, naming
   the file, and an explicit load of it raises; (e) the hang watchdog
   (abort off, 1 s) fires on a stall inside a step and the flight
   recorder's dump holds the event tail; ``dump_state`` and the
   resilience summary keys are JAX's; (f) ``init_inference(checkpoint=
   <A's tag dir>)`` generates 32 greedy tokens equal to those of an
   engine on A's weights at the save (the ``handoff`` window: kernels 1
   and 7).

Phases 3, 3b, 4, 5, 5b, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15 and 16 are
the main paths (6, 7 and 8 in two legs each, 3b one window a stage, 10
one an engine and 13 one a leg, summed; 9's, 10's, 13's and 14's launch
counts are rank 0's, zeroed in the rank before each window; 11 one window
over its five parts; 12 one window each of its ``llama_*`` paths; 14 one
window a leg; 15 one window a leg, (a) the telemetry-on engine's; 16 one
window for B's steps and one for the handoff's generate):
each sets every launch count to 0 just before it runs and reads the counts
just after, before its comparison runs.

The last line is ``{"ok": true, "device": {...}}``; the one before it
the card's name and power limit (``nvidia-smi``), and before that one
JSON object with the 13 rows of the kernel table (TPU kernels 1-13; no
path calls kernel 13, the quantizer, so its launches are 0) and row 7's
padded case (``decode_append_padded``: its launches with a first key):
each one's launches on each path (``tensor_parallel`` among them), error,
times and bound.
Without a card (``torch.cuda.is_available()`` false) it exits 2.
"""

import argparse
import collections
import contextlib
import dataclasses
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
# the paged checks at tensor-parallel serving's shapes (phase 9): GPT-2
# 125M's 12 heads over 2 ranks, 6 a rank; serving's decode step, leg A's
# decode step, its first chunk and its partial last one
TP_HEADS = 6
# tensor-parallel training (phase 10): GPT-2 125M at tp=2 on micro-batches
# of TPT_BATCH x 1024 tokens, a size the two ranks' gloo all-reduces
# (staged through the host) finish in seconds a step
TPT_BATCH = 4
# the Llama-2 7B shapes of phase 2 (phase 12's training micro-batch and a
# batch of as many decode rows)
LLAMA_BATCH = 4
TP_PAGED_CASES = (([0, 137, 602, 1000], 1),
                  ([408, 440, 500, 630, 800, 955, 411, 445], 1),
                  ([0], 256), ([256], 136))
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
    (what :func:`flash_attention_bthd` hands the kernels), and for
    ``qkv`` the same view of the first third of a fused ``[B, T, 3 H D]``
    projection output (a column-parallel ``c_attn``'s, under tp)."""
    import torch

    if layout == "qkv":
        fused = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda")
        return fused.to(dtype)[..., :h * d].view(b, t, h, d).transpose(1, 2)
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
# second warpgroup of each CTA has no row), tensor-parallel serving's
# prefills at 6 heads a rank (phase 9: generate's 2 x 128 and a 1024-token
# serving bucket, on views cut from the fused projection), tensor-parallel
# training's on such views (bench.py's B=16 and phase 10's B=TPT_BATCH),
# Llama-2 7B's prefill and training forward (phase 12: B=LLAMA_BATCH, 32
# heads of 128 on [B, T, H, D] views), BERT's dense leg at tp=2 (phase
# 13: 8 heads a rank) and BERT's dense leg last (bench_bert.py: B=64
# T=128, 16 heads, non-causal); (B, H, Tq, Tk, D, layout, causal)
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
              (2, 6, 128, 128, 64, "qkv", True),
              (1, 6, 1024, 1024, 64, "qkv", True),
              (16, 6, 1024, 1024, 64, "qkv", True),
              (TPT_BATCH, 6, 1024, 1024, 64, "qkv", True),
              (2, 1, 64, 64, 16, "qkv", True),
              (LLAMA_BATCH, 32, 1024, 1024, 128, "bthd", True),
              (64, 8, 128, 128, 64, "bthd", False),
              (64, 16, 128, 128, 64, "bthd", False))
# the flash shapes that are timed: GPT-2 training's, tensor-parallel
# training's (6 heads a rank at bench.py's micro-batch of 16, and at
# phase 10's), Llama-2 7B's (phase 12: 32 heads of 128 on [B, T, H, D]
# views at its training micro-batch), BERT's dense leg at tp=2 (phase
# 13: 8 heads a rank) and BERT's dense leg
TIMED_FLASH = ((16, 12, 1024), (16, 6, 1024), (TPT_BATCH, 6, 1024),
               (LLAMA_BATCH, 32, 1024), (64, 8, 128), (64, 16, 128))
# flash backward: the training shape in both layouts (timed), then ragged
# and offset cases, B=1 at T=1024 (64 rows a CTA on the tensor cores),
# the other head dims (D=128 over several tiles with 128 rows a CTA), a
# short causal case, tensor-parallel training's (timed: 6 heads a rank at
# bench.py's B=16 and phase 10's B=TPT_BATCH; 1 head a rank at tp=4),
# Llama-2 7B's training shape (timed: phase 12's micro-batch, 32 heads of
# 128), BERT's dense leg at tp=2 (timed: phase 13, 8 heads a rank) and
# BERT's dense leg last (timed); (B, H, Tq, Tk, D, layout, causal)
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
              (16, 6, 1024, 1024, 64, "tp", True),
              (TPT_BATCH, 6, 1024, 1024, 64, "tp", True),
              (2, 1, 64, 64, 16, "tp", True),
              (LLAMA_BATCH, 32, 1024, 1024, 128, "bthd", True),
              (64, 8, 128, 128, 64, "bthd", False),
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
        if layout != "bhtd":  # through the [B, T, H, D] entry
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
    each kernel once; ``tp`` cases (tensor-parallel training's shapes) cut
    q, k and v from one ``[B, T, 3 H D]`` projection, whose gradient the
    kernels write, and take dO as the row-parallel ``c_proj`` hands it
    back (a contiguous ``[B, T, H, D]``). Returns (dq rows, dkv rows);
    only the training shapes are timed (SDPA's backward, dQ/dK/dV
    together, as the library yardstick of both)."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa

    dt = str(dtype)[6:]
    dq_rows, dkv_rows = [], []
    for B, H, Tq, Tk, D, layout, causal in BWD_SHAPES:
        name = shape_name(B, H, Tq, Tk, D, layout, causal)
        if layout == "tp":
            fused = (torch.randn((B, Tq, 3 * H * D), generator=gen,
                                 device="cuda").to(dtype).requires_grad_())
            q, k, v = (t.detach().view(B, Tq, H, D).transpose(1, 2)
                       for t in fused.split(H * D, dim=-1))
            do = rand_heads(B, H, Tq, D, "bthd", dtype, gen)
        else:
            q = rand_heads(B, H, Tq, D, layout, dtype, gen)
            k, v = (rand_heads(B, H, Tk, D, layout, dtype, gen)
                    for _ in range(2))
            do = rand_heads(B, H, Tq, D, layout, dtype, gen)
        if layout != "bhtd":  # the whole autograd path through the entry
            if layout == "tp":
                leaves = [t.view(B, Tq, H, D)
                          for t in fused.split(H * D, dim=-1)]
            else:
                leaves = [t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v)]
            before = launch_counts()
            o = fa.flash_attention_bthd(*leaves, causal=causal)
            o.backward(do.transpose(1, 2))
            if layout == "tp":
                got = [g.view(B, Tq, H, D).transpose(1, 2)
                       for g in fused.grad.split(H * D, dim=-1)]
            else:
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
# warpgroup instances (64 rows a CTA; 128 at blocks of 128 and 256); the
# BERT slice's layout at tp=2 (phase 13) is tp rank 1's 8 heads, rows
# [8, 16) of the 16-head layout
SPARSE_CASES = (
    (2, 16, 4096, "BERT_SPARSE"),
    (2, 8, 4096, "BERT_SPARSE_TP1"),
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
    shared SparseSelfAttention draws it (bidirectional); "BERT_SPARSE_TP1"
    is tp rank 1's ``heads`` rows of the layout drawn at twice as many."""
    from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
        sparsity_config_from_dict)
    from deepspeed_tpu_torch.tools.profile_training import BERT_SPARSE

    if section == "BERT_SPARSE_TP1":
        return np.ascontiguousarray(
            sparse_layout("BERT_SPARSE", 2 * heads, seq)[heads:])
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
# last steps (a 128-token prompt, 32 new tokens: idx 128 and 159), and
# the same two steps at tensor-parallel generate's 6 heads a rank, and
# Llama-2 7B's (phase 12: 32 heads of 128, a 4096-position cache) at idx
# 1000
APPEND_CASES = ((2, 12, 64, 1024, 0, 1), (2, 12, 64, 1024, 255, 1),
                (2, 12, 64, 1024, 1000, 1), (2, 12, 64, 1024, 255, 3),
                (2, 12, 64, 1024, 1019, 5), (1, 12, 64, 1024, 1000, 1),
                (2, 12, 128, 1024, 1000, 1), (2, 12, 64, 1024, 511, 1),
                (2, 12, 64, 1024, 46, 1), (2, 12, 64, 1024, 128, 1),
                (2, 12, 64, 1024, 159, 1), (2, TP_HEADS, 64, 1024, 128, 1),
                (2, TP_HEADS, 64, 1024, 159, 1),
                (LLAMA_BATCH, 32, 128, 4096, 1000, 1))


# the append kernel with a per-row first key (left-padded generate()):
# (B, H, D, S, idx, T_q, pads). idx 1000 with pads 0 / 37 / 500 / 1000,
# so the last row sees its last key alone (T_q = 1) or its 4 query rows 1-4
# keys (T_q = 4); then the padded-generate phase's first decode step (4
# prompts of 128 / 100 / 37 / 1 tokens left-padded to 128); then Llama-2
# 7B's (32 heads of 128, a 4096-position cache) at idx 1000, and phase
# 12's padded batch's first decode step (prompts of 128 / 256 / 512 /
# 1024 tokens left-padded to 1024)
APPEND_PAD_CASES = ((4, 12, 64, 1024, 1000, 1, (0, 37, 500, 1000)),
                    (4, 12, 64, 1024, 1000, 4, (0, 37, 500, 1000)),
                    (4, 12, 64, 1024, 128, 1, (0, 28, 91, 127)),
                    (LLAMA_BATCH, 32, 128, 4096, 1000, 1, (0, 128, 512, 896)),
                    (LLAMA_BATCH, 32, 128, 4096, 1024, 1,
                     (896, 768, 512, 0)))


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
    """The paged kernel against its plain version at PAGED_CASES (12
    heads) and TP_PAGED_CASES (TP_HEADS): over
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
    bs, mb, D = 16, 64, 64
    dt, name = str(dtype)[6:], "paged int8" if int8 else "paged"
    rows = []
    for H, (lengths, tq) in ([(12, c) for c in PAGED_CASES]
                             + [(TP_HEADS, c) for c in TP_PAGED_CASES]):
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
        shape = (f"slots={len(lengths)} H={H} bs={bs} MB={mb} "
                 f"lengths={lengths} T_q={tq}")
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
            mock.patch.object(da, "_append_launch",
                              da.decode_attention_reference), \
            mock.patch.object(da, "_paged_launch",
                              da.decode_attention_paged_reference), \
            mock.patch.object(da, "_paged_int8_launch",
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


def record_steps(srv):
    """Wrap the fresh ServingEngine ``srv``'s sampling to record, for each
    request, the logits behind every token it samples: ``{rid: [rows]}``,
    filled as ``srv`` serves; entry 0 the prefill's (the whole-prompt
    call, or the final chunk) as one row ``[1, V]``, then each decode
    step's one row, or a verify step's k + 1 rows."""
    steps = {}
    current = {"rid": None}
    sample, prefill, chunk = srv._sample, srv._prefill, srv._chunk_call

    def record(logits):
        rows = logits.float().cpu()
        if current["rid"] is not None:
            steps.setdefault(current["rid"], []).append(rows[:1])
        else:
            rows = rows.reshape(srv.config.decode_slots, -1, rows.shape[-1])
            for slot, req in srv.sched.running():
                if slot not in srv._prefilling:
                    steps.setdefault(req.request_id, []).append(rows[slot])
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
    return steps


def serve(srv, run):
    """Serve through the fresh ServingEngine ``srv`` (``run(srv)`` submits
    and drains, returning the requests), recording the logits of every
    prefill and of each request's first decode step
    (:func:`record_steps`). Returns (requests, seconds, stats,
    prefill_logits {rid: row}, first_decode_logits {rid: rows}): a decode
    step's one row, or a verify step's k + 1 rows."""
    import torch

    steps = record_steps(srv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = run(srv)
    torch.cuda.synchronize()
    return (reqs, time.perf_counter() - t0, srv.stats(),
            {rid: s[0][0] for rid, s in steps.items()},
            {rid: s[1] for rid, s in steps.items() if len(s) > 1})


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
    """The serving path; returns its launch counts and each request's
    tokens."""
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
    return counts, [r.tokens for r in reqs]


def run_generate(engine, ids, max_new, forced=None, **kwargs):
    """engine.generate with every step's logits recorded (the greedy and
    the keyed sampler's alike); with ``forced`` (``[B, max_new]`` tokens)
    each step takes those tokens in place of the sampler's (teacher
    forcing on another path's tokens)."""
    from deepspeed_tpu_torch.inference import engine as eng_mod

    calls = []
    sample, keyed = eng_mod.sample_logits, eng_mod.keyed_sample

    def record(fn):
        def call(logits, *args, **kw):
            calls.append(logits.float().cpu())
            token = fn(logits, *args, **kw)
            if forced is not None:
                token = forced[:, len(calls) - 1].to(token)
            return token
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


def agree_until_tie(what, got, want, want_calls, prompt_len, knobs=None,
                    tie=LOGITS_ATOL):
    """Hold ``got``'s new tokens to ``want``'s (one row each) up to the
    first step where ``want``'s own two best scores lie within ``tie``
    (LOGITS_ATOL by default): there another rounding may pick the other
    token, and the streams may part. Returns (tokens agreeing, steps
    held)."""
    held = len(want)
    for t in range(len(want)):
        if top2_gap(want_calls[t][0], knobs, prompt_len + t) < tie:
            held = t
            break
        if got[t] != want[t]:
            raise AssertionError(f"{what}: token {t} is {got[t]}, the solo "
                                 f"run's {want[t]} (top-2 gap above "
                                 f"{tie})")
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
    int8_kernel = gpt2_mod.decode_attention_paged_int8_tp

    def spy(q, *args, **kwargs):
        rows_seen.append(q.shape[1])
        return int8_kernel(q, *args, **kwargs)

    srv = init_serving(int8)
    with mock.patch.object(gpt2_mod, "decode_attention_paged_int8_tp", spy):
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
    the training path's launch counts, and what phase 3b holds the ZeRO
    stages to: the losses, the step-1 gradients (on the host) and the
    peak memory of the timed steps."""
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
    reference = {"losses": losses, "peak_bytes":
                 torch.cuda.max_memory_allocated(),
                 "grads": {n: g.cpu() for n, g in kernel_grads.items()}}
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
    return counts, reference


# phase 3b: ZeRO stages 1-3 at world size 1 over NCCL; each stage's
# losses within ZERO_LOSS_ATOL of phase 3's (the same math on the same
# card: only the flash kernels' summation order may differ between two
# runs), step-1 gradients within ZERO_GRAD_RTOL relative L2 of phase 3's
ZERO_STAGES = (1, 2, 3)
ZERO_STEPS = 5
ZERO_LOSS_ATOL = 1e-3
ZERO_GRAD_RTOL = 1e-4


def phase_zero(seed, card, reference):
    """The training path under ZeRO: ``init_distributed`` starts an NCCL
    process group of one rank (a ``FileStore`` rendezvous), then, per
    stage 1, 2 and 3, ``deepspeed_tpu_torch.initialize`` builds phase 3's
    GPT-2 125M from its seed with bench.py's configuration and the stage,
    and runs its step-1 gradients (backward, reduced and gathered by the
    stage), one warm-up and ZERO_STEPS timed steps (launch and collective
    counts zeroed just before, read just after). Each stage's losses and
    gradients are held to phase 3's, its flash launches a step to phase
    3's, its collectives a step to the stage's plan, and stage 3's peak
    memory to phase 3's plus the gathered weights of the root unit and of
    one block. Returns the launch counts summed over the stages."""
    import tempfile

    import torch
    import torch.distributed as tdist

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.tools.profile_training import (
        BENCH_CONFIG, bench_batch, bench_model, timed_steps)

    store = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_zero"),
                         "store")
    comm.init_distributed(init_method=f"file://{store}", rank=0,
                          world_size=1, verbose=False)
    total = collections.Counter()
    try:
        if tdist.get_backend() != "nccl":
            raise AssertionError(f"zero: process group backend "
                                 f"{tdist.get_backend()}, not nccl")
        for stage in ZERO_STAGES:
            config = {**BENCH_CONFIG, "zero_optimization": {"stage": stage}}
            engine = deepspeed_tpu_torch.initialize(
                model=bench_model(seed), config=config)[0]
            n_layer = engine.module.config.n_layer
            batch = bench_batch(engine.module.config.vocab_size, seed,
                                engine.device)
            engine.module(batch).backward()
            grads = engine.gathered_grads()
            grad_err = {}
            for name, ref in reference["grads"].items():
                ref = ref.to(engine.device).float()
                grad_err[name] = ((grads[name].float() - ref).norm()
                                  / ref.norm().clamp_min(1e-30)).item()
            del grads
            engine.zero_grad()
            first, _ = timed_steps(engine, batch, 1)
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            comm.reset_counts()
            losses, secs = timed_steps(engine, batch, ZERO_STEPS)
            counts = launch_counts()
            collectives = {k: comm.counts.get(k, 0) for k in
                           ("all_gather", "reduce_scatter", "all_reduce")}
            peak = torch.cuda.max_memory_allocated()
            losses = first + losses
            plan = {k: v * ZERO_STEPS for k, v in engine._zero.comm_plan(
                1, recompute=engine.module.config.remat).items()}
            want = reference["losses"][:len(losses)]
            loss_err = max(abs(a - b) for a, b in zip(losses, want))
            worst = max(grad_err, key=grad_err.get)
            what = f"zero stage {stage}"
            if loss_err > ZERO_LOSS_ATOL:
                raise AssertionError(f"{what}: losses {losses} vs phase 3's "
                                     f"{want} (max diff {loss_err})")
            if grad_err[worst] > ZERO_GRAD_RTOL:
                raise AssertionError(f"{what}: step-1 gradient {worst} "
                                     f"relative L2 {grad_err[worst]} (limit "
                                     f"{ZERO_GRAD_RTOL})")
            check_per_step(what, counts, ZERO_STEPS,
                           {"flash_fwd": n_layer, "flash_bwd_dq": n_layer,
                            "flash_bwd_dkv": n_layer})
            if collectives != plan:
                raise AssertionError(f"{what}: collectives {collectives} in "
                                     f"{ZERO_STEPS} steps, the plan "
                                     f"{plan}")
            stale = [e.name for es in engine._zero.unit_entries.values()
                     for e in es for sub, attr in e.owners
                     if attr in sub.__dict__]
            if stale:
                raise AssertionError(f"{what}: gathered weights outlive the "
                                     f"step: {stale[:4]}")
            units = {u: sum(4 * int(np.prod(e.pplan.shape)) for e in es)
                     for u, es in engine._zero.unit_entries.items()}
            budget = (units.get(engine.module, 0)
                      + max((b for u, b in units.items()
                             if u is not engine.module), default=0))
            over = peak - reference["peak_bytes"]
            if stage == 3 and over > budget:
                raise AssertionError(
                    f"{what}: peak memory {peak / 1e9:.3f} GB is "
                    f"{over / 1e9:.3f} GB above phase 3's, more than the "
                    f"root unit's and one block's gathered weights "
                    f"({budget / 1e9:.3f} GB)")
            log(f"zero stage {stage}: NCCL, world size 1; {ZERO_STEPS} "
                f"steps in {secs:.3f} s ({1e3 * secs / ZERO_STEPS:.1f} "
                f"ms/step), peak memory {peak / 1e9:.3f} GB (phase 3: "
                f"{reference['peak_bytes'] / 1e9:.3f} GB; stage-3 budget "
                f"+{budget / 1e9:.3f} GB); losses "
                f"{[round(x, 4) for x in losses]}, max |diff| vs phase 3 "
                f"{loss_err:.3g} (bit-equal: {losses == want}); step-1 "
                f"gradients relative L2 max {grad_err[worst]:.3g} at "
                f"{worst}; collectives per step "
                f"{ {k: v / ZERO_STEPS for k, v in collectives.items()} } "
                f"= the plan; launches per step flash_fwd "
                f"{counts['flash_fwd'] / ZERO_STEPS}, flash_bwd_dq "
                f"{counts['flash_bwd_dq'] / ZERO_STEPS}, flash_bwd_dkv "
                f"{counts['flash_bwd_dkv'] / ZERO_STEPS} [{card}]")
            total.update(counts)
            reference.setdefault("zero_ms", {})[stage] = \
                1e3 * secs / ZERO_STEPS
            del engine
            torch.cuda.empty_cache()
    finally:
        comm.destroy_process_group()
    return dict(total)


# phase 16: checkpoints and resilience on phase 3's workload
CKPT_STEPS = 3
CKPT_NEW = 32
WD_TIMEOUT = 1.0
# micro steps of a long run, over which the key's advance at a save is
# timed
RNG_SPLITS = 10_000
WD_STALL = 2.5
RESILIENCE_SUMMARY_KEYS = ["enabled", "faults", "rollbacks",
                           "sentinel_trips", "watchdog_fired"]


def ckpt_model(seed):
    """Phase 3's GPT-2 125M whose loss is scaled by the batch's float
    ``loss_weight`` (1.0; a data leaf ``chaos.nan_batches`` can poison)."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2ForTraining

    class WeightedGPT2(GPT2ForTraining):
        def forward(self, batch):
            return super().forward(batch) * batch["loss_weight"].mean()

    return WeightedGPT2(GPT2Config.gpt2_125m(remat=True,
                                             remat_policy="dots"), seed=seed)


def ckpt_engine(seed, **extra):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.tools.profile_training import BENCH_CONFIG

    return deepspeed_tpu_torch.initialize(
        model=ckpt_model(seed), config={**BENCH_CONFIG, **extra})[0]


def ckpt_batches(engine, seed, n):
    import torch

    from deepspeed_tpu_torch.tools.profile_training import bench_batch

    return [{**bench_batch(engine.module.config.vocab_size, seed + 10 + i,
                           engine.device),
             "loss_weight": torch.ones(1, device=engine.device)}
            for i in range(n)]


def tag_bytes(tag_dir):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(tag_dir) for f in fs)


def timed_save(engine, save_dir, tag):
    """``save_checkpoint`` timed; the manifest's sha256 (inside the
    commit) timed apart. Returns ``(seconds, hash seconds, bytes)``."""
    import torch

    from deepspeed_tpu_torch.runtime.resilience import integrity

    hashed = []
    real = integrity.build_manifest

    def build_manifest(tag_dir):
        t = time.perf_counter()
        out = real(tag_dir)
        hashed.append(time.perf_counter() - t)
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(integrity, "build_manifest", build_manifest):
        engine.save_checkpoint(save_dir, tag=tag)
    secs = time.perf_counter() - t0
    return secs, sum(hashed), tag_bytes(os.path.join(save_dir, tag))


ADAM_SLOTS = ("exp_avg", "exp_avg_sq")


def whole_adam_state(engine):
    """The engine's Adam ``step`` and whole slots, copied to the host."""
    opt = engine._opt_state
    return {"step": int(opt.step),
            **{k: {n: v.clone() for n, v in
                   engine._whole_slots(getattr(opt, k)).items()}
               for k in ADAM_SLOTS}}


def ckpt_steps(engine, batches):
    import torch

    out = []
    for b in batches:
        loss = engine(b)
        engine.backward(loss)
        engine.step()
        out.append(loss)
    torch.cuda.synchronize()
    return [float(x) for x in out]


def phase_checkpoint(seed, card):
    """Phase 16 (module docstring); returns the ``checkpoint_resume`` and
    ``handoff`` launch counts."""
    import shutil
    import tempfile

    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.runtime.engine import advance_key
    from deepspeed_tpu_torch.runtime.resilience import chaos
    from deepspeed_tpu_torch.runtime.resilience.integrity import \
        CheckpointCorruptionError
    from deepspeed_tpu_torch.telemetry import flightrec
    from deepspeed_tpu_torch.tools.profile_training import BENCH_CONFIG

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt")
    integrity_on = {"enabled": True, "sentinel": {"enabled": False},
                    "watchdog": {"enabled": False}}
    try:
        # (a) resume
        save_dir = os.path.join(root, "resume")
        a = ckpt_engine(seed, resilience=integrity_on)
        n_layer = a.module.config.n_layer
        batches = ckpt_batches(a, seed, 2 * CKPT_STEPS)
        first = ckpt_steps(a, batches[:CKPT_STEPS])
        save_s, hash_s, nbytes = timed_save(a, save_dir, "a3")
        saved = {k: v.clone() for k, v in a.module_state_dict().items()}
        want = ckpt_steps(a, batches[CKPT_STEPS:])
        del a
        torch.cuda.empty_cache()
        b = ckpt_engine(seed + 1, resilience=integrity_on)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tag, _ = b.load_checkpoint(save_dir)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if tag != "a3" or b.global_steps != CKPT_STEPS:
            raise AssertionError(f"checkpoint: loaded {tag!r} at step "
                                 f"{b.global_steps}")
        reset_launch_counts()
        got = ckpt_steps(b, batches[CKPT_STEPS:])
        resume_counts = launch_counts()
        check_per_step("checkpoint resume", resume_counts, CKPT_STEPS,
                       {"flash_fwd": n_layer, "flash_bwd_dq": n_layer,
                        "flash_bwd_dkv": n_layer})
        if got != want:
            raise AssertionError(f"checkpoint resume: losses {got} are not "
                                 f"bit-equal to the uninterrupted run's "
                                 f"{want}")
        t0 = time.perf_counter()
        advance_key(np.zeros(2, np.uint32), RNG_SPLITS)
        rng_ms = 1e3 * (time.perf_counter() - t0)
        log(f"checkpoint (a) resume: GPT-2 125M, bench keys; steps 1-3 "
            f"losses {[round(x, 4) for x in first]}; save of step 3 "
            f"{save_s:.3f} s for {nbytes} bytes ({nbytes / save_s / 1e9:.3f}"
            f" GB/s; the manifest's sha256 {1e3 * hash_s:.1f} ms of it), "
            f"load {load_s:.3f} s (verify included); the key's advance "
            f"over {RNG_SPLITS} micro steps (paid at a save) {rng_ms:.1f} "
            f"ms; steps 4-6 resumed {got} bit-equal to uninterrupted "
            f"{want}; launches per "
            f"step flash_fwd {resume_counts['flash_fwd'] / CKPT_STEPS}, "
            f"flash_bwd_dq {resume_counts['flash_bwd_dq'] / CKPT_STEPS}, "
            f"flash_bwd_dkv {resume_counts['flash_bwd_dkv'] / CKPT_STEPS} "
            f"[{card}]")

        # (d) fallback: B saves step 6; its bytes are corrupted
        timed_save(b, save_dir, "a6")
        bad = chaos.corrupt_checkpoint(os.path.join(save_dir, "a6"))
        tag, _ = b.load_checkpoint(save_dir)
        fault = b.resilience.fault_tail[-1]
        if (tag != "a3" or fault["name"] != "ckpt.fallback"
                or os.path.basename(bad) not in fault["error"]):
            raise AssertionError(f"checkpoint fallback: loaded {tag!r}, "
                                 f"last fault {fault}")
        try:
            b.load_checkpoint(save_dir, tag="a6")
        except CheckpointCorruptionError as e:
            explicit = str(e)
        else:
            raise AssertionError("checkpoint fallback: the explicit corrupt "
                                 "tag loaded")
        log(f"checkpoint (d) fallback: {os.path.basename(bad)} of a6 "
            f"corrupted; latest resumed a3 (fault {fault['name']}: "
            f"{fault['error'][:120]}...); explicit a6 raised: "
            f"{explicit[:120]}...")
        del b
        torch.cuda.empty_cache()

        # (f) the handoff: A's tag dir served directly
        model = GPT2LMHeadModel(GPT2Config.gpt2_125m(), device="meta")
        model.load_state_dict({k[len("model."):]: v
                               for k, v in saved.items()}, assign=True)
        ref_engine = deepspeed_tpu_torch.init_inference(model)
        ids = generate_ids(ref_engine, seed)
        ref = ref_engine.generate(ids, max_new_tokens=CKPT_NEW)
        del model, saved, ref_engine
        served = deepspeed_tpu_torch.init_inference(
            GPT2LMHeadModel(GPT2Config.gpt2_125m(), device="meta"),
            checkpoint=os.path.join(save_dir, "a3"))
        reset_launch_counts()
        out = served.generate(ids, max_new_tokens=CKPT_NEW)
        torch.cuda.synchronize()
        handoff_counts = launch_counts()
        if not torch.equal(out, ref):
            raise AssertionError("checkpoint handoff: tokens differ from "
                                 "an engine on A's weights")
        want_k = {"flash_fwd": n_layer,
                  "decode_append": n_layer * (CKPT_NEW - 1)}
        for name, n in want_k.items():
            if handoff_counts[name] != n:
                raise AssertionError(f"checkpoint handoff: {name} launched "
                                     f"{handoff_counts[name]} times, not "
                                     f"{n}")
        log(f"checkpoint (f) handoff: init_inference(checkpoint=<a3>) "
            f"greedy {CKPT_NEW} tokens x {ids.shape[0]} rows equal to "
            f"A's weights' run; launches flash_fwd "
            f"{handoff_counts['flash_fwd']}, decode_append "
            f"{handoff_counts['decode_append']} [{card}]")
        del served, out, ref
        shutil.rmtree(save_dir)
        torch.cuda.empty_cache()

        # (b) ZeRO 3 -> ZeRO 0: 2 steps and a save, then CKPT_STEPS more
        # on each side; the Adam state as loaded against the saved one
        zero_dir = os.path.join(root, "zero")
        store = os.path.join(root, "store")
        comm.init_distributed(init_method=f"file://{store}", rank=0,
                              world_size=1, verbose=False)
        try:
            z3 = ckpt_engine(seed, zero_optimization={"stage": 3})
            zb = ckpt_batches(z3, seed, 2 + CKPT_STEPS)
            ckpt_steps(z3, zb[:2])
            z3.save_checkpoint(zero_dir)
            saved_adam = whole_adam_state(z3)
            want = ckpt_steps(z3, zb[2:])
            want_params = {k: v.cpu() for k, v in
                           z3.module_state_dict().items()}
            del z3
        finally:
            comm.destroy_process_group()
        torch.cuda.empty_cache()
        z0 = ckpt_engine(seed + 1)
        z0.load_checkpoint(zero_dir)
        loaded_adam = whole_adam_state(z0)
        same_adam = loaded_adam["step"] == saved_adam["step"] and all(
            torch.equal(loaded_adam[k][n], v) for k in ADAM_SLOTS
            for n, v in saved_adam[k].items())
        got = ckpt_steps(z0, zb[2:])
        loss_err = max(abs(x - y) for x, y in zip(got, want))
        got_params = z0.module_state_dict()
        param_err = max((got_params[k].cpu() - v).abs().max().item()
                        for k, v in want_params.items())
        lr = BENCH_CONFIG["optimizer"]["params"]["lr"]
        if (not same_adam or loss_err > ZERO_LOSS_ATOL
                or param_err > 2 * lr * CKPT_STEPS):
            raise AssertionError(
                f"checkpoint ZeRO 3 -> 0: Adam state as loaded equal to the "
                f"saved {same_adam}; losses {got} vs {want}; parameters' "
                f"max |diff| {param_err} (limit {2 * lr * CKPT_STEPS})")
        log(f"checkpoint (b) ZeRO 3 (NCCL, world 1) -> ZeRO 0: Adam step "
            f"{loaded_adam['step']} and slots as loaded bit-equal to the "
            f"saved; steps 3-{2 + CKPT_STEPS} losses {got} vs {want} (max "
            f"|diff| {loss_err:.3g}, limit {ZERO_LOSS_ATOL}); parameters "
            f"after them max |diff| {param_err:.3g} (limit 2 lr steps = "
            f"{2 * lr * CKPT_STEPS:.3g}) [{card}]")
        del z0, saved_adam, loaded_adam, want_params, got_params
        shutil.rmtree(zero_dir)
        torch.cuda.empty_cache()

        # (c) rollback
        tel_dir = os.path.join(root, "telemetry")
        r = ckpt_engine(seed, resilience={
            "enabled": True, "watchdog": {"enabled": False},
            "sentinel": {"policy": "rollback", "sync_lag": 0}},
            telemetry={"enabled": True, "dir": tel_dir,
                       "compile_watchdog": False, "hlo_cost": False})
        rb = ckpt_batches(r, seed, 4)
        ckpt_steps(r, rb[:2])
        r.save_checkpoint(os.path.join(root, "rollback"))
        saved = {k: v.clone() for k, v in r.module_state_dict().items()}
        poisoned = list(chaos.nan_batches(rb[2:3], at=0))[0]
        bad_loss = ckpt_steps(r, [poisoned])[0]
        restored = r.module_state_dict()
        same = all(torch.equal(restored[k], v) for k, v in saved.items())
        after = ckpt_steps(r, rb[3:])[0]
        r.telemetry.flush()
        faults = [e["name"] for e in read_jsonl(tel_dir)
                  if e["kind"] == "fault"]
        if not (np.isnan(bad_loss) and same and np.isfinite(after)
                and r.global_steps == 3
                and faults[-2:] == ["sentinel.trip", "sentinel.rollback"]):
            raise AssertionError(f"checkpoint rollback: poisoned loss "
                                 f"{bad_loss}, weights restored {same}, next "
                                 f"loss {after}, step {r.global_steps}, "
                                 f"faults {faults}")
        log(f"checkpoint (c) rollback: poisoned step loss {bad_loss}; the "
            f"weights equal the saved bytes; next loss {after}; faults in "
            f"the sink {faults}")
        r.destroy()
        del r, saved, restored
        shutil.rmtree(os.path.join(root, "rollback"))
        torch.cuda.empty_cache()

        # (e) the watchdog and the flight recorder
        dump_dir = os.path.join(root, "dumps")
        w = ckpt_engine(seed, dump_state=True, resilience={
            "enabled": True, "sentinel": {"enabled": False},
            "watchdog": {"timeout_secs": WD_TIMEOUT, "abort": False,
                         "dump_dir": dump_dir}},
            telemetry={"enabled": True, "dir": tel_dir + "-w",
                       "compile_watchdog": False, "hlo_cost": False,
                       "flight_recorder": {"enabled": True,
                                           "dump_dir": dump_dir,
                                           "on_sigterm": False}})
        wb = ckpt_batches(w, seed, 2)
        ckpt_steps(w, wb[:1])
        forward = w.module.forward

        def stalled(batch):
            chaos.simulate_stall(WD_STALL)
            return forward(batch)

        w.module.forward = stalled
        ckpt_steps(w, wb[1:])
        del w.module.forward
        dumps = flightrec.find_dumps(dump_dir)
        texts = [f for f in os.listdir(dump_dir)
                 if f.startswith("watchdog_dump_")]
        tail = flightrec.load_dump(dumps[0])["events"] if dumps else []
        summary = w.resilience.summary()
        if not (w.resilience.watchdog.fired and texts and tail
                and tail[-1]["name"] == "watchdog.hang"
                and w.dump_state() is True
                and sorted(summary) == RESILIENCE_SUMMARY_KEYS):
            raise AssertionError(f"checkpoint watchdog: fired "
                                 f"{w.resilience.watchdog.fired}, dumps "
                                 f"{dumps} {texts}, tail {tail[-3:]}")
        log(f"checkpoint (e) watchdog: {WD_STALL} s stall inside a step "
            f"fired it at {WD_TIMEOUT} s (abort off): {texts[0]}, flight "
            f"recorder dump of {len(tail)} events ending "
            f"{[e['name'] for e in tail[-3:]]}; dump_state() "
            f"{w.dump_state()}, summary keys {sorted(summary)}")
        w.destroy()
        del w
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return resume_counts, handoff_counts


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


# ---------------------------------------------------------------------------
# phase 9: tensor-parallel inference and serving
# ---------------------------------------------------------------------------
TP_SIZE = 2
TP_NEW = 32
TP_FAST_REQUESTS = 4
# the ranks' hard limit: a hung collective fails the phase instead of the
# whole run
TP_TIMEOUT = 600


def tp_workloads(seed, vocab):
    """Phase 9's two serving streams, each ``(label, serving section,
    run)`` (``run(srv)`` submits and drains, returning the requests):
    phase 4's requests, and leg A's stream on its first
    TP_FAST_REQUESTS prompts."""
    from deepspeed_tpu_torch.tools.profile_serving import (
        FAST_SERVING, MAX_NEW_TOKENS, SERVING, fast_path_prompts,
        serve_fast_path, serving_prompts)

    prompts = serving_prompts(vocab, seed)
    fast = fast_path_prompts(vocab, seed)[:TP_FAST_REQUESTS]
    return (("serving", SERVING, submit_all(prompts, MAX_NEW_TOKENS)),
            ("fast_path", FAST_SERVING,
             lambda srv: serve_fast_path(srv, fast, MAX_NEW_TOKENS)))


def run_tp_workloads(model, seed, engine_kw):
    """generate() on phase 5's 2 x 128 prompt (TP_NEW new tokens), then
    the serving and fast-path streams of :func:`tp_workloads`, each on a
    fresh engine built with ``engine_kw``. Returns {workload: result}:
    per row or request its tokens, prompt length, every step's logits,
    and the pools' bytes; for generate also the host ms of a decode step and the
    bytes of the weights tp splits (this engine's, and the whole
    tensors' in its dtype)."""
    import torch

    from deepspeed_tpu_torch import init_inference, init_serving

    out = {}
    engine = init_inference(model, **engine_kw)
    ids = generate_ids(engine, seed)
    run_generate(engine, ids, 2)  # warm-up: uncounted in the timing
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_generate(engine, ids, 1)
    t1 = time.perf_counter()
    tokens, calls = run_generate(engine, ids, TP_NEW)
    t2 = time.perf_counter()
    T = ids.shape[1]
    split = {n for n, spec in engine.param_shardings.items()
             if spec is not None}
    esize = next(engine.module.parameters()).element_size()
    out["generate"] = {
        "tokens": [row[T:].tolist() for row in tokens],
        "prompt_lens": [T] * len(tokens),
        "steps": [[c[b:b + 1] for c in calls] for b in range(len(tokens))],
        "decode_step_ms": 1e3 * ((t2 - t1) - (t1 - t0)) / (TP_NEW - 1),
        "split_params": len(split),
        "split_bytes": (
            sum(p.numel() * p.element_size()
                for n, p in engine.module.named_parameters() if n in split),
            sum(p.numel() * esize for n, p in model.named_parameters()
                if n in split))}
    for label, section, run in tp_workloads(seed, model.config.vocab_size):
        srv = init_serving(init_inference(model, serving=section,
                                          **engine_kw))
        steps = record_steps(srv)
        reqs = run(srv)
        for r in reqs:
            if r.state != "finished":
                raise AssertionError(f"tensor parallel {label} "
                                     f"{r.request_id}: {r.state} "
                                     f"({r.finish_reason})")
        out[label] = {
            "tokens": [list(r.tokens) for r in reqs],
            "prompt_lens": [r.prompt_len for r in reqs],
            "steps": [steps[r.request_id] for r in reqs],
            "pool_bytes": pool_bytes(srv), "stats": srv.stats()}
    return out


def tp_rank_main(rank, world, store, seed, out_dir):
    """One tp rank of phase 9 (a spawned process): join the gloo group on
    ``cuda:0``, build GPT-2 125M from ``seed`` on the host, and run
    :func:`run_tp_workloads` at ``tensor_parallel.tp_size = world``;
    writes its launch and collective counts, the heads of every launch of
    kernels 1, 7, 8 and 9, its weight bytes and its results."""
    import pickle
    import traceback

    try:
        # both ranks on the one card
        os.environ["LOCAL_RANK"] = "0"
        import torch
        import torch.distributed as tdist

        from deepspeed_tpu_torch import comm
        from deepspeed_tpu_torch.models import gpt2 as gpt2_mod
        from deepspeed_tpu_torch.ops import decode_attention as da
        from deepspeed_tpu_torch.ops import flash_attention as fa

        torch.backends.cuda.matmul.allow_tf32 = False
        comm.init_distributed(dist_backend="gloo",
                              init_method=f"file://{store}", rank=rank,
                              world_size=world, timeout=TP_TIMEOUT,
                              verbose=False)
        backend = tdist.get_backend()
        if backend != "gloo":
            raise AssertionError(f"tp ranks on backend {backend}, not gloo")
        model = gpt2_mod.GPT2LMHeadModel(gpt2_mod.GPT2Config.gpt2_125m(),
                                         seed=seed)
        heads = collections.defaultdict(collections.Counter)
        forwards = [0]

        def spy(name, fn, dim):
            def call(q, *args, **kwargs):
                heads[name][q.shape[dim]] += 1
                return fn(q, *args, **kwargs)
            return call

        forward = gpt2_mod.GPT2LMHeadModel.forward

        def counted(self, *args, **kwargs):
            forwards[0] += 1
            return forward(self, *args, **kwargs)

        with mock.patch.object(fa, "_fwd_launch",
                               spy("flash_fwd", fa._fwd_launch, 1)), \
                mock.patch.object(da, "_append_launch",
                                  spy("decode_append", da._append_launch,
                                      2)), \
                mock.patch.object(da, "_paged_launch",
                                  spy("decode_paged", da._paged_launch,
                                      2)), \
                mock.patch.object(da, "_paged_int8_launch",
                                  spy("decode_paged_int8",
                                      da._paged_int8_launch, 2)), \
                mock.patch.object(gpt2_mod.GPT2LMHeadModel, "forward",
                                  counted):
            reset_launch_counts()
            for wrapper in (da.decode_attention_paged,
                            da.decode_attention_paged_int8):
                wrapper.source_launches = {}
            comm.reset_counts()
            results = run_tp_workloads(
                model, seed, {"tensor_parallel": {"tp_size": world}})
            torch.cuda.synchronize()
            counts = launch_counts()
            collectives = dict(comm.counts)
        # the two collectives tp runs, on CUDA tensors over gloo (the
        # vocab-parallel head's all-gather has no caller at vocab 50257)
        x = torch.arange(6, device="cuda", dtype=torch.bfloat16).view(2, 3)
        gathered = comm.all_gather(x + rank, group="tp", axis=-1, tiled=True)
        summed = comm.all_reduce(x + rank, group="tp")
        want = torch.cat([x + r for r in range(world)], dim=-1)
        if not (torch.equal(gathered, want) and torch.equal(
                summed, sum(x + r for r in range(world)))):
            raise AssertionError(f"tp rank {rank}: gloo all_gather / "
                                 f"all_reduce of CUDA tensors gave "
                                 f"{gathered.tolist()} / {summed.tolist()}")
        res = {"backend": backend, "results": results, "counts": counts,
               "sources": {"decode_paged_int8": dict(
                   da.decode_attention_paged_int8.source_launches)},
               "collectives": collectives, "forwards": forwards[0],
               "heads": {k: dict(v) for k, v in heads.items()}}
        comm.destroy_process_group()
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_tp_ranks(target, seed, world):
    """Run ``target(rank, world, store, seed, out_dir)`` (phase 9's
    :func:`tp_rank_main`, phase 10's :func:`tpt_rank_main`) on ``world``
    spawned processes joined through a ``FileStore``; returns the results
    each pickled, by rank. Every child is joined within TP_TIMEOUT or
    killed; the results' directory is removed."""
    import multiprocessing
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp") as out_dir:
        store = os.path.join(out_dir, "store")
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=target,
                             args=(rank, world, store, seed, out_dir))
                 for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TP_TIMEOUT
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)
        return _rank_results(procs, out_dir)


def _rank_results(procs, out_dir):
    """The spawned ranks' pickled results, by rank; raises with every
    failed rank's traceback or exit code."""
    import pickle

    errors = []
    for rank, p in enumerate(procs):
        err = os.path.join(out_dir, f"{rank}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {rank}:\n{f.read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {rank}: exit code {p.exitcode}")
    if errors:
        raise AssertionError("tensor parallel ranks failed:\n"
                             + "\n".join(errors))
    results = []
    for rank in range(len(procs)):
        with open(os.path.join(out_dir, f"{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def hold_to_tp1(label, got, want):
    """Hold one tp workload's rows to the tp=1 run's: each step's logits
    (the prefill's first; step t's give token t) within LOGITS_ATOL for
    as long as the two rows' tokens before it agree, and tokens equal
    until the tp=1 run's two best scores lie within LOGITS_ATOL. Returns
    (tokens agreeing, steps held before a near tie, logit steps held,
    max logit error)."""
    agree = held = logit_steps = 0
    err = 0.0
    for i, (toks, ref) in enumerate(zip(got["tokens"], want["tokens"])):
        what = f"tensor parallel {label} row {i}"
        steps, ref_steps = got["steps"][i], want["steps"][i]
        for t, (z, ref_z) in enumerate(zip(steps, ref_steps)):
            if toks[:t] != ref[:t]:
                break
            err = max(err, check_logits(f"{what} step {t}", z, ref_z))
            logit_steps += 1
        a, h = agree_until_tie(what, toks, ref, ref_steps,
                               want["prompt_lens"][i])
        agree, held = agree + a, held + h
    return agree, held, logit_steps, err


def phase_tensor_parallel(seed, card):
    """Tensor-parallel inference and serving of GPT-2 125M at tp=2 on the
    one card: the tp=1 references here (generate, serving, leg A on 4
    requests, every step's logits kept), then TP_SIZE spawned ranks on
    ``cuda:0`` over a gloo group run the same workloads through
    ``init_inference(tensor_parallel=...)`` / ``init_serving``. NCCL
    refuses two ranks on one device, and gloo carries CUDA tensors
    through the host: this proves the per-rank shapes, the sliced
    weights and the row-parallel sums, not NCCL's speed. Holds every
    rank's tokens bit for bit to rank 0's and to the tp=1 tokens up to a
    near tie, each step's logits to tp=1's while the tokens before it
    agree, kernels 1, 7, 8 and 9 at 6 heads each launch, 2 * n_layer
    all-reduces a forward and no all-gather (vocab 50257 does not split),
    and half of tp=1's split weight and pool bytes on each rank. Returns rank 0's launch counts."""
    import torch

    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel

    model = GPT2LMHeadModel(GPT2Config.gpt2_125m(), seed=seed)
    n_layer = model.config.n_layer
    want = run_tp_workloads(model, seed, {})
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_tp_ranks(tp_rank_main, seed, TP_SIZE)
    secs = time.perf_counter() - t0
    first = ranks[0]
    for rank, res in enumerate(ranks):
        got = res["results"]
        for label in want:
            if got[label]["tokens"] != first["results"][label]["tokens"]:
                raise AssertionError(f"tensor parallel {label}: rank {rank}"
                                     f"'s tokens differ from rank 0's")
        for name in ("flash_fwd", "decode_append", "decode_paged",
                     "decode_paged_int8"):
            if set(res["heads"].get(name, {})) != {TP_HEADS}:
                raise AssertionError(f"tensor parallel rank {rank}: {name}"
                                     f" launched at heads "
                                     f"{res['heads'].get(name)}, not only "
                                     f"{TP_HEADS}")
        sources = set(res["sources"]["decode_paged_int8"])
        if sources != {"decode_paged_int8", "decode_paged_int8_sm90"}:
            raise AssertionError(f"tensor parallel rank {rank}: kernel 9 "
                                 f"ran from {sources}, not both sources")
        coll, fwd = res["collectives"], res["forwards"]
        if coll.get("all_reduce") != 2 * n_layer * fwd or \
                coll.get("all_gather", 0):
            raise AssertionError(f"tensor parallel rank {rank}: {coll} over "
                                 f"{fwd} forwards, not {2 * n_layer} "
                                 f"all-reduces and no all-gather each")
        local, whole = got["generate"]["split_bytes"]
        if not local or 2 * local != whole:
            raise AssertionError(f"tensor parallel rank {rank}: {local} "
                                 f"bytes of split weights, not half of "
                                 f"tp=1's {whole}")
        if got["serving"]["stats"]["tp"] != TP_SIZE:
            raise AssertionError(f"tensor parallel rank {rank}: stats() "
                                 f"tp {got['serving']['stats']['tp']}")
        for label in ("serving", "fast_path"):
            if 2 * got[label]["pool_bytes"] != want[label]["pool_bytes"]:
                raise AssertionError(
                    f"tensor parallel rank {rank} {label}: pool bytes "
                    f"{got[label]['pool_bytes']}, not half of tp=1's "
                    f"{want[label]['pool_bytes']}")
    summary = []
    for label in want:
        agree, held, steps, err = hold_to_tp1(
            label, first["results"][label], want[label])
        total = sum(len(t) for t in want[label]["tokens"])
        summary.append(f"{label} tokens equal to tp=1 {agree}/{total} "
                       f"(held {held} before a near tie), logits held to "
                       f"tp=1's at {steps} steps (every step while the "
                       f"tokens before it agree), max |logit diff| "
                       f"{err:.4g}")
    gen = [r["results"]["generate"]["decode_step_ms"] for r in ranks]
    log(f"tensor parallel: {TP_SIZE} ranks on cuda:0 over gloo (NCCL "
        f"refuses two ranks on one device; gloo stages CUDA tensors through"
        f" the host), GPT-2 125M bf16 at {TP_HEADS} heads a rank, in "
        f"{secs:.1f} s: every rank's tokens bit for bit rank 0's; "
        + "; ".join(summary)
        + f"; kernels 1/7/8/9 at {TP_HEADS} heads on every launch "
        f"({ {k: v for k, v in first['heads'].items()} }), kernel 9 sources "
        f"{first['sources']['decode_paged_int8']}; all-reduces "
        f"{first['collectives'].get('all_reduce')} over "
        f"{first['forwards']} forwards ({2 * n_layer} each), all-gathers "
        f"{first['collectives'].get('all_gather', 0)}; split weights "
        f"{first['results']['generate']['split_params']} tensors, "
        f"{first['results']['generate']['split_bytes'][0]} of "
        f"{first['results']['generate']['split_bytes'][1]} bytes a rank; "
        f"pool bytes a rank "
        f"serving {first['results']['serving']['pool_bytes']} / fast path "
        f"{first['results']['fast_path']['pool_bytes']} (tp=1: "
        f"{want['serving']['pool_bytes']} / "
        f"{want['fast_path']['pool_bytes']}); stats tp "
        f"{first['results']['serving']['stats']['tp']}; launches "
        f"{first['counts']} [{card}]")
    log(f"tensor parallel, for information only: a generate decode step "
        f"{[round(x, 3) for x in gen]} ms per rank at tp={TP_SIZE} over "
        f"gloo host-staged all-reduces (says nothing of NCCL tensor-"
        f"parallel speed), {want['generate']['decode_step_ms']:.3f} ms at "
        f"tp=1 [{card}]")
    return first["counts"]


# ---------------------------------------------------------------------------
# phase 10: tensor-parallel training
# ---------------------------------------------------------------------------
TPT_STEPS = 3
# the ranks against tp=1 on the same seed and batch (bf16: the row sums
# and the heads' split change the summation order): phase 3's standard;
# ZeRO stage 3 against stage 0 at tp=2: phase 3b's
TPT_LOSS_ATOL = TRAIN_LOSS_ATOL
TPT_GRAD_RTOL = TRAIN_GRAD_RTOL


def tpt_config(**extra):
    """bench.py's keys at phase 10's micro-batch, with ``extra``."""
    from deepspeed_tpu_torch.tools.profile_training import BENCH_CONFIG

    return {**BENCH_CONFIG, "train_micro_batch_size_per_gpu": TPT_BATCH,
            **extra}


def tpt_batch(vocab_size, seed, device):
    import torch

    rng = np.random.default_rng(seed + 3)
    ids = rng.integers(0, vocab_size, (TPT_BATCH, 1024))
    return {"input_ids": torch.from_numpy(ids).to(device)}


def tpt_model(seed, **extra):
    import dataclasses

    from deepspeed_tpu_torch.models.gpt2 import GPT2ForTraining
    from deepspeed_tpu_torch.tools.profile_training import bench_model

    model = bench_model(seed)
    if not extra:
        return model
    return GPT2ForTraining(dataclasses.replace(model.config, **extra),
                           seed=seed)


def rel_l2(grads, ref):
    """Per-tensor relative L2 error of ``grads`` against ``ref``."""
    return {n: ((grads[n].float().cpu() - r.float()).norm()
                / r.float().norm().clamp_min(1e-30)).item()
            for n, r in ref.items()}


def tpt_run(engine, batch, what):
    """Step-1 gradients (whole, on the host), one warm-up and TPT_STEPS
    timed steps with the launch and collective counts zeroed just before
    and read just after; each step's collectives against the plan."""
    import torch

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.tools.profile_training import timed_steps

    engine.module(batch).backward()
    grads = {n: g.cpu() for n, g in engine.gathered_grads().items()}
    engine.zero_grad()
    first, _ = timed_steps(engine, batch, 1)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    comm.reset_counts()
    losses, secs = timed_steps(engine, batch, TPT_STEPS)
    counts = launch_counts()
    plan = engine._zero.comm_plan(1, recompute=engine.module.config.remat)
    for k, v in engine.module.comm_plan(TPT_BATCH, 1024).items():
        plan[k] = plan.get(k, 0) + v
    plan = {k: v * TPT_STEPS for k, v in plan.items()}
    collectives = {k: comm.counts.get(k, 0) for k in plan}
    if collectives != plan:
        raise AssertionError(f"{what}: collectives {collectives} in "
                             f"{TPT_STEPS} steps, the plan {plan}")
    n_layer = engine.module.config.n_layer
    check_per_step(what, counts, TPT_STEPS,
                   {"flash_fwd": n_layer, "flash_bwd_dq": n_layer,
                    "flash_bwd_dkv": n_layer})
    return {"losses": first + losses, "ms": 1e3 * secs / TPT_STEPS,
            "peak": torch.cuda.max_memory_allocated(), "counts": counts,
            "collectives": collectives}, grads


def tpt_rank_main(rank, world, store, seed, out_dir):
    """One rank of phase 10 (a spawned process): join the gloo group on
    ``cuda:0`` and train GPT-2 125M at ``{"mesh": {"tp": world}}`` through
    ``initialize`` three times: ZeRO stage 0, stage 3, and stage 0 with
    ``partition_activations``. Writes per engine the losses, ms a step,
    peak memory, launch and collective counts; the heads of every flash
    launch; the cotangents the flash backward had to copy; the hash of
    the replicated parameters, the split weights' bytes; rank 0 also
    stage 0's step-1 gradients (whole) for the parent."""
    import gc
    import hashlib
    import pickle
    import traceback

    try:
        os.environ["LOCAL_RANK"] = "0"
        import torch
        import torch.distributed as tdist

        import deepspeed_tpu_torch
        from deepspeed_tpu_torch import comm
        from deepspeed_tpu_torch.ops import flash_attention as fa

        torch.backends.cuda.matmul.allow_tf32 = False
        comm.init_distributed(dist_backend="gloo",
                              init_method=f"file://{store}", rank=rank,
                              world_size=world, timeout=TP_TIMEOUT,
                              verbose=False)
        if tdist.get_backend() != "gloo":
            raise AssertionError("tp training ranks not on gloo")
        heads = collections.defaultdict(collections.Counter)
        copies = [0]

        def spy(name, fn):
            def call(q, *args, **kwargs):
                heads[name][q.shape[1]] += 1
                return fn(q, *args, **kwargs)
            return call

        readable = fa.readable_cotangent

        def counted_copy(do, tma):
            out = readable(do, tma)
            copies[0] += out is not do
            return out

        config = tpt_config(mesh={"tp": world})
        res = {}
        with mock.patch.object(fa, "_fwd_launch",
                               spy("flash_fwd", fa._fwd_launch)), \
                mock.patch.object(fa, "_dq_launch",
                                  spy("flash_bwd_dq", fa._dq_launch)), \
                mock.patch.object(fa, "_dkv_launch",
                                  spy("flash_bwd_dkv", fa._dkv_launch)), \
                mock.patch.object(fa, "readable_cotangent", counted_copy):
            for label, extra, stage in (
                    ("stage0", {}, 0), ("stage3", {}, 3),
                    ("partition", {"partition_activations": True}, 0)):
                whole = tpt_model(seed, **extra)
                engine = deepspeed_tpu_torch.initialize(
                    model=whole, config={**config, "zero_optimization": {
                        "stage": stage}})[0]
                batch = tpt_batch(whole.config.vocab_size, seed,
                                  engine.device)
                specs = engine.module.param_specs()
                split = {n for n, sp in specs.items() if sp is not None}
                res[label], grads = tpt_run(engine, batch,
                                            f"tp training {label}")
                if label == "stage0":
                    ref_grads = grads
                    res["split_bytes"] = (
                        sum(4 * p.numel() for n, p in
                            engine.module.named_parameters() if n in split),
                        sum(4 * p.numel() for n, p in
                            whole.named_parameters() if n in split))
                    digest = hashlib.sha256()
                    for n, p in engine.module.named_parameters():
                        if n not in split:
                            digest.update(p.detach().cpu().numpy()
                                          .tobytes())
                    res["replicated_sha256"] = digest.hexdigest()
                    if rank == 0:
                        res["grads"] = grads
                elif label == "stage3":
                    res["stage3_grad_err"] = rel_l2(grads, ref_grads)
                # stage 3's gather hooks tie the engine in reference
                # cycles: collect them before the next engine's peak
                del engine, whole, grads
                gc.collect()
                torch.cuda.empty_cache()
        res["heads"] = {k: dict(v) for k, v in heads.items()}
        res["cotangent_copies"] = copies[0]
        comm.destroy_process_group()
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def phase_tp_training(seed, card):
    """Tensor-parallel training of GPT-2 125M at tp=2 on the one card:
    the tp=1 reference here (bench.py's keys at TPT_BATCH x 1024, the
    step-1 gradients and 1 + TPT_STEPS losses), then TP_SIZE spawned
    ranks on ``cuda:0`` over a gloo group (NCCL refuses two ranks on one
    device) train the same model from the same seed through
    ``initialize(config={"mesh": {"tp": 2}})`` at ZeRO stage 0, stage 3
    and with ``partition_activations``. Holds: the ranks' losses and
    replicated parameters bit-equal; losses within TPT_LOSS_ATOL of tp=1's
    and step-1 gradients (merged from the ranks' slices) within
    TPT_GRAD_RTOL relative L2 a tensor; stage 3's losses within
    ZERO_LOSS_ATOL and gradients within ZERO_GRAD_RTOL of stage 0's;
    ``partition_activations``' losses bit-equal to stage 0's; collectives
    a step equal to the plan; 12 launches a step of each flash kernel,
    all at 6 heads; no cotangent copied for TMA; each rank's split
    weights half of tp=1's bytes. Returns rank 0's launch counts summed
    over its three engines' timed steps."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.tools.profile_training import timed_steps

    model = tpt_model(seed)
    engine = deepspeed_tpu_torch.initialize(model=model,
                                            config=tpt_config())[0]
    batch = tpt_batch(model.config.vocab_size, seed, engine.device)
    ref_grads = first_grads(engine, batch)
    ref_grads = {n: g.cpu() for n, g in ref_grads.items()}
    warm, _ = timed_steps(engine, batch, 1)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = timed_steps(engine, batch, TPT_STEPS)
    ref = {"losses": warm + losses, "ms": 1e3 * secs / TPT_STEPS,
           "peak": torch.cuda.max_memory_allocated()}
    del engine, model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn_tp_ranks(tpt_rank_main, seed, TP_SIZE)
    secs = time.perf_counter() - t0
    grads = ranks[0].pop("grads")
    first = ranks[0]
    for rank, res in enumerate(ranks):
        what = f"tp training rank {rank}"
        for label in ("stage0", "stage3", "partition"):
            if res[label]["losses"] != first[label]["losses"]:
                raise AssertionError(f"{what} {label}: losses "
                                     f"{res[label]['losses']} differ from "
                                     f"rank 0's {first[label]['losses']}")
        if res["replicated_sha256"] != first["replicated_sha256"]:
            raise AssertionError(f"{what}: replicated parameters differ "
                                 f"from rank 0's")
        if set(res["heads"]) != {"flash_fwd", "flash_bwd_dq",
                                 "flash_bwd_dkv"} or any(
                set(h) != {TP_HEADS} for h in res["heads"].values()):
            raise AssertionError(f"{what}: flash launches at heads "
                                 f"{res['heads']}, not only {TP_HEADS}")
        if res["cotangent_copies"]:
            raise AssertionError(f"{what}: the flash backward copied "
                                 f"{res['cotangent_copies']} cotangents")
        local, whole = res["split_bytes"]
        if not local or 2 * local != whole:
            raise AssertionError(f"{what}: {local} bytes of split weights, "
                                 f"not half of tp=1's {whole}")
    stage0, stage3, part = (first[k] for k in ("stage0", "stage3",
                                               "partition"))
    loss_err = max(abs(a - b) for a, b in zip(stage0["losses"],
                                              ref["losses"]))
    grad_err = rel_l2(grads, ref_grads)
    worst = max(grad_err, key=grad_err.get)
    if loss_err > TPT_LOSS_ATOL or grad_err[worst] > TPT_GRAD_RTOL:
        raise AssertionError(
            f"tp training vs tp=1: losses {stage0['losses']} vs "
            f"{ref['losses']} (max diff {loss_err}); step-1 gradient "
            f"{worst} relative L2 {grad_err[worst]}")
    z_loss = max(abs(a - b) for a, b in zip(stage3["losses"],
                                            stage0["losses"]))
    z_grad = first["stage3_grad_err"]
    z_worst = max(z_grad, key=z_grad.get)
    if z_loss > ZERO_LOSS_ATOL or z_grad[z_worst] > ZERO_GRAD_RTOL:
        raise AssertionError(
            f"tp training stage 3 vs stage 0: losses {stage3['losses']} vs"
            f" {stage0['losses']} (max diff {z_loss}); step-1 gradient "
            f"{z_worst} relative L2 {z_grad[z_worst]}")
    def per_step(counts):
        return {k: v / TPT_STEPS for k, v in counts.items()}

    if part["losses"] != stage0["losses"]:
        raise AssertionError(f"tp training partition_activations: losses "
                             f"{part['losses']} vs {stage0['losses']}")
    log(f"tensor-parallel training: GPT-2 125M bf16, {TP_SIZE} ranks on "
        f"cuda:0 over gloo (NCCL refuses two ranks on one device; gloo "
        f"stages CUDA tensors through the host), micro-batch {TPT_BATCH} "
        f"x 1024, dots remat, fused AdamW, clip 1.0, in {secs:.1f} s: "
        f"ranks' losses and replicated parameters bit-equal; losses "
        f"{[round(x, 4) for x in stage0['losses']]} vs tp=1 "
        f"{[round(x, 4) for x in ref['losses']]} (max |diff| "
        f"{loss_err:.3g}, limit {TPT_LOSS_ATOL}); step-1 gradients "
        f"relative L2 max {grad_err[worst]:.3g} at {worst}, median "
        f"{float(np.median(list(grad_err.values()))):.3g} (limit "
        f"{TPT_GRAD_RTOL}); stage 3 vs stage 0 losses max |diff| "
        f"{z_loss:.3g}, gradients max {z_grad[z_worst]:.3g} at {z_worst}; "
        f"partition_activations bit-equal; collectives a step "
        + "; ".join(f"{k} {per_step(first[k]['collectives'])}"
                    for k in ("stage0", "stage3", "partition"))
        + f" (= the plan); flash launches {first['heads']} at {TP_HEADS} "
        f"heads, 0 cotangents copied; split weights "
        f"{first['split_bytes'][0]} of {first['split_bytes'][1]} bytes a "
        f"rank [{card}]")
    log(f"tensor-parallel training, for information only (gloo host-staged"
        f" all-reduces, nothing of NCCL's speed): ms a step "
        + ", ".join(f"{k} {first[k]['ms']:.1f}" for k in
                    ("stage0", "stage3", "partition"))
        + f" per rank (tp=1: {ref['ms']:.1f}); peak memory a rank "
        + ", ".join(f"{k} {first[k]['peak'] / 1e9:.3f} GB" for k in
                    ("stage0", "stage3", "partition"))
        + f" (tp=1: {ref['peak'] / 1e9:.3f} GB) [{card}]")
    total = collections.Counter()
    for k in ("stage0", "stage3", "partition"):
        total.update(first[k]["counts"])
    return dict(total)


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
# ---------------------------------------------------------------------------
# phase 11: the serving fleet
# ---------------------------------------------------------------------------
# phase 4's serving block with keyed sampling on (greedy requests still
# take the argmax), and the one keyed request of (a) and (b)
FLEET_SERVING = {"block_size": 16, "decode_slots": 4, "sampling": {}}
FLEET_KEYED = dict(seed=11, temperature=0.8, top_p=0.9)
# (b): replica 1 dies at its 6th step, mid-decode
FLEET_CRASH_STEP = 6
# (c): router steps before migrate_work(1), and the requests of the leg
# (two a replica: the target keeps room for the moved ones)
FLEET_MIGRATE_STEP = 4
FLEET_MIGRATE_REQUESTS = 4
# (c): blocks of the timed single-sequence moves (64 blocks hold 1024
# tokens, the model's window)
MIGRATION_BLOCKS = (4, 16, 63)
# (d): the fleet block; the manual levers alone scale (no autoscaled
# scale-down while a stream drains)
FLEET_BLOCK = {"min_replicas": 1, "max_replicas": 3,
               "scale_down_quiet_steps": 100000}
# (e): two tenants; spam's bucket holds one request and refills in 100 s
FLEET_TENANTS = [
    {"name": "acme", "api_key": "acme-key", "slo_class": "gold"},
    {"name": "spam", "api_key": "spam-key", "requests_per_sec": 0.01,
     "burst_requests": 1.0},
]


class EventLog:
    """A ``telemetry=`` object for the router: records its events."""

    enabled = True

    def __init__(self):
        self.events = []

    def emit(self, kind, name, step=None, **data):
        self.events.append((kind, name, data))


def fleet_stream(front, prompts, keyed_prompt, max_new):
    """Phase 4's requests and one keyed request through ``front``, every
    client's stream recorded: (handles by id, streamed tokens by id)."""
    streamed = {}

    def cb(handle, tok, done):
        streamed.setdefault(handle.request_id, []).append(int(tok))

    handles = [front.submit(p, max_new_tokens=max_new, request_id=f"r{i}",
                            stream=cb) for i, p in enumerate(prompts)]
    if keyed_prompt is not None:
        handles.append(front.submit(keyed_prompt, max_new_tokens=max_new,
                                    request_id="k", stream=cb,
                                    do_sample=True, **FLEET_KEYED))
    front.drain()
    return {h.request_id: h for h in handles}, streamed


def check_stream(what, handles, streamed, want, max_new):
    """Every request finished with ``max_new`` tokens, each client saw
    each position exactly once, and the tokens are ``want``'s."""
    for rid, h in handles.items():
        if h.state != "finished" or len(h.tokens) != max_new:
            raise AssertionError(f"{what} {rid}: state {h.state} reason "
                                 f"{h.finish_reason}, {len(h.tokens)} "
                                 f"tokens")
        if streamed.get(rid) != h.tokens:
            raise AssertionError(f"{what} {rid}: the client's stream "
                                 f"{streamed.get(rid)} is not the handle's "
                                 f"{h.tokens}")
        if want is not None and h.tokens != want[rid]:
            raise AssertionError(f"{what} {rid}: tokens {h.tokens} differ "
                                 f"from {want[rid]}")


def check_router(what, stats, **want):
    for key, value in want.items():
        ok = value(stats[key]) if callable(value) else stats[key] == value
        if not ok:
            raise AssertionError(f"{what}: router {key} {stats[key]} "
                                 f"({stats})")


def time_moves(model, serving, card):
    """Export + import (and the source's detach) of one sequence between
    two engines, by covered blocks, on the host clock around work that
    ends in a sync; returns {blocks: (ms, wire bytes)}."""
    import torch

    from deepspeed_tpu_torch import init_serving

    src, dst = (init_serving(model, serving=serving) for _ in range(2))
    rng = np.random.default_rng(5)
    out = {}
    # each size moves twice and the second move is timed: the first pays
    # the allocators' first buffers of that size
    for n, blocks in enumerate(b for b in MIGRATION_BLOCKS for _ in "12"):
        prompt = rng.integers(1, model.config.vocab_size, blocks * 16 - 2)
        src.submit(prompt, max_new_tokens=8, request_id=f"t{n}")
        src.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export = src.export_sequence(f"t{n}")
        moved = dst.import_sequence(export)
        src.migrate_out(f"t{n}")
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if export["blocks"] != blocks or moved is None:
            raise AssertionError(f"move of {blocks} blocks: export "
                                 f"{export['blocks']} blocks, import "
                                 f"{moved}")
        dst.cancel(moved.request_id)
        if n % 2:
            out[blocks] = (ms, export["wire_bytes"])
    return out


def fleet_migration(model, prompts, want, max_new, kv, card):
    """(c) on ``kv`` pools: two replicas with ``serving.migration``, four
    requests, ``migrate_work(1)`` after FLEET_MIGRATE_STEP steps. The
    moved requests finish with ``want``'s tokens (None: an unmigrated
    run's on the same pools) and kernel 1 launches 0 times from the move
    to the end. Returns the wire bytes of a moved block."""
    from deepspeed_tpu_torch import init_serving

    serving = {**FLEET_SERVING, "kv_cache_dtype": kv,
               "router": {"replicas": 2}, "migration": {}}
    prompts = prompts[:FLEET_MIGRATE_REQUESTS]
    what = "an unmigrated run" if want is None else "(a)"
    if want is None:
        ref, _ = fleet_stream(init_serving(model, serving=serving), prompts,
                              None, max_new)
        want = {rid: h.tokens for rid, h in ref.items()}
    front = init_serving(model, serving=serving)
    front.telemetry = events = EventLog()
    streamed = {}
    handles = {f"r{i}": front.submit(
        p, max_new_tokens=max_new, request_id=f"r{i}",
        stream=lambda h, t, d: streamed.setdefault(h.request_id,
                                                   []).append(int(t)))
        for i, p in enumerate(prompts)}
    for _ in range(FLEET_MIGRATE_STEP):
        front.step()
    on_1 = front.assigned(1)
    before = launch_counts()
    moved = front.migrate_work(1)
    front.drain()
    after = launch_counts()
    check_stream(f"fleet (c) {kv or 'bf16'}", handles, streamed, want,
                 max_new)
    st = front.stats()
    check_router(f"fleet (c) {kv or 'bf16'}", st, migrations=on_1,
                 failovers=0, replay_divergence=0)
    if moved != on_1 or moved == 0:
        raise AssertionError(f"fleet (c): moved {moved} of replica 1's "
                             f"{on_1} requests")
    fwd = after["flash_fwd"] - before["flash_fwd"]
    decode = ("decode_paged_int8" if kv else "decode_paged")
    if fwd != 0 or after[decode] - before[decode] <= 0:
        raise AssertionError(f"fleet (c): from the move to the end kernel "
                             f"1 launched {fwd} times, {decode} "
                             f"{after[decode] - before[decode]}")
    moves = [d for kind, name, d in events.events if name == "migrate"]
    per_block = {d["wire_bytes"] / d["blocks"] for d in moves}
    log(f"fleet (c) {kv or 'bf16'} pools: migrate_work(1) after "
        f"{FLEET_MIGRATE_STEP} steps moved {moved} requests "
        f"({[(d['request_id'], d['blocks'], d['wire_bytes']) for d in moves]}"
        f" id, blocks, wire bytes), tokens equal to "
        f"{what}'s, kernel 1 "
        f"launches from the move to the end 0, {decode} "
        f"{after[decode] - before[decode]} [{card}]")
    return per_block.pop()


def fleet_crash_mid_migration(model, prompts, want, max_new, card):
    """(c), last: replica 1 dies between its first export and the
    target's commit (``crash_during_migration=1``): that move falls back
    to a replay, exactly once, and every request keeps (a)'s tokens."""
    from deepspeed_tpu_torch import init_serving
    from deepspeed_tpu_torch.runtime.resilience.chaos import ChaosReplica

    serving = {**FLEET_SERVING, "router": {"replicas": 2}, "migration": {}}
    engines = [init_serving(model, serving=FLEET_SERVING) for _ in range(2)]
    engines[1] = ChaosReplica(engines[1], crash_during_migration=1)
    front = init_serving(None, replicas=engines, serving=serving)
    streamed = {}
    handles = {f"r{i}": front.submit(
        p, max_new_tokens=max_new, request_id=f"r{i}",
        stream=lambda h, t, d: streamed.setdefault(h.request_id,
                                                   []).append(int(t)))
        for i, p in enumerate(prompts[:FLEET_MIGRATE_REQUESTS])}
    for _ in range(FLEET_MIGRATE_STEP):
        front.step()
    on_1 = front.assigned(1)
    moved = front.migrate_work(1)
    front.drain()
    check_stream("fleet (c) crash mid-migration", handles, streamed, want,
                 max_new)
    st = front.stats()
    check_router("fleet (c) crash mid-migration", st, failovers=1,
                 migrations=on_1 - 1, replay_divergence=0,
                 replica_states=["healthy", "dead"])
    if moved != on_1 - 1:
        raise AssertionError(f"crash mid-migration: moved {moved} of "
                             f"{on_1}")
    log(f"fleet (c) crash mid-migration: replica 1 died in its first "
        f"export; {moved} of its {on_1} requests moved, 1 replayed "
        f"(failovers {st['failovers']}, deduped {st['deduped_tokens']}, "
        f"divergence 0), tokens equal to (a)'s [{card}]")


def sse_post(url, body, key=None, timeout=120):
    """POST /v1/generate and read the SSE stream: (status, tokens, seconds
    from the request to the first token event)."""
    import urllib.error
    import urllib.request

    headers = {"Content-Type": "application/json"}
    if key:
        headers["Authorization"] = f"Bearer {key}"
    req = urllib.request.Request(url + "/v1/generate",
                                 data=json.dumps(body).encode("utf-8"),
                                 headers=headers, method="POST")
    t0 = time.perf_counter()
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        e.read()
        e.close()
        return e.code, [], None
    tokens, first, event = [], None, ""
    with resp:
        for raw in resp:
            line = raw.decode("utf-8").rstrip("\n")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: ") and event == "token":
                if first is None:
                    first = time.perf_counter() - t0
                tokens.append(int(json.loads(line[6:])["token"]))
            elif line.startswith("data: ") and event in ("done", "error"):
                break
        return resp.status, tokens, first


def stepped(front, fn):
    """``fn()`` on a client thread while this thread steps ``front`` (the
    engines are stepped from one thread only); returns fn's result."""
    import threading

    out = []
    client = threading.Thread(target=lambda: out.append(fn()), daemon=True)
    client.start()
    deadline = time.monotonic() + 300
    while client.is_alive() and time.monotonic() < deadline:
        if front.pending:
            front.step()
        else:
            time.sleep(0.001)
    client.join(10)
    if client.is_alive() or not out:
        raise AssertionError("gateway client did not finish")
    return out[0]


def fleet_gateway(model, prompts, want, max_new, card):
    """(e): the router behind the gateway on loopback, two tenants."""
    import torch

    from deepspeed_tpu_torch import init_serving

    gw = init_serving(model, serving={
        **FLEET_SERVING, "router": {"replicas": 2},
        "gateway": {"tenants": FLEET_TENANTS}})
    try:
        first = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        direct = gw.submit(prompts[0], max_new_tokens=max_new,
                           request_id="direct",
                           stream=lambda h, t, d: first.append(
                               time.perf_counter() - t0) if not first
                           else None)
        gw.drain()
        if direct.tokens != want["r0"]:
            raise AssertionError(f"gateway direct submit: {direct.tokens}")
        status, tokens, ttft = stepped(gw, lambda: sse_post(
            gw.url, {"prompt": [int(t) for t in prompts[0]],
                     "max_new_tokens": max_new}, key="acme-key"))
        if status != 200 or tokens != want["r0"]:
            raise AssertionError(f"gateway SSE: status {status}, tokens "
                                 f"{tokens}")
        no_key = sse_post(gw.url, {"prompt": [1]})[0]
        spam = stepped(gw, lambda: sse_post(
            gw.url, {"prompt": [int(t) for t in prompts[1]],
                     "max_new_tokens": max_new}, key="spam-key"))
        over = sse_post(gw.url, {"prompt": [2]}, key="spam-key")[0]
        if (no_key, spam[0], over) != (401, 200, 429) \
                or spam[1] != want["r1"]:
            raise AssertionError(f"gateway: no key {no_key}, spam "
                                 f"{spam[0]} then {over}, spam tokens "
                                 f"{spam[1]}")
        log(f"fleet (e) gateway on {gw.url}: SSE tokens equal (a)'s for 2 "
            f"tenants, no key 401, spam over its quota 429; TTFT "
            f"over HTTP {1e3 * ttft:.3f} ms against {1e3 * first[0]:.3f} ms "
            f"for a direct submit (host clock, one request alone, for "
            f"information) [{card}]")
    finally:
        gw.close()


def phase_fleet(model, seed, card, single):
    """The serving fleet on GPT-2 125M: (a) the router, (b) failover, (c)
    live migration, (d) the fleet manager, (e) the gateway; ``single``
    is phase 4's tokens a request. Returns the phase's launch counts."""
    import torch

    from deepspeed_tpu_torch import init_serving
    from deepspeed_tpu_torch.runtime.resilience.chaos import ChaosReplica
    from deepspeed_tpu_torch.serving.router import FleetManager, ReplicaRouter
    from deepspeed_tpu_torch.tools.profile_serving import (MAX_NEW_TOKENS,
                                                           serving_prompts)

    max_new = MAX_NEW_TOKENS
    prompts = serving_prompts(model.config.vocab_size, seed)
    keyed = prompts[2]
    reset_launch_counts()
    # (a) the router over two replicas
    router = init_serving(model, serving={**FLEET_SERVING,
                                          "router": {"replicas": 2}})
    if not isinstance(router, ReplicaRouter):
        raise AssertionError(f"init_serving built {type(router)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles, streamed = fleet_stream(router, prompts, keyed, max_new)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = {rid: h.tokens for rid, h in handles.items()}
    check_stream("fleet (a)", handles, streamed,
                 {f"r{i}": t for i, t in enumerate(single)} | {
                     "k": want["k"]}, max_new)
    served = [r.stats()["finished"] for r in router.replicas]
    if min(served) == 0:
        raise AssertionError(f"fleet (a): a replica took no work {served}")
    check_router("fleet (a)", router.stats(), failovers=0, shed=0)
    log(f"fleet (a): {len(handles)} requests through 2 replicas "
        f"({served} finished each) in {secs:.3f} s, the 8 greedy streams "
        f"equal to phase 4's single engine [{card}]")
    # (b) replica 1 crashes mid-decode
    engines = [init_serving(model, serving=FLEET_SERVING) for _ in range(2)]
    engines[1] = ChaosReplica(engines[1], crash_at_step=FLEET_CRASH_STEP)
    front = init_serving(None, replicas=engines, serving={
        **FLEET_SERVING, "router": {"replicas": 2}})
    handles, streamed = fleet_stream(front, prompts, keyed, max_new)
    check_stream("fleet (b)", handles, streamed, want, max_new)
    st = front.stats()
    check_router("fleet (b)", st, failovers=lambda n: n > 0,
                 deduped_tokens=lambda n: n > 0, replay_divergence=0,
                 replica_states=["healthy", "dead"])
    log(f"fleet (b): replica 1 crashed at its step {FLEET_CRASH_STEP}: "
        f"{st['failovers']} failovers replayed on replica 0, "
        f"{st['deduped_tokens']} regenerated positions swallowed, "
        f"replay_divergence 0, every stream (the keyed one too) equal to "
        f"(a)'s and each position delivered once [{card}]")
    # (c) live migration on bf16 and int8 pools
    bf16_block = fleet_migration(model, prompts, want, max_new, "", card)
    int8_block = fleet_migration(model, prompts, None, max_new, "int8", card)
    hd = model.config.n_embd // model.config.n_head
    log(f"fleet (c) wire bytes a block: int8 {int8_block:.0f}, bf16 "
        f"{bf16_block:.0f}, ratio {int8_block / bf16_block:.5f} (codes "
        f"and an fp32 scale a row: ({hd} + 4) / {2 * hd} = "
        f"{(hd + 4) / (2 * hd):.5f}) [{card}]")
    for kv in ("", "int8"):
        moves = time_moves(model, {**FLEET_SERVING, "kv_cache_dtype": kv},
                           card)
        log(f"fleet (c) {kv or 'bf16'} export + import of one sequence "
            f"(host clock, synced): " + ", ".join(
                f"{b} blocks {ms:.3f} ms ({wire / 1e6:.3f} MB)"
                for b, (ms, wire) in moves.items()) + f" [{card}]")
    fleet_crash_mid_migration(model, prompts, want, max_new, card)
    # (d) the fleet manager through the default factory
    fm = init_serving(model, serving={**FLEET_SERVING,
                                      "router": {"replicas": 2},
                                      "fleet": FLEET_BLOCK})
    if not isinstance(fm, FleetManager):
        raise AssertionError(f"init_serving built {type(fm)}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    up = fm.scale_up("chip_smoke")
    handles, streamed = fleet_stream(fm, prompts, keyed, max_new)
    check_stream("fleet (d) 3 replicas", handles, streamed, want, max_new)
    peak = torch.cuda.max_memory_allocated()
    down = fm.scale_down(reason="chip_smoke")
    handles, streamed = fleet_stream(fm, prompts, keyed, max_new)
    check_stream("fleet (d) after scale-down", handles, streamed, want,
                 max_new)
    st = fm.stats()
    if (up["source"], down["source"], st["factory_builds"], st["parks"],
            st["active"]) != ("factory", "drain", 1, 1, 2):
        raise AssertionError(f"fleet (d): up {up}, down {down}, stats {st}")
    log(f"fleet (d): scale_up built replica {up['replica']} through the "
        f"default factory, scale_down drained and parked replica "
        f"{down['replica']}, tokens unchanged; peak memory with 3 replicas "
        f"{peak / 2**20:.1f} MiB (allocated before {base / 2**20:.1f} MiB) "
        f"[{card}]")
    # (e) the gateway
    fleet_gateway(model, prompts, want, max_new, card)
    counts = launch_counts()
    for name in ("flash_fwd", "decode_paged", "decode_paged_int8"):
        if counts[name] <= 0:
            raise AssertionError(f"the fleet did not launch {name}: "
                                 f"{counts}")
    log(f"fleet launches: {counts} [{card}]")
    return counts


# ---------------------------------------------------------------------------
# phase 12: the Llama family
# ---------------------------------------------------------------------------
# (a) Llama-2 7B at full width and depth: one greedy generate() a prompt
# (B = 1) of each length, LLAMA_NEW new tokens
LLAMA_PROMPTS = (128, 256, 512, 1024)
LLAMA_NEW = 32
# (b) grouped-query attention at 7B width: 8 KV heads (4 query heads a KV
# head), depth cut to 4; the same prompts alone, then left-padded into one
# batch
LLAMA_GQA = {"num_key_value_heads": 8, "num_hidden_layers": 4}
# (c) training at 7B width, depth cut to 4: micro-batch 4 x 1024, bench.py's
# keys (bf16, fused AdamW, clip 1.0), "dots" remat; ZeRO stage 0, then
# stage 3 on an NCCL group of one rank
LLAMA_TRAIN_LAYERS = 4
LLAMA_TRAIN_BATCH = LLAMA_BATCH
LLAMA_TRAIN_SEQ = 1024
LLAMA_TRAIN_STEPS = 3
# (d) tp = 2 on 2 gloo ranks of the one card: 7B width, depth cut to 2,
# LLAMA_TP_NEW new tokens on generate_ids' 2 x 128 prompt
LLAMA_TP_LAYERS = 2
LLAMA_TP_NEW = 16
# (e) from_pretrained on an HF directory of (c)'s first 2 layers in bf16
LLAMA_HF_LAYERS = 2
# the card (a CPU rehearsal of the phase points it elsewhere)
LLAMA_DEVICE = "cuda"
# Llama-2 7B's width lifts the bf16 rounding noise of a correct path far
# above GPT-2's: on the H100 the plain versions' own first-step logits
# lie 0.34-0.38 from an fp32 forward on the same weights at 32 layers
# (0.11-0.12 at 4; PERF.md), so LOGITS_ATOL would fail a correct kernel.
# Phase 12 holds each bf16 path to that fp32 forward instead, at every
# step: the reference path (the plain versions, or tp=1) and the fp32
# forward are teacher-forced on the path's own tokens, and each step's
# logits must lie within LLAMA_NOISE_RATIO times the reference's distance
# from fp32 at that step (or LOGITS_ATOL, the larger); each token must be
# fp32's best wherever fp32's two best scores lie more than twice the
# reference's distance apart (hold_steps). The gate must refuse faults
# planted in the decode steps (LLAMA_FAULTS)
LLAMA_NOISE_RATIO = 1.5


def llama_fp32_steps(engine, rows):
    """The fp32 anchor: for each ``(prompt, new tokens)`` row, the
    logits ``[len(new), V]`` (fp32, on the host) that an fp32 forward on
    the engine's bf16 weights, through the plain versions, gives each new
    token's step when teacher-forced on those tokens (one forward of the
    prompt and all but the last new token)."""
    import torch

    model = engine.mode_module(dataclasses.replace(engine.model_config,
                                                   dtype=torch.float32))
    out = []
    with torch.no_grad(), plain_versions():
        for prompt, new in rows:
            seq = torch.tensor([list(prompt) + list(new[:-1])],
                               device=LLAMA_DEVICE)
            hidden = model(seq, return_hidden=True)
            out.append(model.lm_head(hidden[0, len(prompt) - 1:])
                       .float().cpu())
    return out


def step_stats(got, ref, fp32, tokens):
    """A path's every step against the fp32 anchor: ``got``, ``ref`` and
    ``fp32`` are the path's, the reference's (teacher-forced on the
    path's ``tokens``) and the anchor's logits ``[V]`` a step. A step's
    limit is LLAMA_NOISE_RATIO times the reference's distance from fp32
    at that step (or LOGITS_ATOL); a token is held where fp32's two best
    scores lie at least twice that distance apart. Returns (the worst
    step's share of its limit, that step, the path's largest distance,
    the reference's, tokens held, the held steps whose token is not
    fp32's best)."""
    worst, far, ref_far, held, wrong = (0.0, 0), 0.0, 0.0, 0, []
    for t, token in enumerate(tokens):
        err = (got[t] - fp32[t]).abs().max().item()
        near = (ref[t] - fp32[t]).abs().max().item()
        limit = max(LLAMA_NOISE_RATIO * near, LOGITS_ATOL)
        share = err / limit if np.isfinite(err) else float("inf")
        worst = max(worst, (share, t))
        far, ref_far = max(far, err), max(ref_far, near)
        top = fp32[t].topk(2)
        if (top.values[0] - top.values[1]).item() >= max(LOGITS_ATOL,
                                                         2 * near):
            held += 1
            if token != top.indices[0].item():
                wrong.append(t)
    return worst[0], worst[1], far, ref_far, held, wrong


def hold_steps(what, got, ref, fp32, tokens):
    """step_stats, failing where a step passes its limit or a held token
    is not fp32's best. Returns (worst share, the path's largest
    distance, the reference's, tokens held)."""
    share, step, far, ref_far, held, wrong = step_stats(got, ref, fp32,
                                                        tokens)
    if share > 1 or wrong:
        raise AssertionError(
            f"{what}: step {step}'s logits at {share:.3f} of their limit "
            f"({LLAMA_NOISE_RATIO} x the reference's distance from fp32, "
            f"or {LOGITS_ATOL}); tokens off fp32's clear best at steps "
            f"{wrong}")
    return share, far, ref_far, held


# faults planted in the decode steps of the kernel path (kernel 7 run on
# altered inputs), which hold_steps must refuse: the softmax scale of
# D = 64 at D = 128, and (on a GQA model) query head h reading KV head
# h % KV in place of h // rep
LLAMA_FAULTS = ("scale", "kv_heads")


def llama_faults_refused(what, engine, prompt, card):
    """Generate ``prompt`` with each applicable LLAMA_FAULTS fault in the
    decode steps, teacher-force the plain versions and the fp32 anchor on
    its tokens, and fail unless hold_steps refuses it."""
    import torch

    from deepspeed_tpu_torch.models import llama

    real = llama.decode_attention_tp
    cfg = engine.model_config
    rep = cfg.num_attention_heads // cfg.kv_heads

    def tiled(t):
        return t[:, :, ::rep].repeat(1, 1, rep, 1)

    faults = {"scale": lambda q, k, v, index, **kw: real(
        q * float(np.sqrt(2)), k, v, index, **kw),
        "kv_heads": lambda q, k, v, index, **kw: real(
            q, tiled(k), tiled(v), index, **kw)}
    ids = torch.from_numpy(prompt)[None].to(LLAMA_DEVICE)
    refused = {}
    for name in LLAMA_FAULTS if rep > 1 else LLAMA_FAULTS[:1]:
        with mock.patch.object(llama, "decode_attention_tp", faults[name]):
            out, calls = run_generate(engine, ids, LLAMA_NEW)
        new = out[:, len(prompt):]
        with plain_versions():
            _, plain = run_generate(engine, ids, LLAMA_NEW, forced=new)
        fp32 = llama_fp32_steps(engine, [(prompt.tolist(),
                                          new[0].tolist())])[0]
        share, step, far, ref_far, _, wrong = step_stats(
            [c[0] for c in calls], [c[0] for c in plain], fp32,
            new[0].tolist())
        refused[name] = (share > 1 or bool(wrong),
                         f"step {step} at {share:.3f} of its limit (max "
                         f"{far:.4g} from fp32's, plain versions "
                         f"{ref_far:.4g}), tokens off at {wrong}")
    report = {name: text for name, (_, text) in refused.items()}
    if not all(ok for ok, _ in refused.values()):
        raise AssertionError(f"{what}: the gate passed a planted fault: "
                             f"{report}")
    log(f"{what}: the gate refuses each fault planted in the decode steps "
        f"on a {len(prompt)}-token prompt: {report} [{card}]")


def llama_engine(seed, **cut):
    """``init_inference`` (bf16) on a Llama-2 7B-width model whose
    weights are drawn on the card from ``seed``; ``cut`` overrides the
    config (depth, KV heads)."""
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel

    engine = init_inference(LlamaModel(LlamaConfig.llama2_7b(**cut),
                                       device=LLAMA_DEVICE, seed=seed))
    torch.cuda.synchronize()
    return engine


def llama_generate(what, engine, prompts, card):
    """One greedy ``generate`` a prompt (B = 1) of LLAMA_NEW tokens, the
    prefill timed alone first (a 1-token call); launch counts zeroed just
    before the prompts and read just after. Then the plain versions and
    the fp32 anchor teacher-forced on each prompt's tokens, and every
    step held to fp32 (hold_steps). Returns the counts."""
    import torch

    run_generate(engine, torch.from_numpy(prompts[0][:16])[None].to(
        LLAMA_DEVICE), 2)
    torch.cuda.reset_peak_memory_stats()
    solo, timing = {}, []
    reset_launch_counts()
    for p in prompts:
        ids = torch.from_numpy(p)[None].to(LLAMA_DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_generate(engine, ids, 1)
        t1 = time.perf_counter()
        out, calls = run_generate(engine, ids, LLAMA_NEW)
        t2 = time.perf_counter()
        if not all(torch.isfinite(c).all() for c in calls):
            raise AssertionError(f"{what} prompt {len(p)}: non-finite "
                                 f"logits")
        solo[len(p)] = (out[:, len(p):], calls)
        timing.append(f"{len(p)}: prefill {1e3 * (t1 - t0):.2f} ms, "
                      f"decode {(LLAMA_NEW - 1) / ((t2 - t1) - (t1 - t0)):.1f}"
                      f" tokens/s")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    layers = engine.model_config.num_hidden_layers
    want = {"flash_fwd": 2 * len(prompts) * layers,
            "decode_append": (LLAMA_NEW - 1) * len(prompts) * layers}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"{what}: launches {counts}, not {want}")
    plain = {}
    with plain_versions():
        for p in prompts:
            plain[len(p)] = run_generate(
                engine, torch.from_numpy(p)[None].to(LLAMA_DEVICE), LLAMA_NEW,
                forced=solo[len(p)][0])[1]
    anchors = llama_fp32_steps(engine, [(p.tolist(), solo[len(p)][0][0]
                                         .tolist()) for p in prompts])
    held = [hold_steps(f"{what} prompt {len(p)}",
                       [c[0] for c in solo[len(p)][1]],
                       [c[0] for c in plain[len(p)]], fp32,
                       solo[len(p)][0][0].tolist())
            for p, fp32 in zip(prompts, anchors)]
    log(f"{what}: {engine.model_config.num_hidden_layers} layers, "
        f"{sum(p.numel() for p in engine.module.parameters()) / 1e9:.3f} B "
        f"parameters (bf16), {engine.model_config.kv_heads} KV heads; "
        f"prompts {'; '.join(timing)}; peak memory {peak / 1e9:.2f} GB; "
        f"every step's logits from fp32's (teacher-forced on the kernels' "
        f"tokens): kernels max {[round(h[1], 4) for h in held]}, plain "
        f"versions max {[round(h[2], 4) for h in held]}, worst step "
        f"{max(h[0] for h in held):.3f} of its limit ({LLAMA_NOISE_RATIO} x "
        f"plain or {LOGITS_ATOL}); tokens fp32's best at "
        f"{sum(h[3] for h in held)}/{len(prompts) * LLAMA_NEW} steps with "
        f"a clear best, none off; launches {counts} [{card}]")
    return counts


def llama_padded(engine, prompts, card):
    """The prompts left-padded into one batch, greedy: every decode step
    on the append kernel with each row's first key. The plain versions
    (the same padded batch) and the fp32 anchor (each row's prompt alone)
    teacher-forced on its tokens, and every step of each row held to
    fp32 (hold_steps). Returns the launch counts."""
    import torch

    T = max(len(p) for p in prompts)
    ids = torch.zeros((len(prompts), T), dtype=torch.long)
    mask = torch.zeros((len(prompts), T), dtype=torch.int32)
    for b, p in enumerate(prompts):
        ids[b, T - len(p):] = torch.from_numpy(p)
        mask[b, T - len(p):] = 1
    ids, mask = ids.to(LLAMA_DEVICE), mask.to(LLAMA_DEVICE)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out, calls = run_generate(engine, ids, LLAMA_NEW, attention_mask=mask)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    steps = (LLAMA_NEW - 1) * engine.model_config.num_hidden_layers
    want = {"decode_append": steps, "decode_append_padded": steps,
            "flash_fwd": 0}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"llama padded generate launched {counts}, "
                             f"not {want}")
    new = out[:, T:]
    with plain_versions():
        plain = run_generate(engine, ids, LLAMA_NEW, forced=new,
                             attention_mask=mask)[1]
    anchors = llama_fp32_steps(engine, [(p.tolist(), new[b].tolist())
                                        for b, p in enumerate(prompts)])
    held = [hold_steps(f"llama padded generate row {b} ({len(p)} tokens)",
                       [c[b] for c in calls], [c[b] for c in plain],
                       anchors[b], new[b].tolist())
            for b, p in enumerate(prompts)]
    log(f"llama gqa padded generate: {len(prompts)} x "
        f"({'/'.join(str(len(p)) for p in prompts)} left-padded to {T}) + "
        f"{LLAMA_NEW} tokens in {secs:.3f} s; every step's logits from "
        f"fp32's (each row's prompt alone, teacher-forced): kernels max "
        f"{[round(h[1], 4) for h in held]}, plain versions (padded) max "
        f"{[round(h[2], 4) for h in held]}, worst step "
        f"{max(h[0] for h in held):.3f} of its limit; tokens fp32's best at "
        f"{sum(h[3] for h in held)}/{len(prompts) * LLAMA_NEW} steps with "
        f"a clear best, none off; launches {counts} [{card}]")
    return counts


def llama_gqa_copy(seed, card):
    """Device ms of one decode step's KV-head repeat (one cache, K or V,
    at (b)'s padded batch: B = 4, S = 4096, 8 KV heads to 32) beside
    kernel 7's on the repeated caches at idx 1000."""
    import torch

    from deepspeed_tpu_torch.models.llama import repeat_kv
    from deepspeed_tpu_torch.ops.decode_attention import decode_attention

    B, S, KV, H, D = 4, 4096, 8, 32, 128
    gen = torch.Generator(device=LLAMA_DEVICE).manual_seed(seed)
    kc, vc = (torch.randn((B, S, KV, D), generator=gen, device=LLAMA_DEVICE)
              .to(torch.bfloat16) for _ in range(2))
    q = torch.randn((B, 1, H, D), generator=gen, device=LLAMA_DEVICE).to(
        torch.bfloat16)
    index = torch.tensor(1000, dtype=torch.int32, device=LLAMA_DEVICE)
    copy_ms = device_ms(lambda: repeat_kv(kc, H // KV))
    ke, ve = repeat_kv(kc, H // KV), repeat_kv(vc, H // KV)
    kernel_ms = device_ms(lambda: decode_attention(q, ke, ve, index))
    log(f"llama gqa: a decode step repeats each layer's K and V caches "
        f"[{B}, {S}, {KV}, {D}] -> {H} heads: {copy_ms:.4f} ms a cache (2 a"
        f" layer: {2 * copy_ms:.4f} ms), against kernel 7's {kernel_ms:.4f}"
        f" ms on the repeated caches at idx 1000 [{card}]")
    return copy_ms, kernel_ms


def llama_train(seed, stage, batch, card):
    """(c)'s engine at ``stage``: step-1 gradients (reduced and gathered
    by the stage), one warm-up and LLAMA_TRAIN_STEPS timed steps, the
    launch and collective counts zeroed just before them. Returns
    (engine, grads, losses, counts)."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.llama import (LlamaConfig,
                                                  LlamaForTraining)
    from deepspeed_tpu_torch.tools.profile_training import (BENCH_CONFIG,
                                                            timed_steps)

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=LLAMA_TRAIN_LAYERS,
                                remat=True, remat_policy="dots")
    config = {**BENCH_CONFIG,
              "train_micro_batch_size_per_gpu": LLAMA_TRAIN_BATCH,
              "zero_optimization": {"stage": stage}}
    engine = deepspeed_tpu_torch.initialize(
        model=LlamaForTraining(cfg, device=LLAMA_DEVICE, seed=seed),
        config=config)[0]
    engine.module(batch).backward()
    grads = {n: g.detach().clone()
             for n, g in engine.gathered_grads().items()}
    engine.zero_grad()
    first, _ = timed_steps(engine, batch, 1)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    comm.reset_counts()
    losses, secs = timed_steps(engine, batch, LLAMA_TRAIN_STEPS)
    counts = launch_counts()
    collectives = {k: comm.counts.get(k, 0) for k in
                   ("all_gather", "reduce_scatter", "all_reduce")}
    peak = torch.cuda.max_memory_allocated()
    losses = first + losses
    what = f"llama training stage {stage}"
    # random weights: the head's logits have a standard deviation of 0.02
    # sqrt(C) over unit-RMS hidden states, which lifts the first loss
    # from ln V by about their variance / 2 (0.82 at C = 4096)
    check_losses(what, losses, float(np.log(cfg.vocab_size))
                 + cfg.hidden_size * 0.02 ** 2 / 2)
    check_per_step(what, counts, LLAMA_TRAIN_STEPS,
                   {k: LLAMA_TRAIN_LAYERS for k in
                    ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")})
    if engine._zero is not None:
        plan = {k: v * LLAMA_TRAIN_STEPS for k, v in engine._zero.comm_plan(
            1, recompute=True).items()}
        if collectives != plan:
            raise AssertionError(f"{what}: collectives {collectives}, the "
                                 f"plan {plan}")
    tokens = LLAMA_TRAIN_BATCH * LLAMA_TRAIN_SEQ
    n = sum(p.numel() for p in engine.module.parameters())
    if engine._zero is not None:
        n = sum(int(np.prod(e.pplan.shape)) for e in engine._zero.entries)
    # bench.py's accounting without the embedding lookup (no matmul):
    # 6 N of the matrices, head included, plus causal attention 6 L T C
    flops = (6 * (n - cfg.vocab_size * cfg.hidden_size)
             + 6 * LLAMA_TRAIN_LAYERS * LLAMA_TRAIN_SEQ * cfg.hidden_size)
    tokens_per_s = LLAMA_TRAIN_STEPS * tokens / secs
    per_step = {k: counts[k] / LLAMA_TRAIN_STEPS
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    log(f"{what}: 7B width, {LLAMA_TRAIN_LAYERS} layers ({n / 1e9:.3f} B "
        f"parameters), batch {LLAMA_TRAIN_BATCH} x {LLAMA_TRAIN_SEQ}, bf16, "
        f"dots remat, fused AdamW, clip 1.0: {LLAMA_TRAIN_STEPS} steps in "
        f"{secs:.3f} s ({1e3 * secs / LLAMA_TRAIN_STEPS:.1f} ms/step, "
        f"{tokens_per_s:.0f} tokens/s, MFU "
        f"{tokens_per_s * flops / PEAK_FLOPS['bfloat16']:.4f} of 989 TF/s "
        f"at {flops / 1e9:.3f} GFLOP a token), peak memory {peak / 1e9:.2f} "
        f"GB; losses {[round(x, 4) for x in losses]}; collectives per step "
        f"{ {k: v / LLAMA_TRAIN_STEPS for k, v in collectives.items()} }; "
        f"launches per step {per_step} [{card}]")
    return engine, grads, losses, counts


def llama_tp_ids(seed):
    import torch

    rng = np.random.default_rng(seed + 41)
    return torch.tensor(rng.integers(1, 32000, (2, 128)), device=LLAMA_DEVICE)


def llama_tp_rank_main(rank, world, store, seed, out_dir):
    """One tp rank of (d) (a spawned process): join the gloo group on
    ``cuda:0``, draw the 7B-width model of LLAMA_TP_LAYERS layers whole on
    the card from ``seed``, keep this rank's slices through
    ``init_inference(tensor_parallel=...)`` and generate; writes its
    tokens, each step's logits, its launch and collective counts and the
    heads of every launch of kernels 1 and 7."""
    import pickle
    import traceback

    try:
        os.environ["LOCAL_RANK"] = "0"
        import torch

        from deepspeed_tpu_torch import comm
        from deepspeed_tpu_torch.ops import decode_attention as da
        from deepspeed_tpu_torch.ops import flash_attention as fa

        torch.backends.cuda.matmul.allow_tf32 = False
        comm.init_distributed(dist_backend="gloo",
                              init_method=f"file://{store}", rank=rank,
                              world_size=world, timeout=TP_TIMEOUT,
                              verbose=False)
        from deepspeed_tpu_torch import init_inference
        from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel

        engine = init_inference(
            LlamaModel(LlamaConfig.llama2_7b(
                num_hidden_layers=LLAMA_TP_LAYERS), device=LLAMA_DEVICE,
                seed=seed), tensor_parallel={"tp_size": world})
        ids = llama_tp_ids(seed)
        heads = collections.defaultdict(collections.Counter)

        def spy(name, fn, dim):
            def call(q, *args, **kwargs):
                heads[name][q.shape[dim]] += 1
                return fn(q, *args, **kwargs)
            return call

        run_generate(engine, ids, 2)  # warm-up
        with mock.patch.object(fa, "_fwd_launch",
                               spy("flash_fwd", fa._fwd_launch, 1)), \
                mock.patch.object(da, "_append_launch",
                                  spy("decode_append", da._append_launch,
                                      2)):
            torch.cuda.synchronize()
            reset_launch_counts()
            comm.reset_counts()
            t0 = time.perf_counter()
            out, calls = run_generate(engine, ids, LLAMA_TP_NEW)
            secs = time.perf_counter() - t0
            counts = launch_counts()
            collectives = dict(comm.counts)
        res = {"tokens": out[:, ids.shape[1]:].tolist(), "calls": calls,
               "counts": counts, "collectives": collectives, "secs": secs,
               "heads": {k: dict(v) for k, v in heads.items()},
               "split": sorted(n for n, s in engine.param_shardings.items()
                               if s is not None)}
        comm.destroy_process_group()
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def llama_tensor_parallel(seed, card):
    """(d): TP_SIZE spawned gloo ranks on ``cuda:0``: both ranks' tokens
    bit for bit rank 0's, every launch of kernels 1 and 7 at 16 heads,
    and 2 L + 1 all-reduces (the rows' sums and the vocab-parallel
    lookup) and one all-gather (the head's) a forward; then a tp=1
    engine in this process and the fp32 anchor teacher-forced on rank
    0's tokens, and every step held to fp32 (hold_steps, tp=1 the
    reference). Returns rank 0's launch counts."""
    import torch

    t0 = time.perf_counter()
    ranks = spawn_tp_ranks(llama_tp_rank_main, seed, TP_SIZE)
    secs = time.perf_counter() - t0
    first = ranks[0]
    heads = 32 // TP_SIZE
    forwards = LLAMA_TP_NEW
    coll = {"all_reduce": (2 * LLAMA_TP_LAYERS + 1) * forwards,
            "all_gather": forwards}
    for rank, res in enumerate(ranks):
        if res["tokens"] != first["tokens"]:
            raise AssertionError(f"llama tp: rank {rank}'s tokens differ "
                                 f"from rank 0's")
        for name in ("flash_fwd", "decode_append"):
            if set(res["heads"].get(name, {})) != {heads}:
                raise AssertionError(f"llama tp rank {rank}: {name} at heads"
                                     f" {res['heads'].get(name)}, not only "
                                     f"{heads}")
        got = {k: res["collectives"].get(k, 0) for k in coll}
        if got != coll:
            raise AssertionError(f"llama tp rank {rank}: collectives {got},"
                                 f" not {coll}")
    engine = llama_engine(seed, num_hidden_layers=LLAMA_TP_LAYERS)
    ids = llama_tp_ids(seed)
    new = torch.tensor(first["tokens"])
    ref = run_generate(engine, ids, LLAMA_TP_NEW, forced=new)[1]
    anchors = llama_fp32_steps(engine, [(ids[b].tolist(), new[b].tolist())
                                        for b in range(len(new))])
    held = [hold_steps(f"llama tp row {b}", [c[b] for c in first["calls"]],
                       [c[b] for c in ref], anchors[b], new[b].tolist())
            for b in range(len(new))]
    del engine
    torch.cuda.empty_cache()
    log(f"llama tensor parallel: {TP_SIZE} gloo ranks on cuda:0, 7B width, "
        f"{LLAMA_TP_LAYERS} layers, {heads} heads a rank, split "
        f"{len(first['split'])} tensors (vocabulary included), in "
        f"{secs:.1f} s: both ranks' tokens bit for bit rank 0's; every "
        f"step's logits from fp32's (teacher-forced on rank 0's tokens): "
        f"tp=2 max {[round(h[1], 4) for h in held]}, tp=1 max "
        f"{[round(h[2], 4) for h in held]}, worst step "
        f"{max(h[0] for h in held):.3f} of its limit; tokens fp32's best at "
        f"{sum(h[3] for h in held)}/{len(new) * LLAMA_TP_NEW} steps with a "
        f"clear best, none off; collectives {coll} over {forwards} "
        f"forwards; kernels 1/7 at {heads} heads on every launch "
        f"({first['heads']}); generate {first['secs']:.3f} s a rank over "
        f"gloo (host-staged, nothing of NCCL's speed); launches "
        f"{first['counts']} [{card}]")
    return first["counts"]


def llama_pretrained(state, card):
    """(e): (c)'s trained weights, cut to LLAMA_HF_LAYERS layers, written
    as an HF directory in bf16 (``save_hf_llama``: ``pytorch_model.bin``
    and ``config.json``), read back by ``from_pretrained``: its logits on
    a 2 x 128 prompt bit for bit those of ``init_inference`` on the
    source model. The directory is deleted. Returns the launch counts of
    the two forwards."""
    import shutil
    import tempfile

    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference import from_pretrained
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from deepspeed_tpu_torch.runtime.state_dict_factory import save_hf_llama

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=LLAMA_HF_LAYERS)
    source = LlamaModel(cfg, device="meta")
    source.load_state_dict(state, assign=True)
    path = tempfile.mkdtemp(prefix="chip_smoke_llama_hf")
    try:
        t0 = time.perf_counter()
        save_hf_llama(path, cfg, state, dtype=torch.bfloat16)
        t1 = time.perf_counter()
        loaded = from_pretrained(path, dtype=torch.bfloat16)
        t2 = time.perf_counter()
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
    finally:
        shutil.rmtree(path, ignore_errors=True)
    engine = init_inference(source)
    ids = llama_tp_ids(7)
    reset_launch_counts()
    got, want = loaded(ids), engine(ids)
    torch.cuda.synchronize()
    counts = launch_counts()
    if not torch.equal(got, want):
        raise AssertionError(
            f"llama from_pretrained: logits differ from the source model's "
            f"by {(got - want).abs().max().item()}")
    if counts["flash_fwd"] != 2 * LLAMA_HF_LAYERS:
        raise AssertionError(f"llama from_pretrained: launches {counts}")
    log(f"llama from_pretrained: (c)'s weights at {LLAMA_HF_LAYERS} layers "
        f"written as an HF directory ({size / 1e9:.3f} GB, bf16 "
        f"pytorch_model.bin) in {t1 - t0:.1f} s, loaded in {t2 - t1:.1f} s; "
        f"logits on 2 x 128 tokens bit for bit the source model's; the "
        f"directory deleted; launches {counts} [{card}]")
    return counts


def phase_llama(seed, card):
    """Phase 12: the Llama family through ``init_inference``,
    ``initialize`` and ``from_pretrained`` (module docstring). Returns
    the launch counts of each ``llama_*`` path."""
    import torch

    from deepspeed_tpu_torch import comm

    by_path = {}
    vocab = 32000
    rng = np.random.default_rng(seed + 31)
    prompts = [rng.integers(1, vocab, n) for n in LLAMA_PROMPTS]
    t0 = time.perf_counter()
    engine = llama_engine(seed)
    log(f"llama: Llama-2 7B drawn on the card and cast to bf16 in "
        f"{time.perf_counter() - t0:.1f} s")
    by_path["llama_generate"] = llama_generate("llama 7b", engine, prompts,
                                               card)
    llama_faults_refused("llama 7b", engine, prompts[0], card)
    del engine
    torch.cuda.empty_cache()

    engine = llama_engine(seed, **LLAMA_GQA)
    by_path["llama_gqa"] = llama_generate("llama gqa", engine, prompts, card)
    by_path["llama_gqa_padded"] = llama_padded(engine, prompts, card)
    llama_faults_refused("llama gqa", engine, prompts[0], card)
    del engine
    torch.cuda.empty_cache()
    llama_gqa_copy(seed, card)

    batch = {"input_ids": torch.from_numpy(np.random.default_rng(
        seed + 37).integers(0, vocab, (LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ))
        ).to(LLAMA_DEVICE)}
    engine, grads, losses, by_path["llama_training"] = llama_train(
        seed, 0, batch, card)
    state = {k: v.detach().cpu().clone()
             for k, v in engine.module.model.state_dict().items()
             if not k.startswith("layers.")
             or int(k.split(".")[1]) < LLAMA_HF_LAYERS}
    del engine
    torch.cuda.empty_cache()
    import tempfile

    store = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_llama"),
                         "store")
    comm.init_distributed(init_method=f"file://{store}", rank=0,
                          world_size=1, verbose=False)
    try:
        engine, grads3, losses3, by_path["llama_zero3"] = llama_train(
            seed, 3, batch, card)
        del engine
    finally:
        comm.destroy_process_group()
    torch.cuda.empty_cache()
    loss_err = max(abs(a - b) for a, b in zip(losses3, losses))
    grad_err = {n: ((grads3[n].float() - g.float()).norm()
                    / g.float().norm().clamp_min(1e-30)).item()
                for n, g in grads.items()}
    worst = max(grad_err, key=grad_err.get)
    if loss_err > TRAIN_LOSS_ATOL or grad_err[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError(
            f"llama training stage 3 vs stage 0: losses {losses3} vs "
            f"{losses} (max diff {loss_err}); step-1 gradient {worst} "
            f"relative L2 {grad_err[worst]}")
    log(f"llama training stage 3 vs stage 0: losses max |diff| "
        f"{loss_err:.3g} (limit {TRAIN_LOSS_ATOL}, bit-equal: "
        f"{losses3 == losses}); step-1 gradients relative L2 max "
        f"{grad_err[worst]:.3g} at {worst} (limit {TRAIN_GRAD_RTOL})")
    del grads, grads3

    by_path["llama_tp"] = llama_tensor_parallel(seed, card)
    by_path["llama_pretrained"] = llama_pretrained(state, card)
    return by_path


# ---------------------------------------------------------------------------
# phase 13: BERT-large under tensor parallelism
# ---------------------------------------------------------------------------
# legs (b) and (c), and (a)'s twin that (b) is held to, cut to 4 of the 24
# layers: every step's gloo collectives are staged through the host, and
# full depth in all four would not fit the phase's ~90 s
BTP_LAYERS = 4
BTP_STEPS = 3
# BERT-large's 16 heads split over TP_SIZE ranks
BTP_HEADS = 8
# a step-1 gradient beyond its relative limit passes only as close to an
# fp32 forward's as its reference path's distance times this: at 24
# layers bf16 rounding alone parts two correct paths by more than 5 % on
# the deep layers' query biases (their gradient near the noise: the key
# biases', exactly zero, read 0.30 of it), and the tp path rounds the
# row-parallel partial sums in bf16 besides (2 more roundings a layer)
BTP_NOISE_RATIO = 2.0
# (e) tp faults planted in (a)'s step-1 gradients, which (a)'s gradient
# gate must refuse: no f before q/k/v (the attention input's gradient
# keeps only this rank's heads' share), and the decoder bias's gradient
# left as this rank's slice (a plain slice in place of the gather). Rank
# 1 taking rank 0's rows of the layout is no fault here: the workload's
# 4 global patterns over 16 heads give both ranks the same 8 rows
BTP_FAULTS = ("no_f_before_qkv", "decoder_bias_slice")
# the attention kernels of the legs, spied on at their ``_*_launch``
BTP_KERNELS = ("block_sparse_fwd", "block_sparse_bwd_dq",
               "block_sparse_bwd_dkv", "flash_fwd", "flash_bwd_dq",
               "flash_bwd_dkv")


def btp_config(sparse, policy, stage=0):
    """bench_bert.py's keys (phase 8's) on ``{"mesh": {"tp": 2}}``."""
    from deepspeed_tpu_torch.tools.profile_training import (
        BERT_CONFIG, BERT_DENSE_SHAPE, BERT_SPARSE, BERT_SPARSE_SHAPE)

    config = {"train_micro_batch_size_per_gpu":
              (BERT_SPARSE_SHAPE if sparse else BERT_DENSE_SHAPE)[0],
              **BERT_CONFIG, "zero_optimization": {"stage": stage},
              "mesh": {"tp": TP_SIZE},
              "tensor_parallel": {"policy": policy}}
    if sparse:
        config["sparse_attention"] = dict(BERT_SPARSE)
    return config


def btp_fault(name):
    """A context planting the BTP_FAULTS fault ``name`` in the port's
    BERT (module globals looked up at each forward)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.models import bert as mb

    def no_f(layers, x, dtype):
        return [F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))
                for layer in layers]

    def plain_slice(x, tp):
        k = x.shape[0] // tp.size
        return x.narrow(0, tp.rank * k, k)

    if name == "no_f_before_qkv":
        return mock.patch.object(mb, "column_projections", no_f)
    if name == "decoder_bias_slice":
        return mock.patch.object(mb, "scatter_to_tp", plain_slice)
    raise ValueError(name)


def btp_run(engine, batch, what, want, faults=()):
    """Step-1 gradients (whole, on the host), and those of each planted
    fault of ``faults``; one warm-up and BTP_STEPS timed steps with the
    launch and collective counts zeroed just before and read just after;
    each step's collectives against the plan and each kernel of ``want``
    launched ``want[name]`` times a step."""
    import torch

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.tools.profile_training import timed_steps

    grads = {}
    for fault in (None,) + tuple(faults):
        with btp_fault(fault) if fault else contextlib.nullcontext():
            engine.module(batch).backward()
            grads[fault] = {n: g.cpu() for n, g in
                            engine.gathered_grads().items()}
        engine.zero_grad()
    faulty = {k: v for k, v in grads.items() if k}
    grads = grads[None]
    first, _ = timed_steps(engine, batch, 1)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    comm.reset_counts()
    losses, secs = timed_steps(engine, batch, BTP_STEPS)
    counts = launch_counts()
    plan = engine._zero.comm_plan(1, recompute=engine.module.config.remat)
    for k, v in engine.module.comm_plan(*batch["input_ids"].shape).items():
        plan[k] = plan.get(k, 0) + v
    plan = {k: v * BTP_STEPS for k, v in plan.items()}
    collectives = {k: comm.counts.get(k, 0) for k in plan}
    if collectives != plan:
        raise AssertionError(f"{what}: collectives {collectives} in "
                             f"{BTP_STEPS} steps, the plan {plan}")
    check_per_step(what, counts, BTP_STEPS, want)
    return {"losses": first + losses, "ms": 1e3 * secs / BTP_STEPS,
            "peak": torch.cuda.max_memory_allocated(), "counts": counts,
            "collectives": collectives}, grads, faulty


def btp_rank_main(rank, world, store, seed, out_dir):
    """One rank of phase 13 (a spawned process): join the gloo group on
    ``cuda:0`` and train BERT-large through ``initialize(config={"mesh":
    {"tp": world}})``: (a) the sparse workload at full depth, ZeRO 0,
    the ``"bert"`` policy, then ``eval_batch`` on its engine; its twin at
    BTP_LAYERS; (b) ZeRO 3 with ``partition_activations`` at BTP_LAYERS;
    (c) the dense 64 x 128 leg at BTP_LAYERS under ``"auto"``. Writes per
    engine the losses, ms a step, peak memory, launch and collective
    counts; the heads of every attention launch; (a)'s replicated
    parameters' hash, split-weight bytes and ``eval_batch`` check; rank 0
    also the step-1 gradients (whole) of every leg, and (e) those of (a)
    under each planted fault of BTP_FAULTS, for the parent."""
    import gc
    import hashlib
    import pickle
    import traceback

    try:
        os.environ["LOCAL_RANK"] = "0"
        import torch
        import torch.distributed as tdist

        import deepspeed_tpu_torch
        from deepspeed_tpu_torch import comm
        from deepspeed_tpu_torch.ops import flash_attention as fa
        from deepspeed_tpu_torch.ops.sparse_attention import \
            block_sparse_kernel as bs
        from deepspeed_tpu_torch.tools.profile_training import (
            bert_batch, bert_model)

        torch.backends.cuda.matmul.allow_tf32 = False
        comm.init_distributed(dist_backend="gloo",
                              init_method=f"file://{store}", rank=rank,
                              world_size=world, timeout=TP_TIMEOUT,
                              verbose=False)
        if tdist.get_backend() != "gloo":
            raise AssertionError("BERT tp ranks not on gloo")
        heads = collections.defaultdict(collections.Counter)

        def spy(module, name, label):
            fn = getattr(module, name)

            def call(q, *args, **kwargs):
                heads[label][q.shape[1]] += 1
                return fn(q, *args, **kwargs)
            return mock.patch.object(module, name, call)

        res, grads = {}, {}
        with contextlib.ExitStack() as stack:
            for label in BTP_KERNELS:
                module = bs if label.startswith("block_sparse") else fa
                name = "_" + label.rsplit("_", 1)[-1] + "_launch"
                stack.enter_context(spy(module, name, label))
            for label, sparse, layers, stage, policy, extra in (
                    ("sparse", True, None, 0, "bert", {}),
                    ("sparse4", True, BTP_LAYERS, 0, "bert", {}),
                    ("zero3", True, BTP_LAYERS, 3, "bert",
                     {"partition_activations": True}),
                    ("dense", False, BTP_LAYERS, 0, "auto", {})):
                whole = bert_model(seed, sparse, layers, **extra)
                engine = deepspeed_tpu_torch.initialize(
                    model=whole, config=btp_config(sparse, policy,
                                                   stage))[0]
                n_layer = whole.config.num_hidden_layers
                # once a layer a step: the dots policy saves the forward
                prefix = "block_sparse" if sparse else "flash"
                want = {k: n_layer if k.startswith(prefix) else 0
                        for k in BTP_KERNELS}
                batch = bert_batch(whole.config.vocab_size, seed,
                                   engine.device, sparse=sparse)
                res[label], grads[label], faulty = btp_run(
                    engine, batch, f"bert tp {label}", want,
                    BTP_FAULTS if label == "sparse" else ())
                if faulty:
                    grads["faults"] = faulty
                if label == "sparse":
                    res["layers"] = n_layer
                    specs = engine.module.param_specs()
                    split = {n for n, sp in specs.items() if sp is not None}
                    res["split_bytes"] = (
                        sum(4 * p.numel() for n, p in
                            engine.module.named_parameters() if n in split),
                        sum(4 * p.numel() for n, p in
                            whole.named_parameters() if n in split))

                    def digest(names):
                        h = hashlib.sha256()
                        for n, p in engine.module.named_parameters():
                            if n in names:
                                h.update(p.detach().cpu().numpy().tobytes())
                        return h.hexdigest()

                    every = {n for n, _ in engine.module.named_parameters()}
                    res["replicated_sha256"] = digest(every - split)
                    # (d) eval_batch: a no-grad forward's loss, the
                    # parameters untouched
                    before = digest(every)
                    evaluated = float(engine.eval_batch(batch))
                    with torch.no_grad():
                        forward = float(engine.module(batch))
                    res["eval"] = {"loss": evaluated, "forward": forward,
                                   "unchanged": digest(every) == before}
                # stage 3's gather hooks tie the engine in reference
                # cycles: collect them before the next engine's peak
                del engine, whole
                gc.collect()
                torch.cuda.empty_cache()
        res["heads"] = {k: dict(v) for k, v in heads.items()}
        if rank == 0:
            res["grads"] = grads
        comm.destroy_process_group()
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def btp_grad_check(grads, ref, rtol, exact=None):
    """Each step-1 gradient of ``grads`` against ``ref``'s: within
    ``rtol`` relative L2, or, where bf16 rounding leaves it further, no
    further from ``exact`` (an fp32 forward's gradient on the same weights
    and batch, through the plain versions) than BTP_NOISE_RATIO times
    ``ref``'s distance from it; a
    key bias (exact gradient zero: bf16 noise alone) also passes below
    KEY_BIAS_NOISE of its layer's query-bias gradient in ``ref`` (phase
    8's rule). Returns (failing tensors with their numbers, the worst
    relative L2 and its tensor among the other tensors, the largest
    key-bias share, the largest distance ratio among the tensors the fp32
    rule held, how many it held)."""
    shares = key_bias_shares(grads, ref)
    rel = rel_l2(grads, ref)
    failed, ratios = {}, {}
    for name, err in rel.items():
        if err <= rtol or shares.get(name, np.inf) <= KEY_BIAS_NOISE:
            continue
        if exact is not None:
            g, r, e = (t[name].float().cpu() for t in (grads, ref, exact))
            ratios[name] = ((g - e).norm() / (r - e).norm().clamp_min(
                1e-30)).item()
            if ratios[name] <= BTP_NOISE_RATIO:
                continue
        failed[name] = (err, ratios.get(name))
    worst = max((n for n in rel if n not in shares), key=rel.get)
    return (failed, (rel[worst], worst), max(shares.values()),
            max(ratios.values(), default=0.0), len(ratios))


def phase_bert_tp(seed, card):
    """BERT-large at its published widths under tensor parallelism on the
    one card: the tp=1 references here (phase 8's sparse engine at full
    depth and its dense leg at BTP_LAYERS: step-1 gradients and 1 +
    BTP_STEPS losses), then TP_SIZE spawned ranks on ``cuda:0`` over a
    gloo group (NCCL refuses two ranks on one device; gloo stages CUDA
    tensors through the host) train the same models from the same seed
    and batch (:func:`btp_rank_main`). Holds: the ranks' losses bit-equal
    on every leg and (a)'s replicated parameters bit-equal; (a) within
    TPT_LOSS_ATOL (losses) and TPT_GRAD_RTOL (step-1 gradients merged from
    the slices, relative L2 a tensor) of tp=1, (c) likewise of its tp=1
    leg, a gradient beyond that no further from an fp32 forward's (same
    weights and batch, computed here through the plain versions) than
    BTP_NOISE_RATIO times tp=1's (:func:`btp_grad_check`); (b), ZeRO 3 with
    ``partition_activations``, within ZERO_LOSS_ATOL and ZERO_GRAD_RTOL
    of (a)'s stage-0 twin at the same depth; every leg's collectives a
    step equal to the plan; kernels
    10-12 launched once a layer a step on (a) and (b) and kernels 1-3
    (non-causal) on (c), every launch at 8 heads, and no other attention
    kernel; (d) ``eval_batch`` on (a)'s engine equal to a no-grad
    forward's loss bit for bit, the parameters unchanged; (e) (a)'s
    gradient gate refusing each fault of BTP_FAULTS planted in (a)'s
    step-1 gradients (:func:`btp_fault`); the split
    weights half of tp=1's bytes. Depth cuts: (b), (c) and (a)'s twin at
    BTP_LAYERS of 24 layers (gloo's host-staged collectives). Returns rank
    0's launch counts summed over the legs' timed steps."""
    import torch

    from deepspeed_tpu_torch.tools.profile_training import (
        bert_batch, bert_engine, bert_model, timed_steps)

    from deepspeed_tpu_torch.models.bert import BertForTraining

    refs = {}
    for label, sparse, layers in (("sparse", True, None),
                                  ("dense", False, BTP_LAYERS)):
        model = bert_model(seed, sparse, layers)
        batch = bert_batch(model.config.vocab_size, seed, "cuda",
                           sparse=sparse)
        # the same weights and batch computed in fp32 through the plain
        # versions (no kernel of the paths under test): the yardstick of
        # the bf16 paths' rounding noise (a copy on the card; the model
        # stays on the host until its own engine)
        exact = BertForTraining(dataclasses.replace(
            model.config, dtype=torch.float32), device="meta")
        exact.load_state_dict(model.state_dict(), assign=True)
        exact = bert_engine(exact, sparse=sparse)
        with plain_versions():
            exact_grads = {n: g.cpu() for n, g in
                           first_grads(exact, batch).items()}
        del exact
        torch.cuda.empty_cache()
        engine = bert_engine(model, sparse=sparse)
        grads = {n: g.cpu() for n, g in first_grads(engine, batch).items()}
        warm, _ = timed_steps(engine, batch, 1)
        torch.cuda.reset_peak_memory_stats()
        losses, secs = timed_steps(engine, batch, BTP_STEPS)
        refs[label] = {"losses": warm + losses,
                       "ms": 1e3 * secs / BTP_STEPS,
                       "peak": torch.cuda.max_memory_allocated(),
                       "grads": grads, "exact": exact_grads}
        del engine, model, batch
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn_tp_ranks(btp_rank_main, seed, TP_SIZE)
    secs = time.perf_counter() - t0
    grads = ranks[0].pop("grads")
    first = ranks[0]
    legs = ("sparse", "sparse4", "zero3", "dense")
    for rank, res in enumerate(ranks):
        what = f"bert tp rank {rank}"
        for label in legs:
            if res[label]["losses"] != first[label]["losses"]:
                raise AssertionError(f"{what} {label}: losses "
                                     f"{res[label]['losses']} differ from "
                                     f"rank 0's {first[label]['losses']}")
        if res["replicated_sha256"] != first["replicated_sha256"]:
            raise AssertionError(f"{what}: replicated parameters differ "
                                 f"from rank 0's")
        if set(res["heads"]) != set(BTP_KERNELS) or any(
                set(h) != {BTP_HEADS} for h in res["heads"].values()):
            raise AssertionError(f"{what}: attention launches at heads "
                                 f"{res['heads']}, not only {BTP_HEADS}")
        e = res["eval"]
        if e["loss"] != e["forward"] or not e["unchanged"]:
            raise AssertionError(f"{what}: eval_batch loss {e['loss']} vs a "
                                 f"no-grad forward's {e['forward']}, "
                                 f"parameters unchanged: {e['unchanged']}")
        local, whole = res["split_bytes"]
        if not local or 2 * local != whole:
            raise AssertionError(f"{what}: {local} bytes of split weights, "
                                 f"not half of tp=1's {whole}")
    # every leg's numbers are logged before any of them fails the phase
    failures, held = [], {}
    for label, twin, loss_atol, rtol in (
            ("sparse", "sparse", TPT_LOSS_ATOL, TPT_GRAD_RTOL),
            ("dense", "dense", TPT_LOSS_ATOL, TPT_GRAD_RTOL),
            ("zero3", "sparse4", ZERO_LOSS_ATOL, ZERO_GRAD_RTOL)):
        ref = refs.get(twin, {"losses": first[twin]["losses"],
                              "grads": grads[twin]})
        loss_err = max(abs(a - b) for a, b in zip(first[label]["losses"],
                                                  ref["losses"]))
        failed, *stats = btp_grad_check(grads[label], ref["grads"], rtol,
                                        ref.get("exact"))
        held[label] = (loss_err, *stats)
        if loss_err > loss_atol or failed:
            failures.append(
                f"bert tp {label} vs {'tp=1' if twin in refs else twin}: "
                f"losses {first[label]['losses']} vs {ref['losses']} (max "
                f"diff {loss_err}, limit {loss_atol}); step-1 gradients "
                f"beyond {rtol} relative L2 and {BTP_NOISE_RATIO}x tp=1's "
                f"distance from fp32: {failed}")

    # (e) each planted fault refused by (a)'s gradient gate: how many
    # tensors, and the furthest past its limit (the nearer of its two
    # limits: relative L2, and the fp32 distance ratio)
    refused = {}
    for name, fault in grads["faults"].items():
        failed = btp_grad_check(fault, refs["sparse"]["grads"],
                                TPT_GRAD_RTOL, refs["sparse"]["exact"])[0]
        if not failed:
            failures.append(f"bert tp (e): the gradient gate passed the "
                            f"planted fault {name}")
            continue
        margin = {n: min(err / TPT_GRAD_RTOL, ratio / BTP_NOISE_RATIO)
                  for n, (err, ratio) in failed.items()}
        worst = max(margin, key=margin.get)
        refused[name] = (len(failed), margin[worst], worst)

    def per_step(counts):
        return {k: v / BTP_STEPS for k, v in counts.items() if v}

    def gates(label):
        loss_err, (err, name), share, ratio, n_noise = held[label]
        return (f"losses max |diff| {loss_err:.3g}, step-1 gradients "
                f"relative L2 max {err:.3g} at {name} (key biases apart: "
                f"at most {share:.3g} of their query bias's), {n_noise} "
                f"tensors past the relative limit held by their fp32 "
                f"distance (at most {ratio:.3g}x the reference's)")

    log(f"bert tensor parallel: BERT-large (hidden 1024, 16 heads of 64, "
        f"FFN 4096, vocab 30522, 4096 positions), bf16, dots remat, "
        f"bench_bert.py's keys, {TP_SIZE} ranks on cuda:0 over gloo (NCCL "
        f"refuses two ranks on one device; gloo stages CUDA tensors "
        f"through the host), in {secs:.1f} s: ranks' losses and "
        f"replicated parameters bit-equal; (a) sparse 2 x 4096, "
        f"{first['layers']} layers, \"bert\" policy, vs tp=1: "
        f"{gates('sparse')}; losses "
        f"{[round(x, 4) for x in first['sparse']['losses']]} vs "
        f"{[round(x, 4) for x in refs['sparse']['losses']]}; (b) ZeRO 3 + "
        f"partition_activations at {BTP_LAYERS} layers vs stage 0: "
        f"{gates('zero3')}; (c) dense 64 x 128 at {BTP_LAYERS} layers, "
        f"\"auto\" (split heads gathered before a whole output_dense), vs "
        f"tp=1: {gates('dense')}; (d) eval_batch = the no-grad forward's "
        f"loss bit for bit, parameters unchanged; (e) (a)'s gradient gate "
        f"refuses each planted fault: "
        + "; ".join(f"{k} {n} tensors, up to {m:.3g}x the limit at {t}"
                    for k, (n, m, t) in refused.items())
        + "; collectives a step "
        + "; ".join(f"{k} {per_step(first[k]['collectives'])}"
                    for k in legs)
        + f" (= the plan); launches a step "
        + "; ".join(f"{k} {per_step(first[k]['counts'])}" for k in legs)
        + f", all at {BTP_HEADS} heads; split weights "
        f"{first['split_bytes'][0]} of {first['split_bytes'][1]} bytes a "
        f"rank [{card}]")
    log(f"bert tensor parallel, for information only (gloo host-staged "
        f"collectives, nothing of NCCL's speed): ms a step per rank "
        + ", ".join(f"{k} {first[k]['ms']:.1f}" for k in legs)
        + f" (tp=1: sparse {refs['sparse']['ms']:.1f}, dense "
        f"{refs['dense']['ms']:.1f}); peak memory a rank "
        + ", ".join(f"{k} {first[k]['peak'] / 1e9:.3f} GB" for k in legs)
        + f" (tp=1: sparse {refs['sparse']['peak'] / 1e9:.3f} GB, dense "
        f"{refs['dense']['peak'] / 1e9:.3f} GB) [{card}]")
    if failures:
        raise AssertionError("\n".join(failures))
    total = collections.Counter()
    for k in legs:
        total.update(first[k]["counts"])
    return dict(total)





Kernel = collections.namedtuple(
    "Kernel", "source replaces path port row dtype rows noncausal "
    "fp32_source", defaults=("bfloat16", None, False, None))
# ---------------------------------------------------------------------------
# phase 14: data-parallel inference and tp replicas behind the router
# ---------------------------------------------------------------------------
# (a): init_inference(tp_size=TP_SIZE) on DP_WORLD gloo ranks on cuda:0,
# data=2 x tp=2; generate of DP_NEW tokens for DP_ROWS prompts of
# DP_PROMPT tokens, for the first DP_UNEVEN of them (not dividing over
# data), and keyed for the DP_ROWS
DP_WORLD = 4
DP_ROWS, DP_UNEVEN, DP_PROMPT, DP_NEW = 8, 7, 128, 32
DP_KEYED = dict(seed=11, temperature=0.8, top_p=0.9)
# (b): the timed moves between the two group replicas, by blocks
DP_MOVE_BLOCKS = (4, 16)


def dp_ids(seed, vocab):
    return np.random.default_rng(seed + 14).integers(
        1, vocab, (DP_ROWS, DP_PROMPT))


def dp_generate(engine, ids):
    """14a's three generate calls: {name: tokens (whole), seconds, and
    (where the engine holds every row) every step's logits a row}."""
    import torch

    ids = torch.as_tensor(ids, device=engine.device)
    out = {}
    for name, rows, kw in (("greedy", ids, {}),
                           ("uneven", ids[:DP_UNEVEN], {}),
                           ("keyed", ids, {"do_sample": True, **DP_KEYED})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, calls = run_generate(engine, rows, DP_NEW, **kw)
        torch.cuda.synchronize()
        out[name] = {"tokens": tokens[:, DP_PROMPT:].tolist(),
                     "secs": time.perf_counter() - t0}
        if calls[0].shape[0] == rows.shape[0]:
            out[name]["steps"] = [[c[b:b + 1] for c in calls]
                                  for b in range(rows.shape[0])]
    return out


def fleet_reference(model, seed):
    """Phase 11's 9 requests on one process, every step's logits kept
    (what 14b's streams are held to up to a near tie): the 8 greedy ones
    through phase 4's serving engine, the keyed one through
    ``generate(do_sample=True, seed=...)``, whose tokens a keyed serving
    stream equals."""
    import torch

    from deepspeed_tpu_torch import init_inference, init_serving
    from deepspeed_tpu_torch.tools.profile_serving import (MAX_NEW_TOKENS,
                                                           SERVING,
                                                           serving_prompts)

    prompts = serving_prompts(model.config.vocab_size, seed)
    srv = init_serving(model, serving=SERVING)
    steps = record_steps(srv)
    reqs = [srv.submit(p, max_new_tokens=MAX_NEW_TOKENS, request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    srv.drain()
    out = {r.request_id: (r.tokens, steps[r.request_id], r.prompt_len)
           for r in reqs}
    engine = init_inference(model)
    ids = torch.as_tensor(prompts[2], device=engine.device)[None]
    tokens, calls = run_generate(engine, ids, MAX_NEW_TOKENS,
                                 do_sample=True, **FLEET_KEYED)
    out["k"] = (tokens[0, ids.shape[1]:].tolist(), calls, ids.shape[1])
    return out


def group_stream(front, prompts, keyed, max_new, events=None):
    """Phase 11's stream through a group front; its handles' summary."""
    import torch

    if events is not None:
        front.telemetry = events
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles, streamed = fleet_stream(front, prompts, keyed, max_new)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check_stream("group replicas", handles, streamed, None, max_new)
    return {"tokens": {rid: h.tokens for rid, h in handles.items()},
            "secs": secs, "stats": front.stats()}


def group_migration(front, prompts, max_new):
    """Phase 11's (c) on a group front: 4 requests, migrate_work(1) after
    FLEET_MIGRATE_STEP steps; kernel launches on the target's rank 0
    (this rank) from the move to the end, and the moves' events."""
    events = EventLog()
    front.telemetry = events
    streamed = {}
    handles = {f"r{i}": front.submit(
        p, max_new_tokens=max_new, request_id=f"r{i}",
        stream=lambda h, t, d: streamed.setdefault(h.request_id,
                                                   []).append(int(t)))
        for i, p in enumerate(prompts)}
    for _ in range(FLEET_MIGRATE_STEP):
        front.step()
    on_1 = front.assigned(1)
    before = launch_counts()
    moved = front.migrate_work(1)
    front.drain()
    after = launch_counts()
    check_stream("group replicas (c)", handles, streamed, None, max_new)
    return {"tokens": {rid: h.tokens for rid, h in handles.items()},
            "moved": moved, "on_1": on_1, "stats": front.stats(),
            "launches_after_move": {k: after[k] - before[k]
                                    for k in after},
            "moves": [d for _, name, d in events.events
                      if name == "migrate"]}


def group_time_moves(front, vocab):
    """Export + import (and the source's detach) of one sequence from
    group replica 0 to group replica 1, by covered blocks, on the
    controller's clock around calls that end in every rank's sync:
    {blocks: (ms, wire bytes)}."""
    src, dst = front.replicas
    rng = np.random.default_rng(5)
    out = {}
    for n, blocks in enumerate(b for b in DP_MOVE_BLOCKS for _ in "12"):
        prompt = rng.integers(1, vocab, blocks * 16 - 2)
        src.submit(prompt, max_new_tokens=8, request_id=f"t{n}")
        src.step()
        src.synchronize()
        dst.synchronize()
        t0 = time.perf_counter()
        export = src.export_sequence(f"t{n}")
        moved = dst.import_sequence(export)
        src.migrate_out(f"t{n}")
        dst.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if export["blocks"] != blocks or moved is None:
            raise AssertionError(f"group move of {blocks} blocks: export "
                                 f"{export['blocks']}, import {moved}")
        dst.cancel(moved.request_id)
        if n % 2:
            out[blocks] = (ms, export["wire_bytes"])
    return out


def group_fleet(model, seed):
    """14b on every rank: two tp=2 replicas (data groups) behind
    ``init_serving(replicas=[engine])``, rank 0 the controller: phase
    11's stream, replica 1 crashing at its FLEET_CRASH_STEP-th step, a
    drain that migrates on bf16 and on int8 pools (and an unmigrated
    int8 run), timed moves. Rank 0 returns the results; the followers
    return {} once the controller destroys each front."""
    from deepspeed_tpu_torch import init_inference, init_serving
    from deepspeed_tpu_torch.runtime.resilience.chaos import ChaosReplica
    from deepspeed_tpu_torch.tools.profile_serving import (MAX_NEW_TOKENS,
                                                           serving_prompts)

    max_new = MAX_NEW_TOKENS
    prompts = serving_prompts(model.config.vocab_size, seed)

    def front(kv="", migration=False):
        serving = {**FLEET_SERVING, "kv_cache_dtype": kv,
                   "router": {"replicas": 2}}
        if migration:
            serving["migration"] = {}
        return init_serving(None, replicas=[init_inference(
            model, tensor_parallel={"tp_size": TP_SIZE}, serving=serving)])

    out = {}
    f = front()
    if f is not None:
        out["stream"] = group_stream(f, prompts, prompts[2], max_new)
        out["served"] = [r.stats()["finished"] for r in f.replicas]
        f.destroy()
    f = front()
    if f is not None:
        f.replicas[1] = ChaosReplica(f.replicas[1],
                                     crash_at_step=FLEET_CRASH_STEP)
        out["crash"] = group_stream(f, prompts, prompts[2], max_new)
        f.destroy()
    for kv in ("", "int8"):
        f = front(kv, migration=True)
        if f is not None:
            out[f"migrate-{kv or 'bf16'}"] = group_migration(
                f, prompts[:FLEET_MIGRATE_REQUESTS], max_new)
            out[f"moves-{kv or 'bf16'}"] = group_time_moves(
                f, model.config.vocab_size)
            f.destroy()
    f = front("int8")
    if f is not None:
        out["unmigrated-int8"] = group_stream(
            f, prompts[:FLEET_MIGRATE_REQUESTS], None, max_new)
        f.destroy()
    return out


def dp_rank_main(rank, world, store, seed, out_dir):
    """One rank of phase 14 (a spawned process): join the gloo group of
    ``world`` ranks on ``cuda:0``, build GPT-2 125M from ``seed`` on the
    host, run 14a on ``init_inference(tensor_parallel={"tp_size":
    TP_SIZE})`` (data = world / TP_SIZE) and 14b's group replicas;
    writes its launch counts, the heads and rows of every launch of
    kernels 1, 7, 8 and 9, its peak memory and its results."""
    import pickle
    import traceback

    try:
        os.environ["LOCAL_RANK"] = "0"
        import torch

        from deepspeed_tpu_torch import comm, init_inference
        from deepspeed_tpu_torch.models import gpt2 as gpt2_mod
        from deepspeed_tpu_torch.ops import decode_attention as da
        from deepspeed_tpu_torch.ops import flash_attention as fa

        torch.backends.cuda.matmul.allow_tf32 = False
        comm.init_distributed(dist_backend="gloo",
                              init_method=f"file://{store}", rank=rank,
                              world_size=world, timeout=TP_TIMEOUT,
                              verbose=False)
        model = gpt2_mod.GPT2LMHeadModel(gpt2_mod.GPT2Config.gpt2_125m(),
                                         seed=seed)
        launches = collections.defaultdict(collections.Counter)

        def spy(name, fn, dim):
            def call(q, *args, **kwargs):
                launches[name][(q.shape[dim], q.shape[0])] += 1
                return fn(q, *args, **kwargs)
            return call

        with mock.patch.object(fa, "_fwd_launch",
                               spy("flash_fwd", fa._fwd_launch, 1)), \
                mock.patch.object(da, "_append_launch",
                                  spy("decode_append", da._append_launch,
                                      2)), \
                mock.patch.object(da, "_paged_launch",
                                  spy("decode_paged", da._paged_launch, 2)), \
                mock.patch.object(da, "_paged_int8_launch",
                                  spy("decode_paged_int8",
                                      da._paged_int8_launch, 2)):
            engine = init_inference(model,
                                    tensor_parallel={"tp_size": TP_SIZE})
            ids = dp_ids(seed, model.config.vocab_size)
            run_generate(engine, torch.as_tensor(ids[:2], device=engine.device), 2)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            launches.clear()
            reset_launch_counts()
            gen = dp_generate(engine, ids)
            counts_a = launch_counts()
            heads_a = {k: dict(v) for k, v in launches.items()}
            peak_a = torch.cuda.max_memory_allocated()
            launches.clear()
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            fleet = group_fleet(model, seed)
            torch.cuda.synchronize()
            counts_b = launch_counts()
            heads_b = {k: dict(v) for k, v in launches.items()}
            peak_b = torch.cuda.max_memory_allocated()
        res = {"shape": engine.topo.shape,
               "coord": (engine.dp_rank,
                         engine.topo.get_tensor_parallel_rank()),
               "generate": {k: {kk: vv for kk, vv in v.items()
                                if kk != "steps"} for k, v in gen.items()},
               "counts_a": counts_a, "heads_a": heads_a, "peak_a": peak_a,
               "fleet": fleet, "counts_b": counts_b, "heads_b": heads_b,
               "peak_b": peak_b}
        comm.destroy_process_group()
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def hold_streams(what, got, ref):
    """Hold a group run's tokens (by request id) to the one-process
    reference's up to a near tie (keyed requests with their keys).
    Returns (tokens agreeing, tokens in all)."""
    agree = total = 0
    for rid, (want, steps, plen) in ref.items():
        a, _ = agree_until_tie(f"{what} {rid}", got[rid], want, steps, plen,
                               knobs=FLEET_KEYED if rid == "k" else None)
        agree, total = agree + a, total + len(want)
    return agree, total


def phase_data_parallel(seed, card):
    """[7e] on GPT-2 125M at its published widths (bf16, 12 layers, 12
    heads: 6 a rank), DP_WORLD gloo ranks on ``cuda:0`` (NCCL refuses
    several ranks on one device; gloo stages CUDA tensors through the
    host, so every time here is the host-staged path's, not NCCL's).

    (a) ``init_inference(tensor_parallel={"tp_size": 2})`` on the world
    of 4 builds data=2 x tp=2; ``generate`` of DP_NEW tokens for
    DP_ROWS prompts of DP_PROMPT tokens, the first DP_UNEVEN of them (a
    batch data does not divide) and keyed (one seed) for the DP_ROWS:
    greedy and keyed tokens equal the tp=1 run's (here, first: every
    step's logits kept) up to a near tie, every rank returns the whole
    tokens and they are bit for bit equal on all ranks; kernels 1 and 7
    launch at 6 heads on a rank's rows (ceil(B / 2)) only, as often as
    tp=1 does for the same calls.

    (b) two tp=2 replicas (the two data groups) behind
    ``init_serving(replicas=[engine])``, rank 0 the controller: phase
    11's 9 requests (tokens equal to a one-process engine's, run first
    here with every step's logits kept, up to a near tie); replica 1
    crashing at
    its FLEET_CRASH_STEP-th step (failover replay: replay_divergence 0,
    the streams equal the uncrashed group run's, replica 1 dead); a drain
    of replica 1 that migrates its live sequences on bf16 and on int8
    pools (0 kernel-1 launches on the target's rank 0 from the move to
    the end; tokens equal to the unmigrated group run's on the same
    pools; wire bytes int8 : bf16 = (D + 4) / (2 D)); kernels 8 and 9 at
    6 heads on every rank. Cuts: none of width or depth; the timed moves
    stop at 16 blocks (phase 11 times 63). Returns rank 0's launch counts
    of (a) and of (b)."""
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel

    model = GPT2LMHeadModel(GPT2Config.gpt2_125m(), seed=seed)
    engine = init_inference(model)
    ids = dp_ids(seed, model.config.vocab_size)
    run_generate(engine, torch.as_tensor(ids[:2], device=engine.device), 2)
    reset_launch_counts()
    want = dp_generate(engine, ids)
    want_counts = launch_counts()
    ref_fleet = fleet_reference(model, seed)
    hd = model.config.n_embd // model.config.n_head
    del engine, model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_tp_ranks(dp_rank_main, seed, DP_WORLD)
    secs = time.perf_counter() - t0
    first = ranks[0]
    half = -(-DP_ROWS // 2)
    for rank, res in enumerate(ranks):
        what = f"data parallel rank {rank}"
        if res["shape"]["data"] != 2 or res["shape"]["tp"] != TP_SIZE or \
                res["coord"] != (rank // TP_SIZE, rank % TP_SIZE):
            raise AssertionError(f"{what}: mesh {res['shape']} coord "
                                 f"{res['coord']}")
        for name in want:
            if res["generate"][name]["tokens"] != \
                    first["generate"][name]["tokens"]:
                raise AssertionError(f"{what}: {name} tokens differ from "
                                     f"rank 0's")
        for name in ("flash_fwd", "decode_append"):
            got = set(res["heads_a"].get(name, {}))
            if got != {(TP_HEADS, half)}:
                raise AssertionError(f"{what}: {name} launched at (heads, "
                                     f"rows) {got}, not ({TP_HEADS}, "
                                     f"{half}) only")
            if res["counts_a"][name] != want_counts[name]:
                raise AssertionError(f"{what}: {name} {res['counts_a'][name]}"
                                     f" launches, tp=1 {want_counts[name]}")
        for name in ("decode_paged", "decode_paged_int8"):
            heads = {h for h, _ in res["heads_b"].get(name, {})}
            if heads != {TP_HEADS}:
                raise AssertionError(f"{what}: {name} launched at heads "
                                     f"{heads} in (b)")
    summary = []
    for name in want:
        knobs = DP_KEYED if name == "keyed" else None
        agree = held = total = 0
        for b, (toks, ref) in enumerate(zip(first["generate"][name]["tokens"],
                                            want[name]["tokens"])):
            a, h = agree_until_tie(f"data parallel {name} row {b}", toks,
                                   ref, want[name]["steps"][b], DP_PROMPT,
                                   knobs=knobs)
            agree, held, total = agree + a, held + h, total + len(ref)
        summary.append(f"{name} {agree}/{total} equal to tp=1 (held {held} "
                       f"before a near tie)")
    fleet = first["fleet"]
    agree, total = hold_streams("group replicas (a)",
                                fleet["stream"]["tokens"], ref_fleet)
    group_want = fleet["stream"]["tokens"]
    crash = fleet["crash"]
    check_router("group replicas (b)", crash["stats"],
                 failovers=lambda n: n > 0, replay_divergence=0,
                 replica_states=["healthy", "dead"])
    if crash["tokens"] != group_want:
        raise AssertionError("group replicas (b): the crashed run's streams "
                             "differ from (a)'s")
    per_block = {}
    for kv in ("bf16", "int8"):
        mig = fleet[f"migrate-{kv}"]
        ref = (group_want if kv == "bf16"
               else fleet["unmigrated-int8"]["tokens"])
        if mig["tokens"] != {rid: ref[rid] for rid in mig["tokens"]}:
            raise AssertionError(f"group replicas (c) {kv}: tokens differ "
                                 f"from the unmigrated run's")
        check_router(f"group replicas (c) {kv}", mig["stats"],
                     migrations=mig["on_1"], failovers=0,
                     replay_divergence=0)
        if mig["moved"] != mig["on_1"] or mig["moved"] == 0 or \
                mig["launches_after_move"]["flash_fwd"] != 0:
            raise AssertionError(f"group replicas (c) {kv}: moved "
                                 f"{mig['moved']} of {mig['on_1']}; target "
                                 f"launches after the move "
                                 f"{mig['launches_after_move']}")
        per_block[kv] = {d["wire_bytes"] / d["blocks"]
                         for d in mig["moves"]}.pop()
    ratio = per_block["int8"] / per_block["bf16"]
    if abs(ratio - (hd + 4) / (2 * hd)) > 1e-9:
        raise AssertionError(f"group replicas (c): wire bytes int8 : bf16 "
                             f"{ratio}, not {(hd + 4) / (2 * hd)}")
    rows = DP_ROWS * DP_NEW
    ms_tok = [1e3 * r["generate"]["greedy"]["secs"] / (half * DP_NEW)
              for r in ranks]
    log(f"data parallel (a): {DP_WORLD} gloo ranks on cuda:0, data=2 x "
        f"tp={TP_SIZE}, GPT-2 125M bf16 at {TP_HEADS} heads a rank, in "
        f"{secs:.1f} s (both legs): " + "; ".join(summary)
        + f"; every rank's tokens bit for bit rank 0's (the whole batch on "
        f"each); kernels 1 and 7 at ({TP_HEADS} heads, {half} rows) every "
        f"launch, launches {first['counts_a']['flash_fwd']} / "
        f"{first['counts_a']['decode_append']} (tp=1 "
        f"{want_counts['flash_fwd']} / {want_counts['decode_append']}); "
        f"ms per generated token a rank (greedy, {rows} tokens, "
        f"host-staged gloo) {[round(x, 3) for x in ms_tok]}, tp=1 "
        f"{1e3 * want['greedy']['secs'] / rows:.3f}; peak memory a rank "
        f"{[round(r['peak_a'] / 2**20, 1) for r in ranks]} MiB [{card}]")
    st = fleet["stream"]
    moves = {kv: fleet[f"moves-{kv}"] for kv in ("bf16", "int8")}
    log(f"data parallel (b): two tp={TP_SIZE} replicas (rank groups "
        f"{[[0, 1], [2, 3]]}) behind init_serving, rank 0 the controller: "
        f"{len(st['tokens'])} requests in {st['secs']:.3f} s "
        f"({len(st['tokens']) / st['secs']:.2f} requests/s through the "
        f"router, host-staged gloo), finished per replica "
        f"{fleet['served']}, tokens equal to a one-process engine's "
        f"{agree}/{total}; crash: {crash['stats']['failovers']} failovers, "
        f"replay_divergence 0, streams equal to the uncrashed run's; "
        f"migration bf16 / int8 moved {fleet['migrate-bf16']['moved']} / "
        f"{fleet['migrate-int8']['moved']} sequences, wire bytes a block "
        f"{per_block['bf16']:.0f} / {per_block['int8']:.0f} (ratio "
        f"{ratio:.5f}), 0 kernel-1 launches on the target; export + import "
        f"(controller clock, every rank synced, host-staged): "
        + "; ".join(f"{kv} " + ", ".join(
            f"{b} blocks {ms:.3f} ms ({w / 1e6:.3f} MB)"
            for b, (ms, w) in mv.items()) for kv, mv in moves.items())
        + f"; kernels 8 / 9 at {TP_HEADS} heads on every rank; peak memory "
        f"a rank {[round(r['peak_b'] / 2**20, 1) for r in ranks]} MiB "
        f"[{card}]")
    return first["counts_a"], first["counts_b"]


# ---------------------------------------------------------------------------
# phase 15: telemetry on the card
# ---------------------------------------------------------------------------
TEL_STEPS = 5
TEL_TRACE = {"start_step": 2, "num_steps": 2}
TEL_KERNELS = ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel",
               "flash_bwd_dkv_sm90_kernel")


def step_times(engine, batch, n):
    """Per-step ms, each step synchronized (host clock)."""
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.backward(engine(batch))
        engine.step()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def read_jsonl(directory):
    from deepspeed_tpu_torch.telemetry.events import load_all_events

    return load_all_events(os.path.join(directory, "telemetry.jsonl"))


def telemetry_training(seed, card, reference):
    """15a: phase 3's engine at ZeRO 1 on an NCCL world of one, first
    with telemetry off, then with the telemetry section (a 2-step trace
    window, tracing), wall_clock_breakdown, memory_breakdown (each step:
    steps_per_print 1), comms_logger and csv_monitor, both timed a step
    at a time (one warm-up, TEL_STEPS timed, launch counts over the
    timed steps); ``reference["ms_per_step"]`` is phase 3b's stage-1
    step, printed beside the off engine's spread. Cut: TEL_STEPS steps
    of phase 3's 10."""
    import tempfile

    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.tools.profile_training import (
        BATCH, BENCH_CONFIG, SEQ, bench_batch, bench_model, flops_per_token)

    d = tempfile.mkdtemp(prefix="chip_smoke_telemetry")
    store = os.path.join(d, "store")
    comm.init_distributed(init_method=f"file://{store}", rank=0,
                          world_size=1, verbose=False)
    out = {}
    try:
        base = {**BENCH_CONFIG, "zero_optimization": {"stage": 1}}
        on = {**base, "telemetry": {
            "enabled": True, "dir": os.path.join(d, "tel"),
            "tracing": {"enabled": True},
            "trace": {**TEL_TRACE, "dir": os.path.join(d, "trace")}},
            "wall_clock_breakdown": True, "memory_breakdown": True,
            "steps_per_print": 1, "comms_logger": {"enabled": True},
            "csv_monitor": {"enabled": True,
                            "output_path": os.path.join(d, "csv")}}
        for label, config in (("off", base), ("on", on)):
            engine = deepspeed_tpu_torch.initialize(
                model=bench_model(seed), config=config)[0]
            batch = bench_batch(engine.module.config.vocab_size, seed,
                                engine.device)
            step_times(engine, batch, 1)
            reset_launch_counts()
            ms = step_times(engine, batch, TEL_STEPS)
            counts = launch_counts()
            out[label] = {"ms": ms, "counts": counts}
            if label == "on":
                out["flops_ref"] = BATCH * SEQ * flops_per_token(
                    engine.module)
                out["summary"] = comm.log_summary()
            engine.destroy()
            del engine
            torch.cuda.empty_cache()
    finally:
        comm.configure(enabled=False)
        comm.destroy_process_group()
    events = read_jsonl(os.path.join(d, "tel"))
    kinds = collections.Counter(e["kind"] for e in events)
    roots = [e for e in events if e["kind"] == "span" and e["name"] ==
             "step"]
    for root in roots:
        kids = sorted(e["name"] for e in events if e["kind"] == "span"
                      and e["data"].get("parent") == root["data"]["span"])
        if kids != ["fwd_bwd", "optimizer"]:
            raise AssertionError(f"telemetry (a): step {root['data']['step']}"
                                 f" spans {kids}")
    if len(roots) != 1 + TEL_STEPS or kinds["memory"] != 1 + TEL_STEPS:
        raise AssertionError(f"telemetry (a): {len(roots)} step spans, "
                             f"{kinds['memory']} memory events for "
                             f"{1 + TEL_STEPS} steps")
    cost = next(e["data"] for e in events if e["kind"] == "step_cost")
    flops_err = cost["flops"] / out["flops_ref"] - 1
    if abs(flops_err) > 0.01:
        raise AssertionError(f"telemetry (a): step_cost FLOPs "
                             f"{cost['flops']:.4g} vs 6N + 6LTC "
                             f"{out['flops_ref']:.4g} ({flops_err:+.4%})")
    builds = [e for e in events if e["kind"] == "compile"
              and e["data"].get("source") == "kernel_build"]
    if not builds:
        raise AssertionError("telemetry (a): no kernel-build compile event")
    exposed = [e for e in events if e["kind"] == "trace_window"]
    actions = [e["data"]["action"] for e in exposed]
    if actions[:2] != ["start", "stop"]:
        raise AssertionError(f"telemetry (a): trace window {actions}")
    reading = next((e["data"] for e in events if e["kind"] == "span"
                    and e["name"] == "exposed_comm"), None) or next(
        e["data"] for e in exposed
        if e["data"]["action"] == "exposed_comm_unavailable")
    trace = next(e["data"]["trace"] for e in exposed
                 if e["data"]["action"] == "stop")
    with open(trace) as f:
        names = {ev.get("name", "") for ev in json.load(f).get(
            "traceEvents", []) if ev.get("cat") == "kernel"}
    missing = [k for k in TEL_KERNELS if not any(k in n for n in names)]
    if missing:
        raise AssertionError(f"telemetry (a): the trace window lacks "
                             f"{missing}")
    step_src = {e["data"].get("exposed_comm_source") for e in events
                if e["kind"] == "step"}
    for label in ("off", "on"):
        per_step = {k: v / TEL_STEPS for k, v in out[label]["counts"].items()
                    if v}
        out[label]["per_step"] = per_step
    if out["off"]["per_step"] != out["on"]["per_step"]:
        raise AssertionError(f"telemetry (a): launches a step off "
                             f"{out['off']['per_step']}, on "
                             f"{out['on']['per_step']}")
    ref_ms = reference["ms_per_step"]
    off = np.array(out["off"]["ms"])
    spread = (off.min(), off.max())
    csv_files = sorted(os.listdir(os.path.join(d, "csv",
                                               "DeepSpeedJobName")))
    log(f"telemetry (a): phase 3's engine at ZeRO 1 (NCCL, world 1), "
        f"telemetry on + wall_clock_breakdown + memory_breakdown + "
        f"comms_logger + csv_monitor: {len(events)} events "
        f"{dict(kinds)}; one step span a step with fwd_bwd and optimizer; "
        f"step_cost FLOPs {cost['flops']:.6g} vs 6N + 6LTC "
        f"{out['flops_ref']:.6g} ({flops_err:+.4%}), collectives "
        f"{cost.get('collectives')}; kernel-build compile events "
        f"{len(builds)}; exposed comm {reading} (step events: "
        f"{step_src}); trace window {actions}, kernels 1-3 in its Chrome "
        f"trace; csv files {csv_files}; comms log "
        f"{ {k: sum(v['count'] for v in s.values()) for k, s in out['summary'].items()} } "
        f"[{card}]")
    log(f"telemetry (a) step ms (host clock, each step synced): off "
        f"{[round(x, 2) for x in out['off']['ms']]}, on (breakdown syncs, "
        f"the trace window's profiler, memory_breakdown's gc a step) "
        f"{[round(x, 2) for x in out['on']['ms']]}; phase 3b's stage 1 "
        f"{ref_ms:.2f} ms/step {'inside' if spread[0] <= ref_ms <= spread[1] else 'outside'} "
        f"off's spread {spread[0]:.2f}-{spread[1]:.2f}; launches a step "
        f"off {out['off']['per_step']} = on [{card}]")
    return out["on"]["counts"]


def telemetry_serving(model, seed, card, single):
    """15b: phase 4's serving engine (behind a one-replica router, so
    requests carry traces) with telemetry, tracing and metrics_file on:
    tokens equal to phase 4's (``single``), each request's TTFT and
    queue wait in ``request.finish`` equal to the records ``stats()``
    aggregates, the serve / queue / prefill / decode spans closed for
    every request, the .prom file parses."""
    import tempfile

    from deepspeed_tpu_torch import init_serving
    from deepspeed_tpu_torch.telemetry.prom import parse_exposition
    from deepspeed_tpu_torch.tools.profile_serving import (
        MAX_NEW_TOKENS, SERVING, serving_prompts)

    d = tempfile.mkdtemp(prefix="chip_smoke_serving_telemetry")
    prom = os.path.join(d, "metrics.prom")
    prompts = serving_prompts(model.config.vocab_size, seed)
    reset_launch_counts()
    front = init_serving(model, serving={**SERVING,
                                         "router": {"replicas": 1}},
                         telemetry={"enabled": True, "dir": d,
                                    "tracing": {"enabled": True},
                                    "metrics_file": prom})
    handles = [front.submit(p, max_new_tokens=MAX_NEW_TOKENS,
                            request_id=f"r{i}")
               for i, p in enumerate(prompts)]
    front.drain()
    counts = launch_counts()
    srv = front.replicas[0]
    records = list(srv.records)
    engine = srv.engine
    front.destroy()
    engine.destroy()
    if [h.tokens for h in handles] != single:
        raise AssertionError("telemetry (b): tokens differ from phase 4's")
    events = read_jsonl(d)
    finish = [e["data"] for e in events if e["kind"] == "serving"
              and e["name"] == "request.finish"]
    if [(f["ttft_ms"], f["queue_ms"]) for f in finish] != \
            [(r["ttft_ms"], r["queue_ms"]) for r in records]:
        raise AssertionError("telemetry (b): request.finish TTFT / queue "
                             "differ from the records stats() reads")
    spans = [e for e in events if e["kind"] == "span"]
    by_req = collections.defaultdict(set)
    for s in spans:
        by_req[s["data"].get("trace")].add(s["name"])
    need = {"request", "serve", "queue", "prefill", "decode"}
    if len(by_req) != len(prompts) or any(not need <= v
                                          for v in by_req.values()):
        raise AssertionError(f"telemetry (b): spans by trace "
                             f"{dict(by_req)}")
    with open(prom) as f:
        fams = parse_exposition(f.read())
    for name in ("ds_serving_ttft_ms", "ds_serving_requests_total",
                 "ds_kv_pool_occupancy"):
        if name not in fams:
            raise AssertionError(f"telemetry (b): {name} not in the .prom "
                                 f"file ({sorted(fams)})")
    ttft = sorted(f["ttft_ms"] for f in finish)
    log(f"telemetry (b): phase 4's 8 requests behind a one-replica router "
        f"with telemetry, tracing and metrics_file: tokens equal to phase "
        f"4's; {len(events)} events; request.finish TTFT / queue wait equal"
        f" to stats()'s records (TTFT ms {[round(x, 3) for x in ttft]}); "
        f"request / serve / queue / prefill / decode spans closed for all "
        f"{len(prompts)} requests; .prom parses ({len(fams)} families); "
        f"launches {counts} [{card}]")
    return counts


_FLASH = "deepspeed_tpu/ops/flash_attention.py"
_DECODE = "deepspeed_tpu/ops/decode_attention.py"
_SPARSE = "deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py"
KERNEL_TABLE = {
    "flash_fwd": Kernel("flash_fwd_sm90.cu", f"{_FLASH}:77", "training",
                        "flash_fwd", 3, rows=("lse_err",), noncausal=True,
                        fp32_source="flash_fwd.cu"),
    "flash_bwd_dq": Kernel("flash_bwd_dq_sm90.cu", f"{_FLASH}:196",
                           "training", "flash_bwd_dq", 0, rows=(),
                           noncausal=True, fp32_source="flash_bwd_dq.cu"),
    "flash_bwd_dkv": Kernel("flash_bwd_dkv_sm90.cu", f"{_FLASH}:252",
                            "training", "flash_bwd_dkv", 0, rows=(),
                            noncausal=True,
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
    by_path = {}
    by_path["training"], reference = phase_training(args.seed, card)
    log(f"phase 3: training in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["zero"] = phase_zero(args.seed, card, reference)
    ms_per_step = {"ms_per_step": reference["zero_ms"][1]}
    del reference
    log(f"phase 3b: ZeRO stages {ZERO_STAGES} in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["checkpoint_resume"], by_path["handoff"] = phase_checkpoint(
        args.seed, card)
    log(f"phase 16: checkpoints and resilience in "
        f"{time.perf_counter() - t0:.1f} s")

    model = GPT2LMHeadModel(GPT2Config.gpt2_125m(), seed=args.seed)
    t0 = time.perf_counter()
    warm_up(model, args.seed)
    log(f"warm-up (one serving drain, one generate; untimed, uncounted) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["serving"], single = phase_serving(model, args.seed, card)
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
    t0 = time.perf_counter()
    by_path["fleet"] = phase_fleet(model, args.seed, card, single)
    log(f"phase 11: the serving fleet in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["telemetry_serving"] = telemetry_serving(model, args.seed, card,
                                                     single)
    log(f"phase 15b: serving telemetry in {time.perf_counter() - t0:.1f} s")
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    by_path["bert_sparse"], by_path["bert_dense"] = phase_bert(args.seed,
                                                               card)
    log(f"phase 8: BERT-large sparse and dense training in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["tensor_parallel"] = phase_tensor_parallel(args.seed, card)
    log(f"phase 9: tensor-parallel inference and serving at tp={TP_SIZE} in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["tp_training"] = phase_tp_training(args.seed, card)
    log(f"phase 10: tensor-parallel training at tp={TP_SIZE} in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["bert_tp"] = phase_bert_tp(args.seed, card)
    log(f"phase 13: BERT-large at tp={TP_SIZE} in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path.update(phase_llama(args.seed, card))
    log(f"phase 12: the Llama family in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["dp_generate"], by_path["group_replicas"] = \
        phase_data_parallel(args.seed, card)
    log(f"phase 14: data-parallel inference and tp replicas behind the "
        f"router in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["telemetry_training"] = telemetry_training(args.seed, card,
                                                       ms_per_step)
    log(f"phase 15a: training telemetry in {time.perf_counter() - t0:.1f} s")

    log(json.dumps({"kernels": kernel_line(kernel_rows, by_path)}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
