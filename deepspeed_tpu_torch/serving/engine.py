"""Serving runtime: continuous batching over a paged KV cache
(counterpart of ``deepspeed_tpu/serving/engine.py``).

Wraps an :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`
(its weights, dtype and device) with the request-level scheduler and two
device steps:

- **prefill** — right-pads one admitted prompt to its bucket (a small
  fixed set, powers of two by default), writes its KV into the
  sequence's pool blocks (the pad tail into the garbage block) with
  causal flash attention over the prompt, and samples the first token
  from the last REAL position;
- **decode** — ONE step for the fixed slot batch: every active sequence
  advances one token against its own block table and length through the
  paged decode kernel; idle slots compute into the garbage block and are
  ignored.

Finished sequences are evicted and queued requests spliced into free
slots *between* decode steps. Greedy tokens equal per-request
``generate()`` output. The pools are updated in place (the JAX engine
donates them instead); the one host sync per step is the sampled tokens.

Not in this slice, each rejected at config time with the slice that
brings it (``serving/config.py``): prefix cache, chunked prefill,
speculative decoding, int8 KV, keyed sampling, router/fleet/gateway,
migration (``export_sequence``/``import_sequence`` raise too). Telemetry
and resilience hooks come later.
"""

import collections
import time
from typing import List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.engine import (InferenceEngine,
                                                  sample_logits)
from deepspeed_tpu_torch.serving.blocks import BlockManager
from deepspeed_tpu_torch.serving.config import (ServingConfig,
                                                blocks_for_tokens,
                                                bucket_for, resolve_buckets)
from deepspeed_tpu_torch.serving.request import FINISHED, Request
from deepspeed_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
from deepspeed_tpu_torch.utils.logging import log_dist


class ServingEngine:
    def __init__(self, model_or_engine, config=None, clock=time.monotonic,
                 **kwargs):
        # injectable timebase: every request timestamp and deadline sweep
        # reads THIS clock
        self.clock = clock
        if isinstance(model_or_engine, InferenceEngine):
            if config is not None or kwargs:
                raise ValueError(
                    "pass config/kwargs to the InferenceEngine, not again "
                    "to ServingEngine when wrapping one")
            self.engine = model_or_engine
        else:
            self.engine = InferenceEngine(model_or_engine, config=config,
                                          **kwargs)
        scfg = self.engine._serving_cfg
        if scfg is None or not scfg.enabled:
            raise ValueError(
                "ServingEngine needs a `serving` block in the inference "
                'config, e.g. init_inference(model, serving={"block_size": '
                '16, "decode_slots": 4})')
        self.config: ServingConfig = scfg
        self.device = self.engine.device

        mcfg = self.engine.model_config
        window = mcfg.n_positions
        self.max_len = min(int(self.config.max_model_len or window), window)
        bs = self.config.block_size
        self.blocks_per_seq = blocks_for_tokens(self.max_len, bs)
        # garbage block + conservative worst-case reservation per slot:
        # admission never admits work the pool cannot finish
        self.num_blocks = int(self.config.num_blocks) or (
            1 + self.config.decode_slots * self.blocks_per_seq)
        self.buckets = resolve_buckets(self.config.prompt_buckets,
                                       self.max_len, floor=bs)
        self.model = self.engine.mode_module(
            mcfg.for_paged_decode(self.num_blocks, bs))
        self.cache = self.model.new_cache(0, self.device)
        self.block_mgr = BlockManager(self.num_blocks, bs,
                                      self.blocks_per_seq)
        self.sched = ContinuousBatchingScheduler(
            self.config, self.block_mgr, self.max_len, self.buckets,
            clock=self.clock)
        n = self.config.decode_slots
        self._tables = np.zeros((n, self.blocks_per_seq), np.int32)
        self._last_tokens = np.zeros((n,), np.int64)
        self._lengths = np.zeros((n,), np.int32)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(self.config.seed))
        self._step_count = 0
        # bounded retention: stats() percentiles cover the recent window
        self.records = collections.deque(maxlen=4096)
        log_dist(
            f"ServingEngine: slots={n} block_size={bs} "
            f"num_blocks={self.num_blocks} buckets={self.buckets} "
            f"max_len={self.max_len}", ranks=[0])

    # ------------------------------------------------------------------
    def _sample(self, logits):
        sc = self.config
        return sample_logits(logits, self.generator, sc.temperature,
                             sc.do_sample, sc.top_k, sc.top_p)

    def _on_device(self, array, dtype=torch.int32):
        return torch.as_tensor(array, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 0, **kwargs) -> Request:
        """Admit one request (non-blocking). Returns the Request; its
        ``state`` is ``queued`` on success or ``shed`` (with
        ``finish_reason``) when admission control rejected it."""
        prompt = [int(t) for t in np.asarray(prompt).ravel()]
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      **kwargs)
        if not self.sched.submit(req):
            self.records.append(req.record())
        return req

    @torch.inference_mode()
    def step(self) -> List[Request]:
        """One scheduler iteration: abandon blown deadlines, splice queued
        requests into free slots (prefilling each), then advance every
        running sequence one token. Returns requests finished this step."""
        now = self.clock()
        done: List[Request] = []
        for slot, req in self.sched.running():
            if self.sched.expired(req, now):
                self._finish(req, "deadline", now, done)
        admitted, shed = self.sched.admit(now)
        for req in shed:
            self.records.append(req.record())
        for slot, req, table in admitted:
            self._prefill(slot, req, table, done)
        if self.sched.running():
            self._decode_step(done)
        return done

    def _prefill(self, slot: int, req: Request, table: np.ndarray,
                 done: List[Request]):
        T = bucket_for(req.prompt_len, self.buckets)
        ids = np.zeros((1, T), np.int64)
        ids[0, :req.prompt_len] = req.prompt
        paging = {"block_tables": self._on_device(table[None]),
                  "lengths": self._on_device([0]),
                  "num_valid": self._on_device([req.prompt_len]),
                  "prefill": True}
        hidden = self.model(self._on_device(ids, torch.long),
                            cache=self.cache, paging=paging,
                            return_hidden=True)
        # the request's next token depends on its LAST REAL position
        # (right padding: index prompt_len - 1)
        logits = self.model.lm_head(hidden[:, req.prompt_len - 1])
        tok = int(self._sample(logits)[0])
        req.prefill_chunks = 1
        req.first_token_ts = self.clock()
        req.length = req.prompt_len
        self._tables[slot] = table
        self._lengths[slot] = req.prompt_len
        self._last_tokens[slot] = tok
        finished = (tok == req.eos_token_id
                    or len(req.tokens) + 1 >= req.max_new_tokens)
        req.emit_token(tok, finished)
        if finished:
            reason = "eos" if tok == req.eos_token_id else "max_tokens"
            self._finish(req, reason, self.clock(), done)

    def _decode_step(self, done: List[Request]):
        active = self.sched.running()
        n = self.config.decode_slots
        paging = {"block_tables": self._on_device(self._tables),
                  "lengths": self._on_device(self._lengths),
                  "num_valid": self._on_device(np.ones((n,), np.int32)),
                  "prefill": False}
        hidden = self.model(self._on_device(self._last_tokens[:, None],
                                            torch.long),
                            cache=self.cache, paging=paging,
                            return_hidden=True)
        # the one host sync per decode step: sampled tokens stream to
        # callers and drive the finish logic
        toks = self._sample(self.model.lm_head(hidden[:, -1])).cpu().numpy()
        now = self.clock()
        self._step_count += 1
        for slot, req in active:
            tok = int(toks[slot])
            req.length += 1
            self._lengths[slot] = req.length
            self._last_tokens[slot] = tok
            finished = (tok == req.eos_token_id
                        or len(req.tokens) + 1 >= req.max_new_tokens
                        or req.length + 1 > self.max_len)
            req.emit_token(tok, finished)
            if finished:
                reason = ("eos" if tok == req.eos_token_id else
                          "max_tokens" if len(req.tokens)
                          >= req.max_new_tokens else "window")
                self._finish(req, reason, now, done)

    def _finish(self, req: Request, reason: str, now: float,
                done: List[Request]):
        self.sched.finish(req, reason, now)
        # an idle slot computes into the garbage block until the next
        # admission overwrites its row
        self._tables[req.slot] = 0
        self._lengths[req.slot] = 0
        self._last_tokens[req.slot] = 0
        self.records.append(req.record())
        done.append(req)

    def export_sequence(self, request_id: str):
        """Live KV migration, export half: not in this slice."""
        raise NotImplementedError(
            "ServingEngine.export_sequence (live KV migration) is not ported "
            "yet: it comes with the multi-GPU serving slice of the PyTorch "
            "port")

    def import_sequence(self, export, **kwargs):
        """Live KV migration, import half: not in this slice."""
        raise NotImplementedError(
            "ServingEngine.import_sequence (live KV migration) is not ported "
            "yet: it comes with the multi-GPU serving slice of the PyTorch "
            "port")

    @property
    def pending(self) -> bool:
        return self.sched.pending

    def drain(self, max_steps: Optional[int] = None) -> List[Request]:
        """Step until queue and slots are empty (or ``max_steps``);
        returns every request finished during the drain."""
        out: List[Request] = []
        steps = 0
        while self.pending and (max_steps is None or steps < max_steps):
            out.extend(self.step())
            steps += 1
        return out

    def generate_batch(self, prompts, max_new_tokens: int = 0, **kwargs):
        """Submit every prompt, drain, and return each request's generated
        tokens in submit order (None for shed requests)."""
        reqs = [self.submit(p, max_new_tokens=max_new_tokens, **kwargs)
                for p in prompts]
        self.drain()
        return [r.tokens if r.state == FINISHED else None for r in reqs]

    def reset_stats(self):
        """Clear the per-request records and scheduler counters; in-flight
        requests and the pools are untouched."""
        self.records.clear()
        self.sched.reset_stats()

    def stats(self) -> dict:
        """Aggregate serving metrics over the records window."""
        ttfts = [r["ttft_ms"] for r in self.records
                 if r.get("ttft_ms") is not None]
        rates = [r["tokens_per_sec"] for r in self.records
                 if r.get("tokens_per_sec") is not None]
        s = self.sched.stats
        total = max(1, s["submitted"])
        return {
            "finished": s["finished"], "shed": s["shed"],
            "shed_reasons": dict(s["shed_reasons"]),
            "shed_rate": round(s["shed"] / total, 4),
            "queue_peak": s["queue_peak"],
            "decode_steps": self._step_count,
            "ttft_ms_p50": float(np.percentile(ttfts, 50)) if ttfts else None,
            "ttft_ms_p95": float(np.percentile(ttfts, 95)) if ttfts else None,
            "tokens_per_sec_mean": float(np.mean(rates)) if rates else None,
        }
