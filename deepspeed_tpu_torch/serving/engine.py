"""Serving runtime: continuous batching over a paged KV cache
(counterpart of ``deepspeed_tpu/serving/engine.py``).

Wraps an :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`
(its weights, dtype and device) with the request-level scheduler and
these device steps:

- **prefill** — right-pads one admitted prompt to its bucket (a small
  fixed set, powers of two by default), writes its KV into the
  sequence's pool blocks (the pad tail into the garbage block) with
  causal flash attention over the prompt, and samples the first token
  from the last REAL position;
- **decode** — ONE step for the fixed slot batch: every active sequence
  advances one token against its own block table and length through the
  paged decode kernel; idle slots compute into the garbage block and are
  ignored;
- **chunk** (``prefill_chunk_tokens`` or ``prefix_cache`` on) — writes
  up to ``c`` prompt tokens at the sequence's current length and attends
  them against the pool through the paged kernel with ``T_q = c`` rows:
  the step behind *chunked prefill* (a long prompt advances one budgeted
  chunk per step, round-robin, instead of holding the step for its whole
  prefill) and *prefix-cache tail prefill* (a request whose prompt
  prefix is already pooled writes only the unmatched tail);
- **cow** — copies one pool block's rows onto another in every pool (and
  int8 scale pool) of every layer: the device half of partial-tail
  copy-on-write;
- **verify** (``speculative`` on, in place of decode) — every slot
  advances ``k + 1`` query rows (the pending last token plus up to ``k``
  host-proposed draft tokens, right-padded against the garbage block)
  in ONE forward through the multi-row paged kernel; the host keeps the
  longest proposal prefix the greedy tokens agree with, commits it
  through the block manager's speculative ledger, and drops the
  rejected tail without copies (its rows sit past the committed length,
  masked out of every later window and overwritten by the next write).

With ``kv_cache_dtype: "int8"`` the pools hold row-quantized codes and
fp32 scales and every step but the whole-prompt prefill attends them
through the int8 paged kernel. Finished sequences are evicted and queued
requests spliced into free slots *between* steps. Greedy tokens equal
per-request ``generate()`` output with every knob off, and the JAX
engine's tokens with any of them on. The pools are updated in place
(the JAX engine donates them instead); the one host sync per step is
the sampled tokens.

With a ``serving.sampling`` block, a request submitted with
``do_sample=True`` and a ``seed`` samples through the keyed sampler
(``ops/sampling.py``): its token at absolute position P is a pure function
of (seed, P, logits), drawn at the JAX engine's positions (the prompt
length after prefill or the final chunk, ``length + 1`` at a decode step),
so its stream equals ``generate(do_sample=True, seed=...)``'s and the JAX
engine's under any batch mix; greedy requests beside it keep the argmax.

Not in this slice, each rejected at config time with the slice that
brings it (``serving/config.py``): router/fleet/gateway, migration
(``export_sequence``/``import_sequence`` raise too). Telemetry, span
tracing and resilience hooks come later.
"""

import collections
import time
from typing import List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.engine import (InferenceEngine,
                                                  sample_logits)
from deepspeed_tpu_torch.ops.sampling import keyed_sample
from deepspeed_tpu_torch.serving.blocks import BlockManager
from deepspeed_tpu_torch.serving.config import (ServingConfig,
                                                blocks_for_tokens,
                                                bucket_for, resolve_buckets)
from deepspeed_tpu_torch.serving.prefix_cache import PrefixCache
from deepspeed_tpu_torch.serving.request import FINISHED, Request
from deepspeed_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
from deepspeed_tpu_torch.serving.spec_decode import build_proposer
from deepspeed_tpu_torch.utils.logging import log_dist


class ServingEngine:
    def __init__(self, model_or_engine, config=None, draft_model=None,
                 clock=time.monotonic, **kwargs):
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
        self.model = self.engine.mode_module(mcfg.for_paged_decode(
            self.num_blocks, bs, kv_dtype=self.config.kv_cache_dtype))
        self.cache = self.model.new_cache(0, self.device)
        self.block_mgr = BlockManager(self.num_blocks, bs,
                                      self.blocks_per_seq)
        self.prefix = (PrefixCache(self.block_mgr)
                       if self.config.prefix_cache else None)
        self.sched = ContinuousBatchingScheduler(
            self.config, self.block_mgr, self.max_len, self.buckets,
            clock=self.clock, prefix_cache=self.prefix)
        n = self.config.decode_slots
        self._tables = np.zeros((n, self.blocks_per_seq), np.int32)
        self._last_tokens = np.zeros((n,), np.int64)
        self._lengths = np.zeros((n,), np.int32)
        # chunked / prefix-continued prefill state: a slot mid-prefill is
        # NOT in the decode batch (its row of self._tables stays pointed
        # at the garbage block) until its whole prompt is written
        self.chunk_tokens = int(self.config.prefill_chunk_tokens)
        self._prefilling = {}   # slot -> Request
        self._pf_tables = {}    # slot -> block table
        self._pf_pos = {}       # slot -> prompt tokens already pooled
        self._pf_next = 0       # round-robin cursor over prefilling slots
        # speculative decoding: the host-side proposer (None => the
        # decode step loop is exactly as before)
        self._proposer = build_proposer(self.config.speculative,
                                        draft_model=draft_model)
        self.spec_k = (int(self.config.speculative.num_speculative_tokens)
                       if self._proposer is not None else 0)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(self.config.seed))
        # keyed sampling (serving.sampling): each slot's seed and knobs on
        # the host; the key folds from (seed, position) at every draw, so
        # nothing else carries over between steps. Without the block these
        # arrays do not exist and every step samples as before
        self._keyed = bool(self.config.sampling is not None
                           and self.config.sampling.enabled)
        if self._keyed:
            self._seeds = np.zeros((n,), np.int64)
            self._samp_on = np.zeros((n,), np.int32)
            self._temps = np.ones((n,), np.float32)
            self._top_ks = np.zeros((n,), np.int64)
            self._top_ps = np.zeros((n,), np.float32)
        self._step_count = 0
        # speculation counters over the stats window (reset_stats zeroes
        # them with the records)
        self._spec_steps = 0
        self._window_draft_tokens = 0
        self._window_accepted_tokens = 0
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

    def _first_token(self, logits, req: Request) -> int:
        """The request's first generated token from its last prompt row's
        logits ``[1, V]``: with keyed sampling, drawn at the absolute
        position ``prompt_len`` (whole-prompt prefill and the final chunk
        alike), greedy for a request without ``do_sample``."""
        if not self._keyed:
            return int(self._sample(logits)[0])
        return int(keyed_sample(
            logits, [req.seed or 0], [req.prompt_len],
            [1 if req.do_sample else 0],
            [req.temperature if req.temperature is not None else 1.0],
            [req.top_k or 0], [req.top_p or 0.0])[0])

    def _set_samp_slot(self, slot: int, req: Request):
        """Load one slot's sampling row from the request's (resolved)
        knobs: the only per-slot sampler state."""
        self._seeds[slot] = int(req.seed or 0) & 0xFFFFFFFF
        self._samp_on[slot] = 1 if req.do_sample else 0
        self._temps[slot] = (req.temperature
                             if req.temperature is not None else 1.0)
        self._top_ks[slot] = req.top_k or 0
        self._top_ps[slot] = req.top_p or 0.0

    def _clear_samp_slot(self, slot: int):
        self._seeds[slot] = 0
        self._samp_on[slot] = 0
        self._temps[slot] = 1.0
        self._top_ks[slot] = 0
        self._top_ps[slot] = 0.0

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
            self._begin(slot, req, table, done)
        self._prefill_chunks(done)
        # one decode step for the whole slot batch (mid-prefill slots are
        # idle decode rows: garbage table, outputs ignored); with
        # speculation on, the verify step IS the decode step
        if any(slot not in self._prefilling
               for slot, _ in self.sched.running()):
            if self._proposer is not None:
                self._spec_step(done)
            else:
                self._decode_step(done)
        return done

    def _begin(self, slot: int, req: Request, table: np.ndarray,
               done: List[Request]):
        """Route a fresh admission: whole-prompt bucketed prefill, or the
        chunked / prefix-continued path when the request has pooled
        prefix tokens to skip or chunking is on."""
        if req.cow is not None:
            # partial-tail copy-on-write: the matched block will be
            # appended to, so the request's own fresh block receives a
            # device copy of its rows before anything else runs; the
            # source unpins once the copy is queued (stream order)
            self._cow_copy(*req.cow)
            self.block_mgr.cow_done(req.request_id)
        if not self.chunk_tokens and req.cached_len == 0:
            self._prefill(slot, req, table, done)
            return
        self._prefilling[slot] = req
        self._pf_tables[slot] = table
        self._pf_pos[slot] = req.cached_len
        req.length = req.cached_len

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
        tok = self._first_token(logits, req)
        req.prefill_chunks = 1
        self._slot_live(slot, req, table, tok, done)

    # ------------------------------------------------------------------
    def _prefill_chunks(self, done: List[Request]):
        """Advance mid-prefill prompts. With chunking on, at most
        ``prefill_chunk_tokens`` prompt tokens are processed per step
        (round-robin over slots, so a long prompt never starves a later
        short one); with chunking off (prefix-cache tails) each pending
        tail completes now in one bucketed chunk."""
        if not self._prefilling:
            return
        budget = self.chunk_tokens or None
        spent = 0
        slots = sorted(self._prefilling)
        start = next((i for i, s in enumerate(slots)
                      if s >= self._pf_next), 0)
        for slot in slots[start:] + slots[:start]:
            req = self._prefilling.get(slot)
            if req is None:
                continue
            table = self._pf_tables[slot]
            pos = self._pf_pos[slot]
            remaining = req.prompt_len - pos
            step_len = (min(self.chunk_tokens, remaining)
                        if self.chunk_tokens else remaining)
            T = self.chunk_tokens or bucket_for(remaining, self.buckets)
            last = pos + step_len >= req.prompt_len
            tok = self._chunk_call(req, table, pos, step_len, T, last)
            self._pf_pos[slot] = pos + step_len
            req.length = pos + step_len
            req.prefill_chunks += 1
            if last:
                del self._prefilling[slot]
                self._pf_tables.pop(slot, None)
                self._pf_pos.pop(slot, None)
                self._slot_live(slot, req, table, tok, done)
            if budget is not None:
                spent += step_len
                if spent >= budget:
                    self._pf_next = slot + 1
                    return

    def _chunk_call(self, req: Request, table: np.ndarray, pos: int,
                    step_len: int, T: int, last: bool) -> Optional[int]:
        """One prefill chunk: write ``step_len`` prompt tokens (right-
        padded to ``T``) at pool length ``pos`` and attend them against
        everything already pooled (shared prefix blocks included) plus
        themselves, causally. Only the final chunk's token is used (the
        request's first generated token): the others return None without
        running the LM head or syncing."""
        ids = np.zeros((1, T), np.int64)
        ids[0, :step_len] = req.prompt[pos:pos + step_len]
        paging = {"block_tables": self._on_device(table[None]),
                  "lengths": self._on_device([pos]),
                  "num_valid": self._on_device([step_len]),
                  "prefill": False}
        hidden = self.model(self._on_device(ids, torch.long),
                            cache=self.cache, paging=paging,
                            return_hidden=True)
        if not last:
            return None
        logits = self.model.lm_head(hidden[:, step_len - 1])
        # the final chunk ends the prompt: pos + step_len = prompt_len,
        # the position the whole-prompt prefill draws at too
        return self._first_token(logits, req)

    def _slot_live(self, slot: int, req: Request, table: np.ndarray,
                   tok: int, done: List[Request]):
        """Prompt fully pooled: index the prompt for future prefix hits,
        join the decode batch, and emit the first sampled token."""
        req.first_token_ts = self.clock()
        req.length = req.prompt_len
        self._tables[slot] = table
        self._lengths[slot] = req.prompt_len
        self._last_tokens[slot] = tok
        if self._keyed:
            self._set_samp_slot(slot, req)
        if self.prefix is not None:
            # BEFORE any finish: insertion must precede release so a
            # one-token request's blocks park evictable, not freed
            self.prefix.insert(req.prompt, table)
        finished = (tok == req.eos_token_id
                    or len(req.tokens) + 1 >= req.max_new_tokens)
        req.emit_token(tok, finished)
        if finished:
            reason = "eos" if tok == req.eos_token_id else "max_tokens"
            self._finish(req, reason, self.clock(), done)

    def _cow_copy(self, src: int, dst: int):
        """Copy pool block ``src``'s rows onto block ``dst`` in place, in
        every pool and scale pool of every layer."""
        for pool in self.cache.pools():
            pool[dst].copy_(pool[src])

    # ------------------------------------------------------------------
    def _decode_step(self, done: List[Request]):
        active = [(s, r) for s, r in self.sched.running()
                  if s not in self._prefilling]
        n = self.config.decode_slots
        paging = {"block_tables": self._on_device(self._tables),
                  "lengths": self._on_device(self._lengths),
                  "num_valid": self._on_device(np.ones((n,), np.int32)),
                  "prefill": False}
        hidden = self.model(self._on_device(self._last_tokens[:, None],
                                            torch.long),
                            cache=self.cache, paging=paging,
                            return_hidden=True)
        logits = self.model.lm_head(hidden[:, -1])
        if self._keyed:
            # this step emits the token at absolute position lengths + 1
            # (lengths tokens pooled, the pending last token at lengths)
            toks = keyed_sample(logits, self._seeds, self._lengths + 1,
                                self._samp_on, self._temps, self._top_ks,
                                self._top_ps)
        else:
            toks = self._sample(logits)
        # the one host sync per decode step: sampled tokens stream to
        # callers and drive the finish logic
        toks = toks.cpu().numpy()
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

    def _spec_step(self, done: List[Request]):
        """One speculative decode step: propose draft tokens on the host,
        score every slot's pending token + proposals in ONE verify
        forward, then commit the longest prefix the greedy tokens agreed
        with. Emits 1 to ``k + 1`` tokens per active slot; proposals
        right-pad to ``k`` against the garbage block."""
        k = self.spec_k
        n = self.config.decode_slots
        active = [(s, r) for s, r in self.sched.running()
                  if s not in self._prefilling]
        tokens = np.zeros((n, k + 1), np.int64)
        tokens[:, 0] = self._last_tokens
        num_valid = np.ones((n,), np.int32)
        proposals = {}
        for slot, req in active:
            budget = self.sched.speculative_budget(req, k)
            props = []
            if budget > 0:
                props = [int(t) for t in
                         self._proposer.propose(req, budget)][:budget]
            proposals[slot] = props
            if props:
                tokens[slot, 1:1 + len(props)] = props
                num_valid[slot] = 1 + len(props)
            # open the speculative ledger window over the verify write
            # extent [0, length + 1 + n_p). Admission's worst-case
            # reservation covers every window this engine can open, so
            # the grant must be empty: a grant would also need the slot's
            # row of self._tables extended first
            granted = self.block_mgr.speculate(req.request_id,
                                               req.length + 1 + len(props))
            assert not granted, \
                "speculative grant without a device table update"
        paging = {"block_tables": self._on_device(self._tables),
                  "lengths": self._on_device(self._lengths),
                  "num_valid": self._on_device(num_valid),
                  "prefill": False}
        hidden = self.model(self._on_device(tokens, torch.long),
                            cache=self.cache, paging=paging,
                            return_hidden=True)
        logits = self.model.lm_head(hidden)                 # [N, k+1, V]
        # the one host sync per step: verified tokens drive commit/finish
        toks = self._sample(logits.reshape(n * (k + 1), -1)).reshape(
            n, k + 1).cpu().numpy()
        now = self.clock()
        self._step_count += 1
        self._spec_steps += 1
        for slot, req in active:
            props = proposals[slot]
            accepted = 0
            for p in props:
                if int(toks[slot, accepted]) == p:
                    accepted += 1
                else:
                    break
            req.draft_tokens += len(props)
            self._window_draft_tokens += len(props)
            req.accepted_tokens += accepted
            self._window_accepted_tokens += accepted
            finished, reason = self._spec_commit(slot, req, toks[slot],
                                                 accepted)
            if finished:
                self._finish(req, reason, now, done)

    def _spec_commit(self, slot: int, req: Request, row, accepted: int):
        """Commit one verified row: emit the model's greedy tokens at rows
        ``0..accepted`` (the accepted drafts, then the correction — or,
        with everything accepted, the bonus token) under the sequential
        finish semantics, so eos / token budget / model window stop the
        stream exactly where non-speculative decode would. The accepted
        extent folds into the block ledger in place; the rejected tail
        drops without copies."""
        finished, reason = False, None
        for i in range(accepted + 1):
            tok = int(row[i])
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
                break
        # + 1: the pending last token's next write lands at req.length
        self.block_mgr.commit_speculative(req.request_id, req.length + 1)
        return finished, reason

    def _finish(self, req: Request, reason: str, now: float,
                done: List[Request]):
        self.sched.finish(req, reason, now)
        # an idle slot computes into the garbage block until the next
        # admission overwrites its row
        if 0 <= req.slot < len(self._tables):
            self._tables[req.slot] = 0
            self._lengths[req.slot] = 0
            self._last_tokens[req.slot] = 0
            if self._keyed:
                self._clear_samp_slot(req.slot)
            self._prefilling.pop(req.slot, None)
            self._pf_tables.pop(req.slot, None)
            self._pf_pos.pop(req.slot, None)
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
        self._spec_steps = 0
        self._window_draft_tokens = 0
        self._window_accepted_tokens = 0
        self.sched.reset_stats()

    def stats(self) -> dict:
        """Aggregate serving metrics over the records window."""
        ttfts = [r["ttft_ms"] for r in self.records
                 if r.get("ttft_ms") is not None]
        rates = [r["tokens_per_sec"] for r in self.records
                 if r.get("tokens_per_sec") is not None]
        prefix_stats = None
        if self.prefix is not None:
            finished = [r for r in self.records if r["state"] != "shed"]
            prompt_toks = sum(r["prompt_len"] for r in finished)
            hit_toks = sum(r["prefix_hit_tokens"] for r in finished)
            prefix_stats = {
                **self.prefix.stats,
                "cached_blocks": self.block_mgr.num_cached,
                "evictions": self.block_mgr.evictions,
                "window_hit_rate": round(hit_toks / prompt_toks, 4)
                if prompt_toks else 0.0,
            }
        spec_stats = None
        if self._proposer is not None:
            # window counters, not the bounded records deque
            drafts = self._window_draft_tokens
            acc = self._window_accepted_tokens
            spec_stats = {
                "proposer": self._proposer.name,
                "num_speculative_tokens": self.spec_k,
                "draft_tokens": drafts,
                "accepted_tokens": acc,
                "acceptance_rate": round(acc / drafts, 4)
                if drafts else None,
                # extra tokens one verify step bought, over the window
                "accepted_tokens_per_step": round(acc / self._spec_steps, 4)
                if self._spec_steps else None,
            }
        s = self.sched.stats
        total = max(1, s["submitted"])
        return {
            "prefix_cache": prefix_stats,
            "speculative": spec_stats,
            "finished": s["finished"], "shed": s["shed"],
            "shed_reasons": dict(s["shed_reasons"]),
            "shed_rate": round(s["shed"] / total, 4),
            "queue_peak": s["queue_peak"],
            "decode_steps": self._step_count,
            "ttft_ms_p50": float(np.percentile(ttfts, 50)) if ttfts else None,
            "ttft_ms_p95": float(np.percentile(ttfts, 95)) if ttfts else None,
            "tokens_per_sec_mean": float(np.mean(rates)) if rates else None,
        }
