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

Under tensor parallelism (an engine with ``tensor_parallel.tp_size`` N)
every rank runs this engine with the same calls: its pools hold its
``n_head / N`` heads of every block, and the block tables, the block
manager and the scheduler are every rank's alike, so each rank makes the
same decisions and emits the same tokens. Deadlines read each rank's own
``clock``: give the ranks one clock, or a deadline that expires on one
rank alone parts them.

The seams of the serving fleet (``serving/router.py``): ``gauges`` (the
load the router routes by), ``cancel`` (failover releases an abandoned
proxy's slot and blocks), and live KV migration: ``export_sequence``
copies one decode-ready sequence's pool rows to the host (bf16 rows as
their int16 bits), ``import_sequence`` copies them into this engine's
pools at freshly allocated blocks (``index_copy_`` on every pool and
scale pool) and splices the request into a free slot, where it resumes
decoding with no prefill; ``migrate_out`` detaches the source copy. The
chaos seams ``serving.spec_commit``, ``serving.migration.export`` and
``serving.migration.commit`` (``runtime/resilience/chaos.py``) fire as
in the JAX engine.

Telemetry is the wrapped inference engine's (its ``telemetry`` section,
as in JAX): the ``serving`` events ``request.queued``,
``request.finish`` / ``request.shed`` (:meth:`Request.record`),
``step.gauges`` and ``request.migrated_in`` / ``_out``; the request
spans ``serve`` / ``queue`` (the scheduler's), ``prefill``,
``prefill_chunk``, ``cow``, ``draft``, ``verify``, ``spec_commit`` and
``decode``; the registry's serving histograms, counters and gauges; a
step boundary a decode step; and the signature watch on the prefill,
chunk, decode and verify forwards. Spans time host dispatch and read the
engine's clock; none adds a sync. The inference engine's resilience
manager brackets each admitted request for the hang watchdog (begun at
admission or migration in, progress each decode or verify step, a
heartbeat at each finish, abandoned at a shed, cancel or migration
out), at JAX's sites.

On a ``data x tp`` mesh (the engine's), ``tp`` splits the pools (each
rank holds ``1 / tp`` of the pool bytes) and ``data`` replicates the
server, as JAX's serving engine replicates its slots over ``data``:
every data group runs the same server on the same submits and emits the
same tokens. More cards buy throughput through the fleet
(``serving/router.py``, ``serving/group_replica.py``), not through
``data``.
"""

import collections
import contextlib
import time
from typing import List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.engine import (InferenceEngine,
                                                  model_window,
                                                  sample_logits)
from deepspeed_tpu_torch.ops.sampling import keyed_sample
from deepspeed_tpu_torch.runtime.resilience.chaos import raise_if
from deepspeed_tpu_torch.serving.blocks import BlockManager
from deepspeed_tpu_torch.serving.config import (ServingConfig,
                                                blocks_for_tokens,
                                                bucket_for, resolve_buckets)
from deepspeed_tpu_torch.serving.prefix_cache import PrefixCache
from deepspeed_tpu_torch.serving.request import FINISHED, Request
from deepspeed_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
from deepspeed_tpu_torch.serving.spec_decode import build_proposer
from deepspeed_tpu_torch.telemetry.tracing import end_span, to_ns
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
            self._owns_engine = False
        else:
            self.engine = InferenceEngine(model_or_engine, config=config,
                                          **kwargs)
            self._owns_engine = True
        scfg = self.engine._serving_cfg
        if scfg is None or not scfg.enabled:
            raise ValueError(
                "ServingEngine needs a `serving` block in the inference "
                'config, e.g. init_inference(model, serving={"block_size": '
                '16, "decode_slots": 4})')
        self.config: ServingConfig = scfg
        self.device = self.engine.device

        mcfg = self.engine.model_config
        if mcfg is None or not hasattr(mcfg, "for_paged_decode"):
            raise ValueError(
                "serving needs a model whose config provides "
                "for_paged_decode() — the canonical decoder family "
                "(GPT2LMHeadModel and its OPT/BLOOM/GPT-J/NeoX variants)")
        window = model_window(mcfg)
        self.max_len = int(self.config.max_model_len or window or 1024)
        if window:
            self.max_len = min(self.max_len, int(window))
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
        self.telemetry = self.engine.telemetry
        self.resilience = self.engine.resilience
        self._finished_count = 0
        # span tracer (inert unless telemetry.tracing is on)
        self._tracer = self.telemetry.tracer
        self._metrics = self.telemetry.metrics
        self.sched = ContinuousBatchingScheduler(
            self.config, self.block_mgr, self.max_len, self.buckets,
            clock=self.clock, prefix_cache=self.prefix,
            tracer=self._tracer)
        # the forwards, through the signature watch (the function itself
        # with telemetry off, unbound: a bound method kept here would
        # make a reference cycle), named as JAX names their programs
        suffix = {"prefill": lambda ids: f"T={ids.shape[1]}",
                  "chunk": lambda ids: f"T={ids.shape[1]}",
                  "decode": lambda ids: f"slots={ids.shape[0]}",
                  "verify": lambda ids: (f"slots={ids.shape[0]},"
                                         f"k={ids.shape[1] - 1}")}
        self._forward = {kind: self.telemetry.watch_jit(
            ServingEngine._model_forward, f"serving.{kind}",
            name_of=lambda srv, ids, paging, kind=kind, fn=fn:
                f"serving.{kind}[{fn(ids)}]")
            for kind, fn in suffix.items()}
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
        self._window_prompt_tokens = 0
        self._window_hit_tokens = 0
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

    def _model_forward(self, ids, paging):
        """The paged model's hidden states for ``ids`` (every forward of
        this engine: prefill, chunk, decode, verify)."""
        return self.model(ids, cache=self.cache, paging=paging,
                          return_hidden=True)

    def _req_span(self, req: Request, name: str, **attrs):
        """Span bracket in ``req``'s trace (nullcontext when tracing is
        off or the request carries no context)."""
        if not self._tracer.enabled or req.trace is None:
            return contextlib.nullcontext()
        return self._tracer.span(name, req.trace["trace"],
                                 parent=req.trace.get("serve_id"), **attrs)

    def _step_boundary(self, active: int):
        """A decode step's boundary: the manager's step, and the
        ``step.gauges`` event and registry gauges (one slot scan, only
        with telemetry on)."""
        self.telemetry.on_step_boundary(self._step_count, samples=active)
        if self.telemetry.enabled:
            g = self.gauges()
            self.telemetry.emit("serving", "step.gauges",
                                step=self._step_count, **g)
            self._metrics_step_gauges(g)
        # host-observed per-step token progress: a server saturated with
        # long generations must not be judged hung between completions
        self.resilience.serving_step_progress()

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 0, **kwargs) -> Request:
        """Admit one request (non-blocking). Returns the Request; its
        ``state`` is ``queued`` on success or ``shed`` (with
        ``finish_reason``) when admission control rejected it."""
        prompt = [int(t) for t in np.asarray(prompt).ravel()]
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      **kwargs)
        if self.sched.submit(req):
            self.resilience.serving_request_begin()
            self.telemetry.emit("serving", "request.queued",
                                step=self._step_count,
                                request_id=req.request_id,
                                prompt_len=req.prompt_len)
        else:
            self._record(req, shed=True, began=False)
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
            self._record(req, shed=True)
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
            with self._req_span(req, "cow", src=req.cow[0],
                                dst=req.cow[1]):
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
        with self._req_span(req, "prefill", bucket=T,
                            prompt_len=req.prompt_len):
            hidden = self._forward["prefill"](
                self, self._on_device(ids, torch.long), paging)
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
        with self._req_span(req, "prefill_chunk", pos=pos, tokens=step_len,
                            bucket=T):
            hidden = self._forward["chunk"](
                self, self._on_device(ids, torch.long), paging)
            if not last:
                return None
            logits = self.model.lm_head(hidden[:, step_len - 1])
            # the final chunk ends the prompt: pos + step_len =
            # prompt_len, the position the whole-prompt prefill draws at
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
        hidden = self._forward["decode"](
            self, self._on_device(self._last_tokens[:, None], torch.long),
            paging)
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
        self._step_boundary(len(active))
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
                with self._req_span(req, "draft",
                                    proposer=self._proposer.name,
                                    budget=budget):
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
        t0 = self.clock()
        hidden = self._forward["verify"](
            self, self._on_device(tokens, torch.long), paging)
        logits = self.model.lm_head(hidden)                 # [N, k+1, V]
        # the one host sync per step: verified tokens drive commit/finish
        toks = self._sample(logits.reshape(n * (k + 1), -1)).reshape(
            n, k + 1).cpu().numpy()
        now = self.clock()
        # chaos seam: a replica killed BETWEEN verify and commit has
        # emitted nothing from this window — host state is exactly the
        # pre-step state, so a retry or failover replays cleanly and the
        # router's exactly-once splice sees no speculative token
        raise_if("serving.spec_commit")
        self._step_count += 1
        self._spec_steps += 1
        self._step_boundary(len(active))
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
            if self._tracer.enabled and req.trace is not None:
                # per-request view of the SHARED batched verify forward
                self._tracer.record_span(
                    "verify", req.trace["trace"], to_ns(t0), to_ns(now),
                    parent=req.trace.get("serve_id"),
                    proposed=len(props), accepted=accepted,
                    request_id=req.request_id)
            with self._req_span(req, "spec_commit", accepted=accepted):
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
        if (self._tracer.enabled and req.trace is not None
                and req.first_token_ts):
            # one decode segment: first generated token -> finish
            self._tracer.record_span(
                "decode", req.trace["trace"], to_ns(req.first_token_ts),
                to_ns(now), parent=req.trace.get("serve_id"),
                tokens=len(req.tokens), request_id=req.request_id)
        self.sched.finish(req, reason, now)
        self._clear_slot(req.slot)
        self._record(req, shed=False, began=True)
        done.append(req)

    def _record(self, req: Request, shed: bool, began: bool = True):
        """One terminal request: its record kept for :meth:`stats`, the
        ``request.finish`` / ``request.shed`` event, the registry feed,
        and the close of its ``serve`` span."""
        rec = req.record()
        self.records.append(rec)
        self.telemetry.emit(
            "serving", "request.shed" if shed else "request.finish",
            step=self._step_count, **rec)
        self._metrics_record(req, rec, shed)
        if self._tracer.enabled and req.trace is not None:
            end_span(req.trace.pop("serve", None),
                     end_ns=to_ns(req.finish_ts or req.submit_ts),
                     state=req.state, reason=req.finish_reason,
                     tokens=len(req.tokens))
        if not began:
            return  # never bracketed: submit-time shed
        if shed:
            self.resilience.serving_request_abandon()
        else:
            self._finished_count += 1
            self.resilience.serving_heartbeat(self._finished_count)

    def _metrics_record(self, req: Request, rec: dict, shed: bool):
        """Per-terminal-request registry feed (JAX's): latency
        histograms, outcome / token counters, prefix-cache and
        speculation window gauges; a no-op call a line when metrics are
        off."""
        m = self._metrics
        m.counter("ds_serving_requests_total", ("outcome",)).labels(
            outcome="shed" if shed else "finished").inc()
        if rec.get("ttft_ms") is not None:
            m.histogram("ds_serving_ttft_ms").observe(rec["ttft_ms"])
        if rec.get("queue_ms") is not None:
            m.histogram("ds_serving_queue_ms").observe(rec["queue_ms"])
        if shed:
            return
        m.counter("ds_serving_tokens_total").inc(rec.get("new_tokens") or 0)
        if req.tokens:
            m.histogram("ds_serving_decode_ms").observe(
                1e3 * max(req.finish_ts - req.first_token_ts, 0.0))
        if self.prefix is not None:
            self._window_prompt_tokens += rec.get("prompt_len") or 0
            self._window_hit_tokens += rec.get("prefix_hit_tokens") or 0
            if self._window_prompt_tokens:
                m.gauge("ds_prefix_cache_hit_rate").set(round(
                    self._window_hit_tokens
                    / self._window_prompt_tokens, 4))
        if self._proposer is not None:
            drafts = rec.get("draft_tokens") or 0
            acc = rec.get("accepted_tokens") or 0
            if drafts:
                m.counter("ds_spec_draft_tokens_total").inc(drafts)
                m.counter("ds_spec_accepted_tokens_total").inc(acc)
            if self._window_draft_tokens:
                m.gauge("ds_spec_acceptance_rate").set(round(
                    self._window_accepted_tokens
                    / self._window_draft_tokens, 4))

    def _metrics_step_gauges(self, g: dict):
        """Per-decode-step pool / queue gauges from the same ``gauges()``
        payload the ``step.gauges`` event carries."""
        m = self._metrics
        m.gauge("ds_serving_queue_depth").set(g.get("queue_depth", 0))
        m.gauge("ds_serving_slots_busy").set(g.get("slots_busy", 0))
        m.gauge("ds_serving_slots_total").set(g.get("slots_total", 0))
        bm = self.block_mgr
        usable = max(1, bm.num_blocks - 1)   # garbage block excluded
        used = bm.num_allocated
        tier = m.gauge("ds_kv_pool_blocks", ("tier",))
        tier.labels(tier="free").set(bm.num_free)
        tier.labels(tier="cached").set(bm.num_cached)
        tier.labels(tier="used").set(used)
        m.gauge("ds_kv_pool_occupancy").set(round(used / usable, 4))
        committed = int(g.get("committed_tokens", 0))
        capacity = used * self.config.block_size
        m.gauge("ds_kv_pool_fragmentation").set(
            round(1.0 - committed / capacity, 4) if capacity else 0.0)

    def _clear_slot(self, slot: int):
        """Reset a released slot's host rows: an idle slot computes into
        the garbage block until the next admission overwrites them."""
        if 0 <= slot < len(self._tables):
            self._tables[slot] = 0
            self._lengths[slot] = 0
            self._last_tokens[slot] = 0
            if self._keyed:
                self._clear_samp_slot(slot)
            self._prefilling.pop(slot, None)
            self._pf_tables.pop(slot, None)
            self._pf_pos.pop(slot, None)

    # ------------------------------------------------------------------
    def cancel(self, request_id: str, reason: str = "cancelled") -> bool:
        """Abandon one in-flight request (queued or mid-decode): its
        decode slot, KV blocks and token budget release immediately and
        it is recorded as shed with ``reason``. The multi-replica router
        calls this at failover so abandoned proxies never keep decoding
        on a replica that later recovers."""
        req = self.sched.cancel(request_id, reason, self.clock())
        if req is None:
            return False
        self._clear_slot(req.slot)
        self._record(req, shed=True)
        return True

    # ------------------------------------------------------------------
    # live KV-block migration seams (serving/migration.py orchestrates;
    # the router and fleet manager are the consumers — failover, drain
    # and fragmentation rebalance move committed state instead of
    # replaying it)
    def _layout(self) -> list:
        """The pools' layout signature, what an import must match (the
        JAX engine compares pytree structures): layers, then each pool's
        shape past the block axis and its dtype, in ``pools()`` order."""
        return [self.engine.model_config.n_layer] + [
            [list(p.shape[1:]), str(p.dtype).replace("torch.", "")]
            for p in self.cache.pools()]

    def export_sequence(self, request_id: str) -> Optional[dict]:
        """Snapshot one decode-ready sequence's committed state for import
        on another replica: the request's identity and counters, its
        pending last token, and the rows of its covered blocks from every
        pool (int8 scale pools ride the same block indices), copied to
        the host before any later step can write them. A bf16 pool's
        rows travel as their int16 bits (numpy has no bfloat16), named
        in ``dtypes``; ``wire_bytes`` counts every row's bytes. Read-only
        on the source (an open speculative window is dropped first — it
        is uncommitted by definition), so a transfer that dies downstream
        leaves this replica able to keep decoding or to serve a replay.
        Returns None when the request is not migratable (unknown, queued,
        or still mid-prefill — those replay or resubmit cheaply)."""
        raise_if("serving.migration.export", detail=request_id)
        req = next((r for _, r in self.sched.running()
                    if r.request_id == request_id), None)
        if req is None or req.slot in self._prefilling or req.length <= 0:
            return None
        if self.block_mgr.speculating(request_id):
            self.block_mgr.drop_speculative(request_id)
        bs = self.config.block_size
        covered = self.block_mgr.owned(request_id)[
            :blocks_for_tokens(req.length, bs)]
        idx = self._on_device(covered, torch.long)
        rows, dtypes, wire_bytes = [], [], 0
        for pool in self.cache.pools():
            r = pool.index_select(0, idx).cpu()
            dtypes.append(str(r.dtype).replace("torch.", ""))
            if r.dtype == torch.bfloat16:
                r = r.view(torch.int16)
            r = r.numpy()
            wire_bytes += r.nbytes
            rows.append(r)
        return {
            "request_id": req.request_id,
            "prompt": list(req.prompt),
            "tokens": list(req.tokens),
            "max_new_tokens": int(req.max_new_tokens),
            "eos_token_id": int(req.eos_token_id),
            "deadline_ms": float(req.deadline_ms),
            "length": int(req.length),
            "last_token": int(self._last_tokens[req.slot]),
            "do_sample": bool(self.config.do_sample),
            # keyed per-request sampling state: the seed and knobs ARE
            # the whole sampler — position comes from length, so the
            # spliced slot resumes the stream with no counter
            # re-derivation (None for greedy requests)
            "sampling": ({
                "do_sample": True, "seed": int(req.seed or 0),
                "temperature": float(req.temperature
                                     if req.temperature is not None
                                     else 1.0),
                "top_k": int(req.top_k or 0),
                "top_p": float(req.top_p or 0.0),
            } if req.do_sample else None),
            "block_size": bs,
            "kv_cache_dtype": self.config.kv_cache_dtype or None,
            "blocks": len(covered),
            "rows": rows,
            "dtypes": dtypes,
            "layout": self._layout(),
            "wire_bytes": int(wire_bytes),
            "draft_tokens": int(req.draft_tokens),
            "accepted_tokens": int(req.accepted_tokens),
        }

    def import_sequence(self, export: Optional[dict],
                        deadline_ms: Optional[float] = None,
                        stream=None,
                        request_id: Optional[str] = None,
                        trace: Optional[dict] = None
                        ) -> Optional[Request]:
        """Splice an exported sequence into a free decode slot: allocate
        blocks, copy the migrated rows onto this engine's pools at those
        blocks (never block 0, the garbage block), seed the request's
        token and sampling counters, and resume decoding mid-stream — NO
        prefill or chunk call. Returns None when the export cannot land
        here (pool layout / dtype / sampling mismatch, no free slot,
        duplicate id, or not enough blocks) so the caller can fall back
        to replay. The slot is taken last: a fault before it (the
        ``serving.migration.commit`` chaos seam) releases every block
        this call allocated and leaves the scheduler untouched."""
        if export is None:
            return None
        rid = request_id or export["request_id"]
        samp = export.get("sampling")
        if (export["block_size"] != self.config.block_size
                or (export.get("kv_cache_dtype") or None)
                != (self.config.kv_cache_dtype or None)
                or bool(export["do_sample"]) != bool(self.config.do_sample)
                # a keyed sampled stream can only resume on a replica
                # that folds the same keys — a greedy target would
                # quietly continue it greedily
                or (samp is not None and not self._keyed)
                or rid in self.sched._live_ids):
            return None
        slot = self.sched.free_slot()
        if slot is None:
            return None
        mnt = int(export["max_new_tokens"]
                  or self.config.default_max_new_tokens)
        cost = len(export["prompt"]) + mnt
        if (cost > self.max_len or int(export["length"]) > cost
                or not self.block_mgr.can_allocate_shared(cost, (), None)):
            return None
        if export.get("layout") != self._layout():
            return None
        now = self.clock()
        req = Request(prompt=list(export["prompt"]),
                      max_new_tokens=mnt, request_id=rid,
                      eos_token_id=int(export["eos_token_id"]),
                      deadline_ms=(deadline_ms if deadline_ms is not None
                                   else export["deadline_ms"]),
                      stream=stream)
        if samp is not None:
            req.do_sample = True
            req.seed = int(samp["seed"])
            req.temperature = float(samp["temperature"])
            req.top_k = int(samp["top_k"])
            req.top_p = float(samp["top_p"])
        # the delivered prefix rides along verbatim — seeded directly, NOT
        # via emit_token (the client already holds these tokens; the
        # stream fires only for tokens decoded after the splice)
        req.tokens = list(export["tokens"])
        req.draft_tokens = int(export.get("draft_tokens") or 0)
        req.accepted_tokens = int(export.get("accepted_tokens") or 0)
        req.submit_ts = now
        if req.tokens:
            req.first_token_ts = now
        # router-stamped trace context: the spliced request's replica
        # spans join the CLIENT's trace under the migration attempt
        req.trace = dict(trace) if trace is not None else None
        table = self.block_mgr.allocate(rid, cost)
        try:
            B = int(export["blocks"])
            if B:
                dst = np.asarray(table[:B], np.int64)
                if dst.min() <= 0:
                    raise ValueError(
                        f"import of {rid!r} would write block {dst.min()}: "
                        f"block 0 is the garbage block")
                dst = self._on_device(dst, torch.long)
                for pool, rows, dtype in zip(self.cache.pools(),
                                             export["rows"],
                                             export["dtypes"]):
                    src = torch.from_numpy(np.ascontiguousarray(rows))
                    if dtype == "bfloat16":
                        src = src.view(torch.bfloat16)
                    pool.index_copy_(0, dst, src.to(pool.device))
            raise_if("serving.migration.commit", detail=rid)
            self.sched.splice(req, slot, now)
        except Exception:
            # rows already copied are stale bytes in blocks the pool no
            # longer maps — harmless; the scheduler never saw us
            self.block_mgr.release(rid)
            raise
        req.length = int(export["length"])
        self._tables[slot] = table
        self._lengths[slot] = req.length
        self._last_tokens[slot] = int(export["last_token"])
        if self._keyed:
            self._set_samp_slot(slot, req)
        self.resilience.serving_request_begin()
        self.telemetry.emit("serving", "request.migrated_in",
                            step=self._step_count, request_id=rid,
                            blocks=int(export["blocks"]),
                            wire_bytes=int(export["wire_bytes"]),
                            length=req.length)
        return req

    def migrate_out(self, request_id: str) -> bool:
        """Detach a migrated-away request from this replica: free its
        slot, blocks and token budget WITHOUT a shed record — the request
        is still live, on another replica. Call only after the target
        committed its import."""
        now = self.clock()
        req = self.sched.migrate_out(request_id, now)
        if req is None:
            return False
        self._clear_slot(req.slot)
        if self._tracer.enabled and req.trace is not None:
            end_span(req.trace.pop("serve", None), end_ns=to_ns(now),
                     state="migrated", tokens=len(req.tokens))
        self.resilience.serving_request_abandon()
        self.telemetry.emit("serving", "request.migrated_out",
                            step=self._step_count, request_id=request_id,
                            tokens=len(req.tokens))
        return True

    def gauges(self) -> dict:
        """Instantaneous load gauges (queue depth, busy slots, free
        blocks, pool fragmentation): the numbers the multi-replica router
        routes by and the fleet manager's rebalance reads."""
        g = {**self.sched.gauges(), "free_blocks": self.block_mgr.num_free}
        if self.prefix is not None:
            g["cached_blocks"] = self.block_mgr.num_cached
        # decode-side fragmentation: reserved-but-uncommitted token rows
        # over reserved capacity (the rebalance trigger)
        committed = int(g.get("committed_tokens", 0))
        capacity = self.block_mgr.num_allocated * self.config.block_size
        g["kv_fragmentation"] = (round(1.0 - committed / capacity, 4)
                                 if capacity else 0.0)
        return g

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
        self._window_prompt_tokens = 0
        self._window_hit_tokens = 0
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
            "tp": self.engine.mp_world_size,
            "prefix_cache": prefix_stats,
            "speculative": spec_stats,
            "finished": s["finished"], "shed": s["shed"],
            "shed_reasons": dict(s["shed_reasons"]),
            "shed_rate": round(s["shed"] / total, 4),
            "migrated_in": s["migrated_in"],
            "migrated_out": s["migrated_out"],
            "queue_peak": s["queue_peak"],
            "decode_steps": self._step_count,
            "ttft_ms_p50": float(np.percentile(ttfts, 50)) if ttfts else None,
            "ttft_ms_p95": float(np.percentile(ttfts, 95)) if ttfts else None,
            "tokens_per_sec_mean": float(np.mean(rates)) if rates else None,
        }

    def destroy(self):
        """Drop the pools (and the decode module); drops the wrapped
        engine too when this ServingEngine built it. The engine is
        unusable after."""
        self.cache = None
        self.model = None
        if self._owns_engine:
            self.engine = None
