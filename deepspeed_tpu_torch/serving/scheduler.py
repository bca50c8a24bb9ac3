"""Continuous-batching scheduler: admission queue -> prefill -> decode
slots (counterpart of ``deepspeed_tpu/serving/scheduler.py``).

Pure host-side policy — no torch imports. The device work (bucketed
prefill, the fixed-slot decode step) lives in
:mod:`deepspeed_tpu_torch.serving.engine`; this class decides *which*
request runs *where* and *when*:

- ``submit`` applies admission control: prompt must fit a bucket, queue
  depth is bounded, and (policy ``shed``) committed tokens — the
  worst-case ``prompt + max_new`` over queued + running work — must stay
  under ``max_inflight_tokens``. Policy ``queue`` accepts the request
  and defers slot admission instead.
- ``admit`` splices queued requests into free decode slots *between*
  decode steps: expired requests are shed from the head, block-pool
  backpressure defers admission (never drops — blocks free as running
  sequences finish), and each admitted request gets its block table.
  With a prefix cache attached, admission first matches the longest
  cached prefix: matched full blocks map read-only into the table
  (refcount++, nothing prefills twice), a matched partial tail is
  scheduled for copy-on-write, and the request carries how many prompt
  tokens its prefill may skip (``cached_len``).
- ``finish``/``shed``/``cancel`` return capacity (slot, blocks, token
  budget) immediately; ``splice`` and ``migrate_out`` are the live KV
  migration seams (a request enters or leaves a decode slot
  mid-stream), ``gauges`` the load the multi-replica router routes by.
"""

import time
from collections import deque
from typing import List, Optional, Tuple

from deepspeed_tpu_torch.serving import request as rq
from deepspeed_tpu_torch.serving.blocks import BlockManager
from deepspeed_tpu_torch.serving.config import (QUEUE, ServingConfig, bucket_for,
                                          resolve_buckets)
from deepspeed_tpu_torch.telemetry.tracing import NULL_TRACER, to_ns


class ContinuousBatchingScheduler:
    def __init__(self, config: ServingConfig, blocks: BlockManager,
                 max_len: int, buckets: Optional[List[int]] = None,
                 clock=time.monotonic, prefix_cache=None, tracer=None):
        self.config = config
        self.blocks = blocks
        # optional PrefixCache: admission matches cached prompt prefixes
        # and maps their blocks in read-only instead of re-prefilling
        self.prefix = prefix_cache
        # span tracer (telemetry/tracing.py, host-only): admission emits
        # the submit->slot `queue` span and sheds emit `shed` spans into
        # the request's trace — the causal timeline the engine/router
        # continue. Inert (NULL_TRACER) unless tracing is configured.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.max_len = int(max_len)
        self.buckets = buckets if buckets is not None else resolve_buckets(
            config.prompt_buckets, self.max_len, floor=config.block_size)
        self.clock = clock
        self.queue: deque = deque()
        self.slots: List[Optional[rq.Request]] = [None] * config.decode_slots
        self.committed_tokens = 0  # worst-case prompt+max_new, queued+running
        self._live_ids = set()     # queued + running request ids
        self.stats = self._fresh_stats()

    @staticmethod
    def _fresh_stats():
        return {"submitted": 0, "admitted": 0, "finished": 0,
                "shed": 0, "shed_reasons": {}, "queue_peak": 0,
                "migrated_in": 0, "migrated_out": 0}

    def reset_stats(self):
        """Zero the counters; queue/slots/block accounting is untouched."""
        self.stats = self._fresh_stats()

    # ------------------------------------------------------------------
    @staticmethod
    def _cost(req: rq.Request) -> int:
        return req.prompt_len + req.max_new_tokens

    def _deadline_secs(self, req: rq.Request) -> float:
        ms = req.deadline_ms or self.config.deadline_ms
        return ms / 1e3 if ms > 0 else 0.0

    def expired(self, req: rq.Request, now: float) -> bool:
        dl = self._deadline_secs(req)
        return bool(dl) and (now - req.submit_ts) > dl

    def speculative_budget(self, req: rq.Request, k: int) -> int:
        """How many draft tokens a verify step may propose for ``req``:
        ``k`` capped by (a) the emit budget — a verify step always emits
        at least one non-speculative token, so only ``max_new - emitted
        - 1`` drafts can ever be kept — and (b) the model window, so the
        speculative write extent ``[length, length + n_p]`` never leaves
        the admission-reserved block coverage. Proposing past either cap
        is verify compute that can never commit."""
        remaining = req.max_new_tokens - len(req.tokens)
        window = self.max_len - req.length - 1
        return max(0, min(int(k), remaining - 1, window))

    @property
    def pending(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def running(self) -> List[Tuple[int, rq.Request]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def gauges(self) -> dict:
        """Instantaneous load gauges — the health signals the router (and
        the per-step ``serving`` telemetry events) consume, so no caller
        ever needs to reach into queue/slot internals."""
        return {
            "queue_depth": len(self.queue),
            "queue_capacity": int(self.config.max_queue_depth),
            "slots_busy": sum(1 for r in self.slots if r is not None),
            "slots_total": len(self.slots),
            "committed_tokens": self.committed_tokens,
        }

    # ------------------------------------------------------------------
    def submit(self, req: rq.Request, now: Optional[float] = None) -> bool:
        """Queue a request, or shed it (state ``shed`` + reason) when
        admission control rejects. Returns True when queued."""
        now = self.clock() if now is None else now
        req.submit_ts = now
        self.stats["submitted"] += 1
        if req.max_new_tokens <= 0:
            req.max_new_tokens = self.config.default_max_new_tokens
        reason = self._admit_sampling(req)
        if reason is not None:
            return self._shed(req, reason, now)
        if req.request_id in self._live_ids:
            # a duplicate id would collide in the block manager mid-admit
            # and crash the serving loop with every other request in
            # flight — reject it at the door instead
            return self._shed(req, "duplicate_id", now)
        if (req.prompt_len < 1
                or bucket_for(req.prompt_len, self.buckets) is None
                or self._cost(req) > self.max_len
                # a request the POOL can never hold (explicit small
                # num_blocks) must shed now: admit() defers on allocation
                # pressure, and waiting on frees that cannot suffice
                # would spin step()/drain() forever
                or self.blocks.blocks_needed(self._cost(req))
                > self.blocks.num_blocks - 1):
            return self._shed(req, "too_long", now)
        if len(self.queue) >= self.config.max_queue_depth:
            return self._shed(req, "queue_full", now)
        cap = self.config.max_inflight_tokens
        if (cap and self.config.shed_policy != QUEUE
                and self.committed_tokens + self._cost(req) > cap):
            return self._shed(req, "inflight_tokens", now)
        self.committed_tokens += self._cost(req)
        self._live_ids.add(req.request_id)
        self.queue.append(req)
        self.stats["queue_peak"] = max(self.stats["queue_peak"],
                                       len(self.queue))
        return True

    def _admit_sampling(self, req: rq.Request) -> Optional[str]:
        """Admission control for per-request sampling: resolve the
        ``serving.sampling`` defaults onto the request (so exports,
        replays and records all carry the EFFECTIVE knobs) and return a
        shed reason when the request cannot be served reproducibly —
        ``sampling_unsupported`` (no sampling block on this engine),
        ``sampling_unseeded`` (do_sample without a seed is unreplayable
        by construction — the loud shed, never a silent greedy
        downgrade), or ``sampling_invalid`` (out-of-range knobs)."""
        if not getattr(req, "do_sample", False):
            return None
        sc = getattr(self.config, "sampling", None)
        if sc is None or not sc.enabled:
            return "sampling_unsupported"
        if req.seed is None:
            return "sampling_unseeded"
        if req.temperature is None:
            req.temperature = sc.default_temperature
        if req.top_k is None:
            req.top_k = sc.default_top_k
        if req.top_p is None:
            req.top_p = sc.default_top_p
        if (req.seed < 0 or req.temperature <= 0 or req.top_k < 0
                or not 0.0 <= req.top_p <= 1.0):
            return "sampling_invalid"
        return None

    def _shed(self, req: rq.Request, reason: str,
              now: Optional[float] = None) -> bool:
        req.state = rq.SHED
        req.finish_reason = reason
        # the caller's `now` keeps one timebase per event: under a fake
        # clock a shed record must not mix injected submit/admit times
        # with real clock reads
        req.finish_ts = self.clock() if now is None else now
        self.stats["shed"] += 1
        reasons = self.stats["shed_reasons"]
        reasons[reason] = reasons.get(reason, 0) + 1
        if self.tracer.enabled and req.trace is not None:
            # terminal shed span in the request's trace (submit-time
            # sheds carry no trace context yet and are skipped — the
            # router records those on the client handle). A pre-admission
            # shed has no serve root yet: fall back to the router-stamped
            # attempt parent so the span stays attached to its subtree
            # (a parentless shed would masquerade as the trace root)
            self.tracer.record_span(
                "shed", req.trace["trace"], to_ns(req.submit_ts),
                to_ns(req.finish_ts),
                parent=req.trace.get("serve_id") or req.trace.get("parent"),
                reason=reason, request_id=req.request_id)
        return False

    # ------------------------------------------------------------------
    def admit(self, now: Optional[float] = None):
        """Splice queued requests into free decode slots. Returns
        ``(admitted, shed)``: admitted as ``(slot, request, block_table)``
        triples (the engine prefills them), shed as requests dropped at
        the queue head (deadline already blown — prefilling them would
        burn a compile-warm slot on undeliverable work)."""
        now = self.clock() if now is None else now
        admitted, shed = [], []
        cap = self.config.max_inflight_tokens
        for slot in range(len(self.slots)):
            if self.slots[slot] is not None:
                continue
            req = None
            while self.queue:
                head = self.queue.popleft()
                if self.expired(head, now):
                    self.committed_tokens -= self._cost(head)
                    self._live_ids.discard(head.request_id)
                    self._shed(head, "deadline", now)
                    shed.append(head)
                    continue
                req = head
                break
            if req is None:
                break
            if cap and self.config.shed_policy == QUEUE:
                running_tokens = sum(self._cost(r) for _, r in
                                     self.running()) + sum(
                    self._cost(r) for _, r, _ in admitted)
                if running_tokens + self._cost(req) > cap:
                    self.queue.appendleft(req)  # defer, keep FIFO order
                    break
            shared, cow_src, matched = [], None, 0
            if self.prefix is not None:
                shared, cow_src, matched = self.prefix.match(req.prompt)
            if not self.blocks.can_allocate_shared(self._cost(req), shared,
                                                   cow_src):
                self.queue.appendleft(req)  # pool backpressure: wait
                break
            table = self.blocks.allocate(req.request_id, self._cost(req),
                                         shared=shared, cow_src=cow_src)
            req.prefix_hit_tokens = matched
            req.blocks_shared = len(shared) + (1 if cow_src is not None
                                               else 0)
            req.cached_len = matched
            # the engine copies cow_src's rows into the first fresh block
            # (logical index len(shared)) before any append, then calls
            # blocks.cow_done() to unpin the source
            req.cow = ((int(cow_src), int(table[len(shared)]))
                       if cow_src is not None else None)
            req.state = rq.RUNNING
            req.slot = slot
            req.admit_ts = now
            self.slots[slot] = req
            self.stats["admitted"] += 1
            if self.tracer.enabled:
                self._trace_admit(req, now, slot)
            admitted.append((slot, req, table))
        return admitted, shed

    def _trace_admit(self, req: rq.Request, now: float, slot: int):
        """Admission is where a request's replica-side trace context is
        ESTABLISHED: reuse the router-stamped context (same trace id,
        parent = the current attempt span) or mint a fresh trace for a
        standalone submit, open the `serve` root span (ended by the
        engine at finish/shed), and emit the submit->slot `queue` leg."""
        if req.trace is None:
            req.trace = {"trace": self.tracer.new_trace(
                hint=req.request_id)}
        if "serve_id" not in req.trace:
            h = self.tracer.begin(
                "serve", req.trace["trace"], parent=req.trace.get("parent"),
                start_ns=to_ns(req.submit_ts), request_id=req.request_id,
                attempt=req.trace.get("attempt", 0))
            req.trace["serve"] = h
            req.trace["serve_id"] = h.span
        self.tracer.record_span(
            "queue", req.trace["trace"], to_ns(req.submit_ts), to_ns(now),
            parent=req.trace.get("serve_id"), slot=slot,
            request_id=req.request_id)

    # ------------------------------------------------------------------
    def cancel(self, request_id: str, reason: str = "cancelled",
               now: Optional[float] = None) -> Optional[rq.Request]:
        """Abandon one in-flight request (queued or mid-decode), releasing
        its slot, blocks and token budget immediately; the request is
        marked shed with ``reason``. Returns it, or ``None`` when no live
        request carries the id. The multi-replica router uses this at
        failover so an abandoned proxy never haunts a replica that later
        recovers through a half-open probe."""
        now = self.clock() if now is None else now
        for i, r in enumerate(self.queue):
            if r.request_id == request_id:
                del self.queue[i]
                self.committed_tokens -= self._cost(r)
                self._live_ids.discard(request_id)
                self._shed(r, reason, now)
                return r
        for slot, r in self.running():
            if r.request_id == request_id:
                self.slots[slot] = None
                self.blocks.release(request_id)
                self.committed_tokens -= self._cost(r)
                self._live_ids.discard(request_id)
                self._shed(r, reason, now)
                return r
        return None

    # ------------------------------------------------------------------
    # live KV-block migration seams (serving/migration.py)
    def free_slot(self) -> Optional[int]:
        """Lowest free decode slot index, or None when all are busy —
        the import-side capacity probe (a migrated-in request bypasses
        the queue: it is already mid-decode, so it needs a slot NOW or
        the migration does not happen)."""
        for slot, r in enumerate(self.slots):
            if r is None:
                return slot
        return None

    def splice(self, req: rq.Request, slot: int,
               now: Optional[float] = None):
        """Register a migrated-in request directly into a free decode
        slot, mid-stream: no queue pass, no prefill — its KV blocks were
        already scattered into the pool and its table allocated by the
        engine's import path. Mirrors admission's accounting (committed
        tokens, live ids) so finish/cancel/migrate-out release exactly
        what admission-or-splice reserved."""
        now = self.clock() if now is None else now
        if self.slots[slot] is not None:
            raise ValueError(f"splice into busy slot {slot}")
        if req.request_id in self._live_ids:
            raise ValueError(f"splice of live id {req.request_id!r}")
        if req.max_new_tokens <= 0:
            req.max_new_tokens = self.config.default_max_new_tokens
        self.committed_tokens += self._cost(req)
        self._live_ids.add(req.request_id)
        req.state = rq.RUNNING
        req.slot = slot
        req.admit_ts = now
        self.slots[slot] = req
        self.stats["migrated_in"] += 1
        if self.tracer.enabled:
            # continue the request's ONE trace on this replica: a fresh
            # `serve` root under the router-stamped parent (the queue leg
            # is skipped — a spliced request never queued here)
            if req.trace is None:
                req.trace = {"trace": self.tracer.new_trace(
                    hint=req.request_id)}
            if "serve_id" not in req.trace:
                h = self.tracer.begin(
                    "serve", req.trace["trace"],
                    parent=req.trace.get("parent"), start_ns=to_ns(now),
                    request_id=req.request_id,
                    attempt=req.trace.get("attempt", 0))
                req.trace["serve"] = h
                req.trace["serve_id"] = h.span

    def migrate_out(self, request_id: str,
                    now: Optional[float] = None) -> Optional[rq.Request]:
        """Release a RUNNING request's slot + blocks + token budget after
        its state committed on a migration target. NOT a shed (no shed
        stats, no shed span — the request lives on, elsewhere) and not a
        finish: the terminal state here is ``shed``/``migrated`` purely
        so the abandoned source proxy reads as done to anything still
        holding it. Returns the request, or None when the id is not
        running here (queued requests migrate by plain resubmit)."""
        now = self.clock() if now is None else now
        for slot, r in self.running():
            if r.request_id == request_id:
                self.slots[slot] = None
                self.blocks.release(request_id)
                self.committed_tokens -= self._cost(r)
                self._live_ids.discard(request_id)
                r.state = rq.SHED
                r.finish_reason = "migrated"
                r.finish_ts = now
                self.stats["migrated_out"] += 1
                return r
        return None

    def finish(self, req: rq.Request, reason: str,
               now: Optional[float] = None):
        """Release a running request's slot + blocks + token budget."""
        now = self.clock() if now is None else now
        if req.slot >= 0 and self.slots[req.slot] is req:
            self.slots[req.slot] = None
        self.blocks.release(req.request_id)
        self.committed_tokens -= self._cost(req)
        self._live_ids.discard(req.request_id)
        req.state = rq.FINISHED
        req.finish_reason = reason
        req.finish_ts = now
        self.stats["finished"] += 1
