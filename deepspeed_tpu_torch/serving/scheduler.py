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
- ``finish`` returns capacity (slot, blocks, token budget) immediately.

The JAX scheduler's cancel, load gauges, migration seams and span
tracing come with later slices of the port.
"""

import time
from collections import deque
from typing import List, Optional, Tuple

from deepspeed_tpu_torch.serving import request as rq
from deepspeed_tpu_torch.serving.blocks import BlockManager
from deepspeed_tpu_torch.serving.config import (QUEUE, ServingConfig,
                                                bucket_for, resolve_buckets)


class ContinuousBatchingScheduler:
    def __init__(self, config: ServingConfig, blocks: BlockManager,
                 max_len: int, buckets: Optional[List[int]] = None,
                 clock=time.monotonic, prefix_cache=None):
        self.config = config
        self.blocks = blocks
        # optional PrefixCache: admission matches cached prompt prefixes
        # and maps their blocks in read-only instead of re-prefilling
        self.prefix = prefix_cache
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
                "shed": 0, "shed_reasons": {}, "queue_peak": 0}

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
        the admission-reserved block coverage."""
        remaining = req.max_new_tokens - len(req.tokens)
        window = self.max_len - req.length - 1
        return max(0, min(int(k), remaining - 1, window))

    @property
    def pending(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def running(self) -> List[Tuple[int, rq.Request]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

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
            return self._shed(req, "duplicate_id", now)
        if (req.prompt_len < 1
                or bucket_for(req.prompt_len, self.buckets) is None
                or self._cost(req) > self.max_len
                # a request the POOL can never hold must shed now: admit()
                # defers on allocation pressure and would wait forever
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
        ``serving.sampling`` defaults onto the request (so its record
        carries the knobs it runs with) and return a shed reason when it
        cannot be served reproducibly: ``sampling_unsupported`` (no
        sampling block on this engine), ``sampling_unseeded`` (do_sample
        without a seed is not replayable: shed, never quietly greedy) or
        ``sampling_invalid`` (knobs out of range)."""
        if not req.do_sample:
            return None
        sc = self.config.sampling
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
        req.finish_ts = self.clock() if now is None else now
        self.stats["shed"] += 1
        reasons = self.stats["shed_reasons"]
        reasons[reason] = reasons.get(reason, 0) + 1
        return False

    # ------------------------------------------------------------------
    def admit(self, now: Optional[float] = None):
        """Splice queued requests into free decode slots. Returns
        ``(admitted, shed)``: admitted as ``(slot, request, block_table)``
        triples (the engine prefills them), shed as requests dropped at
        the queue head (deadline already blown)."""
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
            admitted.append((slot, req, table))
        return admitted, shed

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
