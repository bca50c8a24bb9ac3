"""Resilient multi-replica front door: health-aware routing, failover
with deterministic replay, and an SLO-guarded degradation ladder (copy
of ``deepspeed_tpu/serving/router.py``).

Pure host-side policy (no torch imports — the CPU tests drive it with
fake replicas in milliseconds). A *replica* is anything with the
``ServingEngine`` surface: ``submit(prompt, max_new_tokens, request_id,
eos_token_id, deadline_ms, stream)`` returning a live ``Request``,
``step()``, ``gauges()`` and ``stats()``. The router composes N of them
behind one ``submit()``/``step()``/``drain()`` surface:

- **routing** — each submit goes to the least-loaded routable replica
  (load = ``queue_depth + slots_busy`` from the public ``gauges()``
  payload, the same numbers the per-step serving telemetry events
  carry): HEALTHY replicas first, DEGRADED only when no HEALTHY peer
  can take it, plus at most one half-open probe to a TRIPPED replica
  whose backoff elapsed.
- **failover with deterministic replay** — greedy decode is
  reproducible (replicas of one config have the same slot and bucket
  shapes, so a request's tokens do not depend on its batch mix), so when a
  replica dies or its breaker trips the router resubmits every one of
  its in-flight requests — full prompt, the ORIGINAL effective
  ``max_new_tokens`` — to a survivor and dedupes the regenerated stream
  by position: tokens the client already saw are swallowed (and checked
  — a mismatch is a loud ``replay.divergence`` event, the greedy
  contract broken), new positions stream exactly once. The client sees
  one uninterrupted exactly-once token stream, not a restart.
- **degradation ladder** — under aggregate overload (queue depth over
  capacity across routable replicas) the router walks explicit tiers
  instead of collapsing into timeout storms: full service -> clamp
  ``max_new_tokens`` -> shed below-priority-floor work -> brownout
  (smallest-bucket prompts only). Tier entry is immediate; exit needs
  the score below the (lower) exit threshold for ``ladder_dwell_steps``
  — the hysteresis guard.

Every transition — replica state, breaker trip/probe/close, failover,
tier — is a ``router`` telemetry event through the ``telemetry=`` object
the caller passes.

One process steps its replicas in turn: on one card two replicas do
not double the decode rate. A replica under tensor parallelism is one
process a rank: it joins the router through its group's proxy
(``serving/group_replica.py``: the router's rank drives the group's
ranks, which run each call in lockstep); a bare tp engine handed to the
router is refused (stepping one rank's shard alone would hang its
group's collectives).
"""

import dataclasses
import itertools
import math
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Set

from deepspeed_tpu_torch.serving import request as rq
from deepspeed_tpu_torch.serving.autoscaler import (SCALE_DOWN, SCALE_UP,
                                              Autoscaler, Decision)
from deepspeed_tpu_torch.serving.config import FleetConfig, RouterConfig
from deepspeed_tpu_torch.serving.health import (DEAD, DEGRADED, DRAINING, HEALTHY,
                                          STATES, TRIPPED, ReplicaHealth)
from deepspeed_tpu_torch.serving.migration import Migrator, resolve_migration
from deepspeed_tpu_torch.telemetry.registry import NULL_REGISTRY
from deepspeed_tpu_torch.telemetry.tracing import (NULL_TRACER, end_span, span_id,
                                             to_ns, trace_ctx)

_ids = itertools.count()


def _one_process(replica):
    """Refuse a bare tensor-parallel engine: the router steps its
    replicas from one rank, and a tp engine is one process a rank, so
    stepping this rank's shard alone would hang its group."""
    tp = getattr(getattr(replica, "engine", None), "mp_world_size", 1)
    if tp > 1:
        raise ValueError(
            f"a bare ServingEngine at tensor_parallel.tp_size {tp} behind "
            f"the router: the router steps its replicas from one rank and "
            f"a tp engine is one process a rank; wrap the group in a "
            f"GroupReplica proxy (deepspeed_tpu_torch.serving."
            f"group_replica, init_serving(replicas=...) builds them)")
    return replica


@dataclasses.dataclass
class RouterRequest:
    """The client's handle: mirrors ``Request`` (state / tokens / stream)
    but survives its replica. ``tokens`` holds exactly the tokens the
    client's stream callback saw, in order — across any number of
    failovers, each position exactly once."""

    prompt: List[int]
    max_new_tokens: int = 0       # effective budget, pinned at first dispatch
    request_id: str = ""
    priority: int = 0             # ladder tier 2+ sheds below the floor
    eos_token_id: int = -1
    deadline_ms: float = 0.0
    stream: Optional[Callable] = None
    # ---- keyed sampling: replayable state. A seeded sampled request's
    # tokens are a pure function of (seed, position, logits), so the
    # dedupe-splice exactly-once contract extends to it unchanged —
    # failover replays regenerate the delivered prefix bit-identically.
    do_sample: bool = False
    seed: Optional[int] = None
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None

    # ---- runtime state (owned by the router) ----
    clamp_budget: int = 0         # tier-1 cap pending default resolution
    state: str = rq.QUEUED
    finish_reason: Optional[str] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    replica: int = -1             # current assignment
    attempt: int = 0              # failovers so far
    proxy: Optional[rq.Request] = None
    submit_ts: float = 0.0
    first_token_ts: float = 0.0
    finish_ts: float = 0.0
    # ---- span tracing (telemetry/tracing.py; None with tracing off) ----
    trace_id: Optional[str] = None     # ONE trace across every failover
    root_span: Optional[object] = None     # open `request` root handle
    attempt_span: Optional[object] = None  # open `attempt` subtree handle
    attempt_start_pos: int = 0    # first NEW position this attempt streams
    # first/last delivery time this attempt (None = nothing delivered
    # yet: a fake clock's legitimate t=0.0 must not read as unset)
    deliver_t0: Optional[float] = None
    deliver_t1: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return self.state in (rq.FINISHED, rq.SHED)

    @property
    def keyed(self) -> bool:
        """Seeded sampled request — bit-exactly replayable anywhere."""
        return self.do_sample and self.seed is not None

    def record(self) -> dict:
        return {
            "request_id": self.request_id, "state": self.state,
            "reason": self.finish_reason, "prompt_len": self.prompt_len,
            "do_sample": bool(self.do_sample),
            "new_tokens": len(self.tokens), "failovers": self.attempt,
            "ttft_ms": round(1e3 * (self.first_token_ts - self.submit_ts), 3)
            if self.first_token_ts else None,
        }


def _pct(values, q: float):
    if not values:
        return None
    vs = sorted(values)
    k = min(len(vs) - 1, max(0, math.ceil(q / 100.0 * len(vs)) - 1))
    return round(float(vs[k]), 3)


class _NullTelemetry:
    enabled = False

    def emit(self, *a, **k):
        pass


class ReplicaRouter:
    def __init__(self, replicas, config=None, clock=time.monotonic,
                 telemetry=None, migration=None):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        self.replicas = [_one_process(r) for r in replicas]
        if config is None:
            config = RouterConfig()
        elif isinstance(config, dict):
            config = RouterConfig(**config)
        self.config: RouterConfig = config
        self.clock = clock
        self.telemetry = (telemetry
                          or getattr(self.replicas[0], "telemetry", None)
                          or _NullTelemetry())
        # span tracer: client-side request traces (root + per-dispatch
        # attempt subtrees + exactly-once deliver spans). A failover
        # continues the SAME trace on the survivor — the replicas join
        # it through the context stamped on their proxy requests.
        self._tracer = (getattr(self.telemetry, "tracer", None)
                        or NULL_TRACER)
        # live KV migration (serving.migration): move a failed/draining
        # replica's in-flight state to a survivor instead of replaying
        # it. None (the default) = migration does not exist — failover
        # replays, drains wait, behavior byte-for-byte pre-migration.
        self.migration = resolve_migration(migration)
        self._migrator = (Migrator(
            self.migration, tracer=self._tracer,
            metrics=getattr(self.telemetry, "metrics", None), clock=clock)
            if self.migration is not None and self.migration.enabled
            else None)
        self.health = [ReplicaHealth(config, i, clock, emit=self._emit)
                       for i in range(len(self.replicas))]
        self.tier = 0
        self._tier_changed_step = 0
        self._step_count = 0
        self.requests: Dict[str, RouterRequest] = {}   # live client requests
        self._assigned: List[Set[str]] = [set() for _ in self.replicas]
        self._probe_req: Dict[int, str] = {}           # replica -> request id
        self._done_this_step: List[RouterRequest] = []
        self.finished = deque(maxlen=1024)
        self._counters = {"submitted": 0, "finished": 0, "shed": 0,
                          "failovers": 0, "migrations": 0,
                          "deduped_tokens": 0,
                          "replay_divergence": 0, "tier_transitions": 0,
                          "shed_reasons": {}}

    # ------------------------------------------------------------------
    def _emit(self, name: str, **data):
        self.telemetry.emit("router", name, step=self._step_count, **data)

    def _gauges(self, idx: int) -> dict:
        try:
            return self.replicas[idx].gauges()
        except Exception:
            return {}

    def _load(self, idx: int) -> int:
        g = self._gauges(idx)
        return int(g.get("queue_depth", 0)) + int(g.get("slots_busy", 0))

    def _sampling(self, idx: int) -> bool:
        return bool(getattr(getattr(self.replicas[idx], "config", None),
                            "do_sample", False))

    def _smallest_bucket(self) -> Optional[int]:
        sizes = [min(b) for r in self.replicas
                 for b in [getattr(r, "buckets", None)] if b]
        return min(sizes) if sizes else None

    # ------------------------------------------------------------------
    # routing
    def _candidates(self, now: float, exclude=()) -> List[int]:
        """Routable replicas in preference order — HEALTHY by load, then
        DEGRADED by load, then TRIPPED replicas whose half-open probe
        window is open (each takes exactly one request)."""
        healthy, degraded, probes = [], [], []
        for i, h in enumerate(self.health):
            if i in exclude:
                continue
            if h.state == HEALTHY:
                healthy.append(i)
            elif h.state == DEGRADED:
                degraded.append(i)
            elif h.can_probe(now) and i not in self._probe_req:
                probes.append(i)
        return (sorted(healthy, key=self._load)
                + sorted(degraded, key=self._load) + sorted(probes))

    def submit(self, prompt, max_new_tokens: int = 0, priority: int = 0,
               request_id: Optional[str] = None, eos_token_id: int = -1,
               deadline_ms: float = 0.0,
               stream: Optional[Callable] = None, do_sample: bool = False,
               seed: Optional[int] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None) -> RouterRequest:
        """Route one request to a replica (non-blocking). The returned
        handle's ``state`` is ``queued`` on success, or ``shed`` with a
        ``finish_reason`` when the degradation ladder or every routable
        replica rejected it."""
        now = self.clock()
        rreq = RouterRequest(
            prompt=[int(t) for t in prompt],
            max_new_tokens=int(max_new_tokens),
            request_id=request_id or f"rr-{next(_ids)}",
            priority=int(priority), eos_token_id=int(eos_token_id),
            deadline_ms=float(deadline_ms), stream=stream,
            do_sample=bool(do_sample),
            seed=int(seed) if seed is not None else None,
            temperature=float(temperature) if temperature is not None
            else None,
            top_k=int(top_k) if top_k is not None else None,
            top_p=float(top_p) if top_p is not None else None)
        rreq.submit_ts = now
        self._counters["submitted"] += 1
        if self._tracer.enabled:
            rreq.trace_id = self._tracer.new_trace(hint=rreq.request_id)
            rreq.root_span = self._tracer.begin(
                "request", rreq.trace_id, start_ns=to_ns(now),
                request_id=rreq.request_id, prompt_len=rreq.prompt_len)
        if rreq.request_id in self.requests:
            return self._shed(rreq, "duplicate_id")
        # ---- degradation ladder admission ----
        c = self.config
        if self.tier >= 1:
            if rreq.max_new_tokens > 0:
                rreq.max_new_tokens = min(rreq.max_new_tokens,
                                          c.clamp_max_new_tokens)
            else:
                # budget comes from the replica default — cap it at
                # dispatch, once known: the clamp must never RAISE the
                # decode work of a default-budget submit
                rreq.clamp_budget = c.clamp_max_new_tokens
        if self.tier >= 2 and rreq.priority < c.shed_priority_floor:
            return self._shed(rreq, "tier_shed")
        if self.tier >= 3:
            floor = self._smallest_bucket()
            if floor is not None and rreq.prompt_len > floor:
                return self._shed(rreq, "brownout")
        if self._dispatch(rreq, now):
            self.requests[rreq.request_id] = rreq
        return rreq

    def _dispatch(self, rreq: RouterRequest, now: float,
                  exclude=()) -> bool:
        """Try candidates in preference order until one accepts; shed the
        request (last replica-side reason, or ``no_replica``) when none
        does. The effective ``max_new_tokens`` was pinned at first
        dispatch, so a failover replays the exact same decode."""
        last_reason = None
        deadline_ms = rreq.deadline_ms
        if deadline_ms:
            # the client's deadline does not restart on failover: the
            # survivor's scheduler stamps a fresh submit_ts, so hand it
            # only the REMAINING budget — and shed already-over-deadline
            # work instead of replaying it arbitrarily late
            deadline_ms -= 1e3 * (now - rreq.submit_ts)
            if deadline_ms <= 0:
                self._shed(rreq, "deadline")
                return False
        for idx in self._candidates(now, exclude):
            h = self.health[idx]
            probe = h.state == TRIPPED
            if rreq.tokens and self._sampling(idx) and not rreq.keyed:
                # the dedupe-splice is only sound across bit-reproducible
                # decodes: a delivered prefix must never resume on an
                # UNSEEDED-sampling replica (a request with nothing
                # streamed yet is fine — there is nothing to splice). A
                # KEYED request regenerates its prefix bit-identically
                # from (seed, position), so it splices like greedy.
                last_reason = "nondeterministic_replay"
                continue
            budget = rreq.max_new_tokens
            if budget <= 0 and rreq.clamp_budget:
                # resolve the replica's default budget and cap it (real
                # engines expose it on .config; without one, the cap
                # itself is the degraded-mode budget)
                default = getattr(getattr(self.replicas[idx], "config",
                                          None),
                                  "default_max_new_tokens", 0) or 0
                budget = (min(int(default), rreq.clamp_budget)
                          if default > 0 else rreq.clamp_budget)
            # sampling kwargs ride only on sampled requests so legacy
            # replica doubles (narrow submit signatures) keep working
            samp_kw = ({"do_sample": True, "seed": rreq.seed,
                        "temperature": rreq.temperature,
                        "top_k": rreq.top_k, "top_p": rreq.top_p}
                       if rreq.do_sample else {})
            try:
                proxy = self.replicas[idx].submit(
                    rreq.prompt, max_new_tokens=budget,
                    request_id=f"{rreq.request_id}#a{rreq.attempt}",
                    eos_token_id=rreq.eos_token_id,
                    deadline_ms=deadline_ms, stream=self._shim(rreq),
                    **samp_kw)
            except Exception as e:
                if probe:
                    # the half-open probe itself failed: it must count
                    # as one (re-trip, backoff doubles) — not as a
                    # first consecutive failure that leaves the probe
                    # window open for immediate hammering
                    h.begin_probe()
                self._replica_failed(
                    idx, f"submit:{type(e).__name__}",
                    fatal=bool(getattr(e, "replica_dead", False)))
                continue
            if proxy.state == rq.SHED:
                last_reason = proxy.finish_reason  # admission said no; next
                continue
            if probe:
                h.begin_probe()
                self._probe_req[idx] = rreq.request_id
            if rreq.max_new_tokens <= 0:
                # pin the effective budget only from an admission that
                # ACCEPTED — the clamp-resolved cap, or the default this
                # replica's proxy reports; a failed candidate's config
                # must not leak into the replay budget
                rreq.max_new_tokens = int(
                    budget or getattr(proxy, "max_new_tokens", 0) or 0)
            rreq.proxy, rreq.replica, rreq.state = proxy, idx, rq.QUEUED
            self._assigned[idx].add(rreq.request_id)
            if self._tracer.enabled:
                # one `attempt` subtree per dispatch; the proxy carries
                # the context so the replica's serve/queue/prefill/
                # decode spans nest under it — ONE trace end to end,
                # failovers included
                rreq.attempt_span = self._tracer.begin(
                    "attempt", rreq.trace_id, parent=span_id(rreq.root_span),
                    start_ns=to_ns(now), attempt=rreq.attempt, replica=idx)
                rreq.attempt_start_pos = len(rreq.tokens)
                rreq.deliver_t0 = rreq.deliver_t1 = None
                proxy.trace = trace_ctx(rreq.trace_id,
                                        parent=span_id(rreq.attempt_span),
                                        attempt=rreq.attempt)
            return True
        self._shed(rreq, last_reason or "no_replica")
        return False

    def _shim(self, rreq: RouterRequest) -> Callable:
        """Per-token dedupe-by-position: the exactly-once guarantee. A
        replayed position must carry the identical token (greedy decode
        is bit-reproducible) — a mismatch is counted and shouted, never
        silently re-streamed."""

        def cb(proxy: rq.Request, tok: int, done: bool):
            if rreq.proxy is not proxy:
                # stale attempt: the request moved on (failed over, or
                # already reported done) — a zombie proxy left decoding
                # on a recovered replica must never resurrect the handle
                # or re-invoke the client stream
                return
            pos = len(proxy.tokens) - 1
            tok = int(tok)
            if pos < len(rreq.tokens):
                self._counters["deduped_tokens"] += 1
                if rreq.tokens[pos] != tok:
                    self._counters["replay_divergence"] += 1
                    self._emit("replay.divergence",
                               request_id=rreq.request_id, position=pos,
                               streamed=rreq.tokens[pos], replayed=tok)
                return
            now = self.clock()
            if not rreq.tokens:
                rreq.first_token_ts = now
            if rreq.deliver_t0 is None:
                rreq.deliver_t0 = now
            rreq.deliver_t1 = now
            rreq.state = rq.RUNNING
            rreq.tokens.append(tok)
            if rreq.stream is not None:
                rreq.stream(rreq, tok, bool(done))

        return cb

    # ------------------------------------------------------------------
    # stepping + health
    def step(self) -> List[RouterRequest]:
        """One router iteration: step every replica that holds work
        (guarded — an exception or stall verdict becomes a health signal
        and a failover), harvest finished/shed proxies, refresh soft
        health from telemetry aggregates, walk the degradation ladder.
        Returns the client requests finished this step."""
        self._step_count += 1
        self._done_this_step = []
        c = self.config
        for idx in range(len(self.replicas)):
            if not self._assigned[idx] or not self.health[idx].alive:
                continue
            t0 = self.clock()
            try:
                self.replicas[idx].step()
            except Exception as e:
                self._replica_failed(
                    idx, f"step:{type(e).__name__}",
                    fatal=bool(getattr(e, "replica_dead", False)))
                continue
            # harvest BEFORE the stall verdict: a slow-but-complete step
            # delivered tokens — requests it finished must not be
            # replayed (or worse, shed) by the failover below
            self._harvest(idx)
            if (c.stall_timeout_secs
                    and self.clock() - t0 >= c.stall_timeout_secs):
                h = self.health[idx]
                h.record_stall("stall")
                self._probe_req.pop(idx, None)
                # DRAINING holds the drain-in-place contract even on a
                # stall verdict (trip() already no-ops there) — mirror
                # the exception path's guard in _replica_failed
                if not h.routable and h.state != DRAINING:
                    self._failover_replica(idx, "stall")
            else:
                self.health[idx].record_success()
        self._observe_health()
        self._evaluate_ladder()
        # snapshot: a later submit-time shed appends to the live list
        # and must not retroactively grow the caller's result
        return list(self._done_this_step)

    def _harvest(self, idx: int):
        for rid in list(self._assigned[idx]):
            rreq = self.requests.get(rid)
            if rreq is None or rreq.proxy is None:
                self._assigned[idx].discard(rid)
                continue
            st = rreq.proxy.state
            if st == rq.FINISHED:
                self._assigned[idx].discard(rid)
                if self._probe_req.get(idx) == rid:
                    del self._probe_req[idx]
                    self.health[idx].probe_success()
                self._finalize(rreq, rreq.proxy.finish_reason)
            elif st == rq.SHED:
                # replica-side policy shed (deadline/queue) — propagate,
                # no failover: resubmitting over-deadline work would feed
                # the very overload the shed relieved
                self._assigned[idx].discard(rid)
                if self._probe_req.get(idx) == rid:
                    del self._probe_req[idx]
                    self.health[idx].probe_inconclusive()
                self._shed(rreq, rreq.proxy.finish_reason or "replica_shed")
        h = self.health[idx]
        if h.state == DRAINING and not self._assigned[idx]:
            self._emit("replica.drained", replica=idx)

    def _close_attempt(self, rreq: RouterRequest, outcome: str):
        """End the open ``attempt`` subtree: a ``deliver`` child records
        exactly the NEW positions this attempt streamed to the client
        (replayed/deduped positions are an attrs counter, never a second
        deliver span — the exactly-once contract, visible in the trace),
        then the attempt span closes with its outcome."""
        if rreq.attempt_span is None:
            return
        now = self.clock()
        delivered = len(rreq.tokens) - rreq.attempt_start_pos
        if delivered > 0:
            t0 = now if rreq.deliver_t0 is None else rreq.deliver_t0
            t1 = now if rreq.deliver_t1 is None else rreq.deliver_t1
            self._tracer.record_span(
                "deliver", rreq.trace_id, to_ns(t0), to_ns(t1),
                parent=span_id(rreq.attempt_span),
                from_pos=rreq.attempt_start_pos, to_pos=len(rreq.tokens),
                tokens=delivered)
        end_span(rreq.attempt_span, end_ns=to_ns(now), outcome=outcome,
                 delivered=delivered)
        rreq.attempt_span = None

    def _close_root(self, rreq: RouterRequest):
        end_span(rreq.root_span, end_ns=to_ns(rreq.finish_ts),
                 state=rreq.state, reason=rreq.finish_reason,
                 failovers=rreq.attempt, tokens=len(rreq.tokens))
        rreq.root_span = None

    def _finalize(self, rreq: RouterRequest, reason: Optional[str]):
        rreq.state, rreq.finish_reason = rq.FINISHED, reason
        rreq.finish_ts = self.clock()
        rreq.proxy = None
        self._close_attempt(rreq, "finished")
        self._close_root(rreq)
        self.requests.pop(rreq.request_id, None)
        self.finished.append(rreq)
        self._counters["finished"] += 1
        self._done_this_step.append(rreq)
        self._emit("request.finish", request_id=rreq.request_id,
                   replica=rreq.replica, failovers=rreq.attempt,
                   new_tokens=len(rreq.tokens), reason=reason)

    def _shed(self, rreq: RouterRequest, reason: str) -> RouterRequest:
        rreq.state, rreq.finish_reason = rq.SHED, reason
        rreq.finish_ts = self.clock()
        rreq.proxy = None
        self._close_attempt(rreq, f"shed:{reason}")
        self._close_root(rreq)
        # identity check: shedding a duplicate-id submit must not evict
        # the live original that owns the slot in the registry
        if self.requests.get(rreq.request_id) is rreq:
            del self.requests[rreq.request_id]
        self.finished.append(rreq)
        self._counters["shed"] += 1
        reasons = self._counters["shed_reasons"]
        reasons[reason] = reasons.get(reason, 0) + 1
        self._done_this_step.append(rreq)
        self._emit("request.shed", request_id=rreq.request_id,
                   reason=reason, tier=self.tier)
        return rreq

    # ------------------------------------------------------------------
    def cancel(self, request_id: str, reason: str = "cancelled") -> bool:
        """Client-side cancel of one live request (the gateway's
        disconnect / slow-reader seam): cancels the replica-side proxy
        through the engine's ``cancel()`` so the decode slot and its KV
        blocks free immediately, then sheds the client handle. Returns
        False when the id is unknown or already terminal."""
        rreq = self.requests.get(request_id)
        if rreq is None or rreq.done:
            return False
        if rreq.proxy is not None and 0 <= rreq.replica < len(self.replicas):
            replica_cancel = getattr(self.replicas[rreq.replica],
                                     "cancel", None)
            if replica_cancel is not None:
                replica_cancel(rreq.proxy.request_id, reason)
            self._assigned[rreq.replica].discard(request_id)
        self._shed(rreq, reason)
        return True

    # ------------------------------------------------------------------
    # failure handling + failover
    def _replica_failed(self, idx: int, reason: str, fatal: bool):
        h = self.health[idx]
        if fatal:
            h.record_crash(reason)
        else:
            h.record_failure(reason)
        if idx in self._probe_req and not h.probing:
            # the probe request was in flight when the failure landed;
            # it fails over (or dies) with the rest of the assignment
            del self._probe_req[idx]
        if not h.routable and h.state != DRAINING:
            self._failover_replica(idx, reason)
        elif (h.state == DRAINING and h.consecutive_failures
              >= self.config.failure_threshold):
            # a draining replica that can no longer step must yield its
            # in-flight work: drain-in-place defers to liveness, or
            # drain() would spin on requests that can never finish
            self._failover_replica(idx, f"drain:{reason}")
        release = getattr(self.replicas[idx], "release", None)
        if h.state == DEAD and release is not None:
            # a rank-group replica's ranks go idle (group_replica.py)
            release()

    def _failover_replica(self, idx: int, reason: str):
        """Reroute everything in flight on a tripped/dead replica. With
        migration on and the source pool still readable (TRIPPED/stalled
        /DRAINING — anything short of a hard crash) each sequence's
        committed KV MOVES to a survivor and decoding resumes mid-stream
        with zero prefill dispatches; otherwise deterministic replay
        makes the reroute transparent: the survivor regenerates the
        greedy stream from the full prompt and the shim dedupes
        already-delivered positions."""
        rids = sorted(self._assigned[idx])
        self._assigned[idx].clear()
        self._probe_req.pop(idx, None)
        cancel = getattr(self.replicas[idx], "cancel", None)
        now = self.clock()
        consumer = "drain" if reason.startswith("drain") else "failover"
        for rid in rids:
            rreq = self.requests.get(rid)
            if rreq is None:
                continue
            # migrate-first: a hard crash (DEAD — pool unreadable) keeps
            # the replay path; anything else moves the state instead of
            # redoing the work
            mig = "off"
            if self.health[idx].state != DEAD:
                mig = self._migrate_request(rreq, idx, now, reason,
                                            consumer=consumer)
            if mig == "ok":
                continue
            if rreq.proxy is not None and cancel is not None:
                # best-effort: release the abandoned proxy's decode slot
                # and KV blocks so a replica that later recovers through
                # a half-open probe is not haunted by zombie decodes
                try:
                    cancel(rreq.proxy.request_id, "failover")
                except Exception:
                    pass
            self._close_attempt(rreq, f"failover:{reason}")
            rreq.attempt += 1
            self._counters["failovers"] += 1
            self._emit("failover", request_id=rid, from_replica=idx,
                       reason=reason, attempt=rreq.attempt,
                       delivered=len(rreq.tokens))
            if rreq.attempt > self.config.max_failovers:
                self._shed(rreq, "replica_lost")
                continue
            if rreq.tokens and self._sampling(idx) and not rreq.keyed:
                # the delivered prefix was UNSEEDED-sampled — no survivor
                # can regenerate it bit-identically, so the replay-splice
                # contract is unsatisfiable. With migration available
                # the KV (and the sampling counters) would have MOVED;
                # reaching here means the move was attempted and failed
                # (`migration_failed` — a fault) or was never possible
                # (`nondeterministic_replay` — policy): dashboards must
                # tell the two apart, so shed loudly with the reason
                # split instead of streaming a garbled continuation. A
                # KEYED prefix is regenerable from (seed, position) by
                # any survivor, so it falls through to replay below.
                self._shed(rreq, "migration_failed" if mig == "failed"
                           else "nondeterministic_replay")
                continue
            self._dispatch(rreq, now, exclude={idx})

    def _migrate_request(self, rreq: RouterRequest, src_idx: int,
                         now: float, reason: str,
                         consumer: str = "failover") -> str:
        """Try to MOVE one in-flight request's committed KV off
        ``src_idx`` onto the best candidate replica. Returns ``"ok"``
        (target committed; proxy/assignment/attempt subtree swapped),
        ``"off"`` (migration disabled for ``consumer``, or structurally
        impossible — no export/import surface, queued-only work, no
        candidate), or ``"failed"`` (attempted, fell through — the
        caller replays)."""
        mig = self._migrator
        if (mig is None or not mig.allows(consumer)
                or rreq.proxy is None
                or not hasattr(self.replicas[src_idx], "export_sequence")):
            return "off"
        deadline_ms = None
        if rreq.deadline_ms:
            # same contract as dispatch: the client's deadline does not
            # restart on a move — hand the target the REMAINING budget
            deadline_ms = rreq.deadline_ms - 1e3 * (now - rreq.submit_ts)
            if deadline_ms <= 0:
                return "off"  # the deadline sweep/shed path owns this
        tgt = next((i for i in self._candidates(now, exclude={src_idx})
                    if hasattr(self.replicas[i], "import_sequence")
                    and self._sampling(i) == self._sampling(src_idx)),
                   None)
        if tgt is None:
            return "off"
        new_span = ictx = None
        if self._tracer.enabled:
            new_span = self._tracer.begin(
                "attempt", rreq.trace_id, parent=span_id(rreq.root_span),
                start_ns=to_ns(now), attempt=rreq.attempt + 1,
                replica=tgt, migrated=True)
            ictx = trace_ctx(rreq.trace_id, parent=span_id(new_span),
                             attempt=rreq.attempt + 1)
        info = mig.migrate(
            self.replicas[src_idx], self.replicas[tgt],
            rreq.proxy.request_id,
            import_id=f"{rreq.request_id}#a{rreq.attempt + 1}",
            deadline_ms=deadline_ms, stream=self._shim(rreq),
            trace=rreq.trace_id, parent=span_id(rreq.root_span),
            import_trace=ictx, src=src_idx, dst=tgt, reason=reason)
        if info is None:
            end_span(new_span, end_ns=to_ns(self.clock()),
                     outcome="migrate_failed")
            return "failed"
        self._assigned[src_idx].discard(rreq.request_id)
        if self._probe_req.get(src_idx) == rreq.request_id:
            del self._probe_req[src_idx]
        self._close_attempt(rreq, f"migrate:{reason}")
        rreq.attempt += 1
        rreq.proxy, rreq.replica = info["request"], tgt
        rreq.state = rq.RUNNING if rreq.tokens else rq.QUEUED
        self._assigned[tgt].add(rreq.request_id)
        rreq.attempt_span = new_span
        rreq.attempt_start_pos = len(rreq.tokens)
        rreq.deliver_t0 = rreq.deliver_t1 = None
        self._counters["migrations"] += 1
        self._emit("migrate", request_id=rreq.request_id,
                   from_replica=src_idx, to_replica=tgt, reason=reason,
                   attempt=rreq.attempt, blocks=info["blocks"],
                   wire_bytes=info["wire_bytes"],
                   delivered=len(rreq.tokens))
        return "ok"

    def migrate_work(self, idx: int, reason: str = "drain",
                     consumer: str = "drain", limit: int = 0) -> int:
        """Migrate replica ``idx``'s in-flight work to survivors (the
        fleet manager's drain-via-migration and rebalance entry point).
        Returns how many requests moved; work that cannot move stays
        put — the caller's fallback (drain timeout, yield) still owns
        it. ``limit`` bounds one sweep (0 = everything)."""
        if self._migrator is None or not self._migrator.allows(consumer):
            return 0
        moved = 0
        now = self.clock()
        for rid in sorted(self._assigned[idx]):
            if limit and moved >= limit:
                break
            rreq = self.requests.get(rid)
            if rreq is None or rreq.proxy is None:
                continue
            if self._migrate_request(rreq, idx, now, reason,
                                     consumer=consumer) == "ok":
                moved += 1
        return moved

    # ------------------------------------------------------------------
    # soft health + degradation ladder
    def _observe_health(self):
        c = self.config
        if c.degraded_ttft_ms <= 0 and c.degraded_shed_rate <= 0:
            return
        for idx, h in enumerate(self.health):
            if h.state not in (HEALTHY, DEGRADED):
                continue
            try:
                st = self.replicas[idx].stats()
            except Exception:
                continue
            h.observe(ttft_p95_ms=st.get("ttft_ms_p95"),
                      shed_rate=st.get("shed_rate"))

    def overload(self) -> float:
        """Aggregate queue pressure over routable replicas (1.0 when none
        are routable — total overload by definition)."""
        depth = cap = 0
        for idx, h in enumerate(self.health):
            if not h.routable:
                continue
            g = self._gauges(idx)
            depth += int(g.get("queue_depth", 0))
            cap += int(g.get("queue_capacity", 0))
        if cap <= 0:
            return 1.0
        return depth / cap

    def _evaluate_ladder(self):
        c = self.config
        score = self.overload()
        n = len(c.ladder_enter)
        while self.tier < n and score >= c.ladder_enter[self.tier]:
            self._set_tier(self.tier + 1, score)
        if (self.tier > 0 and score <= c.ladder_exit[self.tier - 1]
                and self._step_count - self._tier_changed_step
                >= c.ladder_dwell_steps):
            self._set_tier(self.tier - 1, score)

    def _set_tier(self, tier: int, score: float):
        old, self.tier = self.tier, tier
        self._tier_changed_step = self._step_count
        self._counters["tier_transitions"] += 1
        self._emit("tier", from_tier=old, to_tier=tier,
                   score=round(score, 4))

    # ------------------------------------------------------------------
    # rolling restarts + fleet seams
    def start_drain(self, idx: int):
        """Stop routing new work to replica ``idx``; in-flight requests
        finish in place (a ``replica.drained`` event fires when the last
        one does). Idempotent: a repeat call on an already-DRAINING
        replica changes nothing — and in particular must not clear an
        in-flight half-open probe's bookkeeping."""
        if self.health[idx].state == DRAINING:
            return
        self.health[idx].start_drain()
        self._probe_req.pop(idx, None)

    def reactivate(self, idx: int, replica=None):
        """Bring a drained/tripped/dead replica back into rotation —
        optionally swapping in a fresh engine object (the restarted
        process). A LIVE replica (HEALTHY/DEGRADED) is refused loudly:
        silently swapping an engine that is still taking traffic would
        discard its in-flight work's home — ``start_drain()`` it first."""
        h = self.health[idx]
        if h.state in (HEALTHY, DEGRADED):
            raise ValueError(
                f"replica {idx} is live ({h.state}) — reactivate() only "
                f"brings back a draining/tripped/dead/parked replica; "
                f"start_drain({idx}) first to swap a serving engine")
        if replica is not None:
            if self._assigned[idx]:
                # the old engine is being discarded with work still on
                # it: fail the work over BEFORE the swap (cancel must
                # reach the old engine) or drain() would poll orphaned
                # proxies forever
                self._failover_replica(idx, "reactivate")
            self.replicas[idx] = _one_process(replica)
        self.health[idx].reactivate()

    def add_replica(self, replica) -> int:
        """Grow the fleet: append a fresh replica (HEALTHY, immediately
        routable) and return its index. The fleet manager's cold
        scale-up path; also usable directly for manual capacity adds."""
        idx = len(self.replicas)
        self.replicas.append(_one_process(replica))
        self.health.append(ReplicaHealth(self.config, idx, self.clock,
                                         emit=self._emit))
        self._assigned.append(set())
        self._emit("replica.added", replica=idx)
        return idx

    def assigned(self, idx: int) -> int:
        """In-flight requests currently assigned to replica ``idx`` (the
        public drain-progress gauge — a DRAINING replica is drained when
        this reaches zero)."""
        return len(self._assigned[idx])

    def yield_work(self, idx: int, reason: str = "yield"):
        """Fail replica ``idx``'s in-flight work over to survivors
        without a health verdict — the drain-timeout escape hatch: a
        wedged drain must never deadlock ``drain()`` behind one
        replica."""
        if self._assigned[idx]:
            self._failover_replica(idx, reason)

    def fleet_gauges(self) -> dict:
        """One merged fleet view from the public surfaces: per-state
        replica counts, aggregate queue/slot gauges over alive replicas,
        and the overload score — the payload of the ``fleet`` gauge
        event and the capacity model's food."""
        by_state = {s: 0 for s in STATES}
        depth = cap = busy = total = 0
        for idx, h in enumerate(self.health):
            by_state[h.state] += 1
            if not h.alive:
                continue
            g = self._gauges(idx)
            depth += int(g.get("queue_depth", 0))
            cap += int(g.get("queue_capacity", 0))
            busy += int(g.get("slots_busy", 0))
            total += int(g.get("slots_total", 0))
        return {
            "replicas": len(self.replicas),
            "routable": sum(1 for h in self.health if h.routable),
            "by_state": by_state,
            "queue_depth": depth, "queue_capacity": cap,
            "slots_busy": busy, "slots_total": total,
            "live_requests": len(self.requests),
            "overload": round(self.overload(), 4),
        }

    # ------------------------------------------------------------------
    @property
    def pending(self) -> bool:
        return bool(self.requests)

    def drain(self, max_steps: Optional[int] = None) -> List[RouterRequest]:
        out: List[RouterRequest] = []
        steps = 0
        while self.pending and (max_steps is None or steps < max_steps):
            out.extend(self.step())
            steps += 1
        return out

    def generate_batch(self, prompts, max_new_tokens: int = 0, **kwargs):
        reqs = [self.submit(p, max_new_tokens=max_new_tokens, **kwargs)
                for p in prompts]
        self.drain()
        return [r.tokens if r.state == rq.FINISHED else None for r in reqs]

    def reset_stats(self):
        """Counter epoch boundary (bench warmup -> measured window); live
        requests and health state are untouched."""
        self.finished.clear()
        self._counters = {"submitted": 0, "finished": 0, "shed": 0,
                          "failovers": 0, "migrations": 0,
                          "deduped_tokens": 0,
                          "replay_divergence": 0, "tier_transitions": 0,
                          "shed_reasons": {}}

    def stats(self) -> dict:
        s = self._counters
        total = max(1, s["submitted"])
        ttfts = [r.record()["ttft_ms"] for r in self.finished
                 if r.first_token_ts]
        return {
            "tier": self.tier,
            "replica_states": [h.state for h in self.health],
            "breaker_trips": sum(h.trips for h in self.health),
            "finished": s["finished"], "shed": s["shed"],
            "shed_reasons": dict(s["shed_reasons"]),
            "failovers": s["failovers"],
            "migrations": s["migrations"],
            "deduped_tokens": s["deduped_tokens"],
            "replay_divergence": s["replay_divergence"],
            "tier_transitions": s["tier_transitions"],
            "availability": round(s["finished"] / total, 4),
            "ttft_ms_p50": _pct(ttfts, 50),
            "ttft_ms_p95": _pct(ttfts, 95),
            "live": len(self.requests),
        }

    def destroy(self):
        for r in self.replicas:
            destroy = getattr(r, "destroy", None)
            if destroy is not None:
                destroy()


# ---------------------------------------------------------------------------
# fleet manager: elastic scale over the router's drain/reactivate seams


class ReplicaFactory:
    """The scale-up seam: builds one fresh replica engine. ``build()``
    returns anything with the ``ServingEngine`` surface, or raises —
    the fleet manager backs off exponentially on failures (and the
    chaos harness wraps this seam to prove it).

    ``warm`` declares the build path: a warm factory builds a replica
    whose kernels are already built and loaded in this process, so it
    reaches its first token without a kernel build; a cold one pays
    it."""

    warm = False

    def build(self):
        raise NotImplementedError


class CallableReplicaFactory(ReplicaFactory):
    """Wrap a zero-arg builder callable as the factory seam::

        CallableReplicaFactory(
            lambda: ServingEngine(init_inference(model,
                                                 serving=serving_cfg)),
            warm=True)
    """

    def __init__(self, fn: Callable, warm: bool = False):
        self._fn = fn
        self.warm = bool(warm)

    def build(self):
        return self._fn()


class FleetManager:
    """Elastic scale over a :class:`ReplicaRouter`: the execution half
    of the autoscaler (policy in ``serving/autoscaler.py``), walking
    replicas through the router's public ``start_drain`` /
    ``reactivate`` / ``add_replica`` seams.

    Scale-down picks the least-loaded routable replica, drains it in
    place, and **parks** the drained engine — pools and weights and all
    — instead of destroying it. Scale-up walks the cheapest path first:

    1. **cancel an in-progress drain** (the burst-during-scale-down
       case: the replica still holds its work, reactivation is free);
    2. **unpark** a parked engine (warm: its pools and weights live);
    3. **build** through the :class:`ReplicaFactory` seam — into a DEAD
       slot when one exists, else appended — with exponential backoff
       across factory failures.

    Every decision is a ``fleet`` telemetry event and an ``autoscale``
    span on the request-trace stream. Token delivery is untouched: the
    router's exactly-once dedupe shim owns that contract, and scaling
    only ever uses the same drain/failover paths chaos already proves.
    """

    def __init__(self, router: ReplicaRouter, factory=None, config=None,
                 capacity=None):
        self.router = router
        if config is None:
            config = FleetConfig()
        elif isinstance(config, dict):
            config = FleetConfig(**config)
        self.config: FleetConfig = config
        if callable(factory) and not hasattr(factory, "build"):
            factory = CallableReplicaFactory(factory)
        self.factory = factory
        self.capacity = capacity          # optional CapacityModel feed
        self.clock = router.clock
        self.telemetry = router.telemetry
        # live metrics plane: the telemetry manager's registry when one
        # is armed (FakeTelemetry test doubles carry none — getattr, not
        # attribute reach-in, keeps them working)
        self._metrics = getattr(self.telemetry, "metrics",
                                None) or NULL_REGISTRY
        self.autoscaler = Autoscaler(config)
        self._tracer = router._tracer
        self._trace_id = (self._tracer.new_trace(hint="fleet")
                          if self._tracer.enabled else None)
        self._step_count = 0
        self._parked: Dict[int, object] = {}    # idx -> parked engine
        self._draining: Dict[int, int] = {}     # idx -> drain start step
        self._factory_fails = 0
        self._factory_next_step = 0
        self._last_step_ts = self.clock()
        self._last_rebalance_step: Optional[int] = None
        self._counters = self._fresh_counters()

    @staticmethod
    def _fresh_counters():
        return {"scale_ups": 0, "scale_downs": 0, "parks": 0,
                "unparks": 0, "drains_cancelled": 0, "drains_lost": 0,
                "drain_timeouts": 0, "factory_builds": 0,
                "factory_failures": 0, "drain_migrations": 0,
                "rebalances": 0}

    # ------------------------------------------------------------------
    def _emit(self, name: str, **data):
        self.telemetry.emit("fleet", name, step=self._step_count, **data)

    @property
    def active_size(self) -> int:
        """Replicas currently taking traffic (HEALTHY + DEGRADED)."""
        return sum(1 for h in self.router.health if h.routable)

    @property
    def pending(self) -> bool:
        return self.router.pending

    # ------------------------------------------------------------------
    # front-door delegation (the fleet manager IS the front door once
    # autoscaling is on — same surface, scaling rides step())
    def submit(self, prompt, **kwargs) -> RouterRequest:
        rreq = self.router.submit(prompt, **kwargs)
        if rreq.state == rq.SHED:
            # submit-time sheds never appear in a step() result — feed
            # the budget here or the shed budget undercounts exactly
            # the overload sheds it exists to catch
            self.autoscaler.observe_requests([rreq.record()])
        return rreq

    def cancel(self, request_id: str, reason: str = "cancelled") -> bool:
        return self.router.cancel(request_id, reason)

    def _routable_load(self) -> float:
        """Per-replica load over ROUTABLE replicas only — the capacity
        model fits one serving replica's curve, so parked/draining
        slots must not dilute the denominator (a saturated survivor
        would read as half-loaded)."""
        busy = depth = total = 0
        for idx, h in enumerate(self.router.health):
            if not h.routable:
                continue
            g = self.router._gauges(idx)
            busy += int(g.get("slots_busy", 0))
            depth += int(g.get("queue_depth", 0))
            total += int(g.get("slots_total", 0))
        return (busy + depth) / max(1, total)

    def step(self) -> List[RouterRequest]:
        done = self.router.step()
        self._step_count += 1
        self._check_drains()
        # a drain-timeout yield can fail work over — and shed it — AFTER
        # the router snapshotted its step result: pick those terminals
        # up, or the shed budget misses exactly the overload sheds it
        # exists to catch (and drain() callers never see them)
        live = self.router._done_this_step
        if len(live) > len(done):
            done = done + live[len(done):]
        overload = self.router.overload()
        self.autoscaler.observe_requests(r.record() for r in done)
        self.autoscaler.observe_step(overload)
        if self.capacity is not None:
            now = self.clock()
            dt = max(0.0, now - self._last_step_ts)
            self._last_step_ts = now
            tokens = sum(len(r.tokens) for r in done
                         if r.state == rq.FINISHED)
            active = max(1, self.active_size)
            load = self._routable_load()
            self.capacity.observe(load, tokens=tokens / active, secs=dt)
            for r in done:
                if r.state == rq.FINISHED and r.first_token_ts:
                    self.capacity.observe(load, ttft_ms=1e3 * (
                        r.first_token_ts - r.submit_ts))
        if self.active_size > self.config.max_replicas \
                and not self._draining:
            # breaker recovery can push the routable count past the
            # bound (a scale-up replaced tripped replicas that later
            # probed back HEALTHY): max_replicas is a hard ceiling, not
            # a hint — drain the excess, one replica per step
            self._execute(Decision(SCALE_DOWN, "max_replicas",
                                   self._step_count, overload=overload))
        else:
            decision = self.autoscaler.decide(
                self.active_size, overload=overload,
                can_shrink=not self._draining)
            if decision is not None:
                self._execute(decision)
        self._maybe_rebalance()
        if self.telemetry.enabled:
            self._emit("fleet.gauges", **self.gauges())
            self._metrics_step(overload)
        return done

    def _metrics_step(self, overload: float):
        """Per-step registry feed: per-replica health (one-hot), fleet
        state counts, load/overload, and the autoscaler's error-budget
        internals (burn rates + budget remaining) — the policy's math
        made externally scrapeable. No-op instruments when the metrics
        plane is disarmed."""
        m = self._metrics
        health = m.gauge("ds_replica_health", ("replica", "state"),
                         max_label_sets=256)
        for idx, h in enumerate(self.router.health):
            for state in STATES:
                health.labels(replica=str(idx), state=state).set(
                    1 if h.state == state else 0)
        by_state = {s: 0 for s in STATES}
        for h in self.router.health:
            by_state[h.state] += 1
        fleet = m.gauge("ds_fleet_replicas", ("state",))
        for state, n in by_state.items():
            fleet.labels(state=state).set(n)
        m.gauge("ds_fleet_active_replicas").set(self.active_size)
        m.gauge("ds_fleet_parked_replicas").set(len(self._parked))
        m.gauge("ds_fleet_draining_replicas").set(len(self._draining))
        m.gauge("ds_fleet_overload").set(round(float(overload), 4))
        m.gauge("ds_fleet_load").set(round(self._routable_load(), 4))
        budget = m.gauge("ds_slo_budget_remaining", ("slo",))
        for slo, rem in self.autoscaler.budget_remaining().items():
            if rem is not None:
                budget.labels(slo=slo).set(rem)
        burn = m.gauge("ds_slo_burn_rate", ("slo", "window"))
        for slo, windows in self.autoscaler.burn_rates().items():
            for window, rate in windows.items():
                if rate is not None:
                    burn.labels(slo=slo, window=window).set(
                        round(min(rate, 1e6), 4))

    def drain(self, max_steps: Optional[int] = None) -> List[RouterRequest]:
        out: List[RouterRequest] = []
        steps = 0
        while self.pending and (max_steps is None or steps < max_steps):
            out.extend(self.step())
            steps += 1
        return out

    def generate_batch(self, prompts, max_new_tokens: int = 0, **kwargs):
        reqs = [self.submit(p, max_new_tokens=max_new_tokens, **kwargs)
                for p in prompts]
        self.drain()
        return [r.tokens if r.state == rq.FINISHED else None for r in reqs]

    # ------------------------------------------------------------------
    # scaling
    def _check_drains(self):
        c = self.config
        for idx in sorted(self._draining):
            h = self.router.health[idx]
            if h.state == DEAD:
                # chaos (or reality) killed the replica mid-drain: the
                # router already failed its work over exactly-once —
                # the slot is simply lost, not parked
                self._draining.pop(idx)
                self._counters["drains_lost"] += 1
                self._emit("drain.lost", replica=idx)
                continue
            if self.router.assigned(idx):
                # drain-via-migration: MOVE the in-flight work to
                # survivors instead of waiting it out — the timeout
                # below demotes from the plan to the fallback. Work
                # that cannot move (no capacity, mid-prefill, fault)
                # stays put and keeps draining in place.
                moved = self.router.migrate_work(idx, "drain")
                if moved:
                    self._counters["drain_migrations"] += moved
                    self._emit("drain.migrated", replica=idx,
                               moved=moved)
            if self.router.assigned(idx) == 0:
                self._park(idx)
                continue
            age = self._step_count - self._draining[idx]
            if c.drain_timeout_steps and age >= c.drain_timeout_steps:
                # a wedged drain must not hold the scale-down hostage:
                # yield the stragglers to survivors and park anyway
                self.router.yield_work(idx, "drain_timeout")
                self._counters["drain_timeouts"] += 1
                self._emit("drain.timeout", replica=idx, steps=age)
                self._park(idx)

    def _maybe_rebalance(self):
        """Migrate-based decode-side defragmentation: when the most
        fragmented routable replica's ``kv_fragmentation`` gauge (the
        pool-waste signal — reserved-but-uncommitted token rows
        over reserved capacity) crosses ``rebalance_fragmentation``,
        move up to ``rebalance_max_requests`` of its sequences to
        less-fragmented survivors, then cool down — one bounded sweep
        per ``rebalance_cooldown_steps``, never a migration storm."""
        c = self.config
        if not c.rebalance_fragmentation:
            return
        if (self._last_rebalance_step is not None
                and self._step_count - self._last_rebalance_step
                < c.rebalance_cooldown_steps):
            return
        worst, frag = None, 0.0
        for idx, h in enumerate(self.router.health):
            if not h.routable or self.router.assigned(idx) == 0:
                continue
            f = float(self.router._gauges(idx).get("kv_fragmentation",
                                                   0.0))
            if f > frag:
                worst, frag = idx, f
        if worst is None or frag < c.rebalance_fragmentation:
            return
        # cooldown stamps on TRIGGER, not on success: a rebalance whose
        # every move fell through must back off, not hammer every step
        self._last_rebalance_step = self._step_count
        moved = self.router.migrate_work(
            worst, "rebalance", consumer="rebalance",
            limit=c.rebalance_max_requests)
        if moved:
            self._counters["rebalances"] += moved
            self._emit("rebalance", replica=worst,
                       fragmentation=round(frag, 4), moved=moved)

    def _park(self, idx: int):
        self._draining.pop(idx, None)
        self._parked[idx] = self.router.replicas[idx]
        self._counters["parks"] += 1
        self._emit("replica.parked", replica=idx)

    def _execute(self, decision):
        t0 = self.clock()
        before = self.active_size
        if decision.action == SCALE_UP:
            detail = self._scale_up(decision.reason)
        else:
            detail = self._scale_down(decision.reason)
        if detail is None:
            return
        detail.setdefault("burn", decision.burn)
        detail["overload"] = decision.overload
        self._emit(f"scale.{decision.action}", reason=decision.reason,
                   from_size=before, to_size=self.active_size, **detail)
        self._metrics.counter("ds_fleet_scale_events_total",
                              ("action",)).labels(
                                  action=decision.action).inc()
        if self._tracer.enabled:
            self._tracer.record_span(
                "autoscale", self._trace_id, to_ns(t0),
                to_ns(self.clock()), action=decision.action,
                reason=decision.reason, from_size=before,
                to_size=self.active_size,
                source=detail.get("source"))

    def _scale_up(self, reason: str) -> Optional[dict]:
        # 1) cheapest: cancel an in-progress drain (work still in place)
        for idx in sorted(self._draining):
            if self.router.health[idx].state == DRAINING:
                self._draining.pop(idx)
                self.router.reactivate(idx)
                self._counters["drains_cancelled"] += 1
                self._counters["scale_ups"] += 1
                return {"source": "cancelled_drain", "replica": idx,
                        "warm": True}
        # 2) warm: unpark a drained engine — its pools and weights live
        if self._parked:
            idx = min(self._parked)
            self._parked.pop(idx)
            self.router.reactivate(idx)
            self._counters["unparks"] += 1
            self._counters["scale_ups"] += 1
            return {"source": "parked", "replica": idx, "warm": True}
        # 3) the factory seam, behind exponential failure backoff
        if self.factory is None:
            self._emit("scale.blocked", reason=reason,
                       detail="no_factory")
            return None
        if self._step_count < self._factory_next_step:
            return None  # backing off a failing factory; retry later
        try:
            replica = self.factory.build()
        except Exception as e:
            self._factory_fails += 1
            backoff = self.config.factory_backoff_steps \
                * (2 ** (self._factory_fails - 1))
            self._factory_next_step = self._step_count + backoff
            self._counters["factory_failures"] += 1
            self._emit("factory.failed", error=f"{type(e).__name__}: {e}",
                       failures=self._factory_fails,
                       retry_step=self._factory_next_step)
            return None
        self._factory_fails = 0
        self._factory_next_step = 0
        self._counters["factory_builds"] += 1
        self._counters["scale_ups"] += 1
        dead = next((i for i, h in enumerate(self.router.health)
                     if h.state == DEAD and i not in self._parked), None)
        if dead is not None:
            self.router.reactivate(dead, replica=replica)
            return {"source": "factory", "replica": dead,
                    "warm": bool(self.factory.warm), "replaced_dead": True}
        idx = self.router.add_replica(replica)
        return {"source": "factory", "replica": idx,
                "warm": bool(self.factory.warm)}

    def _scale_down(self, reason: str) -> Optional[dict]:
        routable = [i for i, h in enumerate(self.router.health)
                    if h.routable]
        if len(routable) <= self.config.min_replicas:
            return None
        # least-loaded victim (highest index breaks ties): draining the
        # emptiest replica finishes fastest
        idx = min(routable, key=lambda i: (self.router._load(i), -i))
        self.router.start_drain(idx)
        self._draining[idx] = self._step_count
        self._counters["scale_downs"] += 1
        return {"source": "drain", "replica": idx}

    # manual operator levers (the tests' chaos choreography too)
    def scale_up(self, reason: str = "manual") -> Optional[dict]:
        before = self.active_size
        detail = self._scale_up(reason)
        if detail is not None:
            self._emit("scale.up", reason=reason, from_size=before,
                       to_size=self.active_size, **detail)
        return detail

    def scale_down(self, idx: Optional[int] = None,
                   reason: str = "manual") -> Optional[dict]:
        if idx is None:
            before = self.active_size
            detail = self._scale_down(reason)
            if detail is not None:
                self._emit("scale.down", reason=reason, from_size=before,
                           to_size=self.active_size, **detail)
            return detail
        if idx in self._draining:
            return None  # idempotent, like start_drain itself
        before = self.active_size
        self.router.start_drain(idx)
        self._draining[idx] = self._step_count
        self._counters["scale_downs"] += 1
        self._emit("scale.down", reason=reason, replica=idx,
                   from_size=before, to_size=self.active_size)
        return {"source": "drain", "replica": idx}

    # ------------------------------------------------------------------
    def gauges(self) -> dict:
        """The merged per-step fleet view (also the ``fleet.gauges``
        event payload): router fleet gauges + fleet bookkeeping + SLO
        budget remaining."""
        return {
            **self.router.fleet_gauges(),
            "active": self.active_size,
            "parked": len(self._parked),
            "draining": len(self._draining),
            "min_replicas": self.config.min_replicas,
            "max_replicas": self.config.max_replicas,
            "budget_remaining": self.autoscaler.budget_remaining(),
        }

    def stats(self) -> dict:
        return {
            **self.gauges(),
            **self._counters,
            "router": self.router.stats(),
        }

    def reset_stats(self):
        self._counters = self._fresh_counters()
        self.router.reset_stats()

    def destroy(self):
        # parked engines stay in router.replicas (parking is fleet-level
        # bookkeeping, not removal), so the router teardown covers them
        self.router.destroy()
