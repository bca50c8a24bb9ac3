"""Serving configuration (counterpart of ``deepspeed_tpu/serving/config.py``).

The ``serving`` block of the inference config, with the fleet's blocks
(``router``, ``fleet``, ``replay``, ``migration``, ``gateway``) as the
JAX package has them: the same validators, defaults and resolved
fields. Import-light: no torch, so the host-side scheduler and the
fleet's policy run anywhere.
"""

import math
from typing import List, Optional

from pydantic import field_validator, model_validator

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel

SHED = "shed"
QUEUE = "queue"

PROMPT_LOOKUP = "prompt_lookup"
DRAFT_MODEL = "draft_model"

# SLO classes the gateway maps onto the scheduler's priority floor
SLO_GOLD = "gold"
SLO_BEST_EFFORT = "best_effort"
SLO_BATCH = "batch"
SLO_CLASSES = (SLO_GOLD, SLO_BEST_EFFORT, SLO_BATCH)


class SpeculativeConfig(DeepSpeedConfigModel):
    """The ``serving.speculative`` block: draft-and-verify decoding on
    the fixed-slot decode loop (copy of the JAX block). Absent (the
    default) speculation does not exist and the decode step is exactly
    as before. Present, each decode step proposes up to
    ``num_speculative_tokens`` continuation tokens per slot on the host
    and ONE verify forward scores them all; the longest prefix the
    target model's greedy tokens agree with is committed (1 to k+1
    tokens per step). Greedy decode is the accept oracle, so
    ``serving.do_sample`` must stay off while speculation is on."""

    enabled: bool = True
    # "prompt_lookup": n-gram match against the request's own context
    # (zero extra model); "draft_model": a small injected draft
    # (ServingEngine(..., draft_model=...)) guesses greedily
    proposer: str = PROMPT_LOOKUP
    # k — draft tokens proposed (and query rows verified) per step; short
    # proposals right-pad against the garbage block
    num_speculative_tokens: int = 4
    # prompt-lookup knobs: suffix n-gram sizes tried, longest first
    prompt_lookup_min_ngram: int = 1
    prompt_lookup_max_ngram: int = 3
    # trailing context tokens the n-gram scan searches (0 = unbounded):
    # the scan is host Python on the step-critical path
    prompt_lookup_window: int = 1024
    # draft-model knob: trailing context tokens the draft sees per step
    # (0 = the full prompt + generation)
    draft_context_window: int = 0

    @field_validator("num_speculative_tokens")
    @classmethod
    def _k(cls, v):
        if v <= 0:
            raise ValueError(
                "serving.speculative.num_speculative_tokens must be > 0 "
                f"(k proposed tokens per verify step), got {v}")
        return v

    @field_validator("proposer")
    @classmethod
    def _proposer(cls, v):
        if v not in (PROMPT_LOOKUP, DRAFT_MODEL):
            raise ValueError(
                f"serving.speculative.proposer must be '{PROMPT_LOOKUP}' "
                f"or '{DRAFT_MODEL}', got {v!r}")
        return v

    @field_validator("draft_context_window", "prompt_lookup_window")
    @classmethod
    def _window(cls, v, info):
        if v < 0:
            raise ValueError(
                f"serving.speculative.{info.field_name} must be >= 0 "
                f"(0 = full context), got {v}")
        return v

    @model_validator(mode="after")
    def _ngrams(self):
        if not (1 <= self.prompt_lookup_min_ngram
                <= self.prompt_lookup_max_ngram):
            raise ValueError(
                "serving.speculative needs 1 <= prompt_lookup_min_ngram "
                f"<= prompt_lookup_max_ngram, got min="
                f"{self.prompt_lookup_min_ngram} max="
                f"{self.prompt_lookup_max_ngram}")
        return self


class SamplingConfig(DeepSpeedConfigModel):
    """The ``serving.sampling`` block: reproducible keyed sampling on the
    fixed-slot decode loop. Absent (the default), keyed sampling does not
    exist and every step runs as before. Present, a request submitted
    with ``do_sample=True`` and a ``seed`` draws each token from a
    threefry key folded from ``(seed, absolute position)``
    (``ops/sampling.py``) with its own temperature, top-k and top-p, so
    the emitted token is a pure function of (seed, position, logits),
    whatever slot or batch mix serves it.

    One sampling authority per engine: the engine-level ``do_sample``
    (one shared generator, not replayable) must stay off, and
    speculative decoding (whose accept oracle is the greedy stream)
    cannot be combined with this block."""

    enabled: bool = True
    # per-request defaults a sampled request inherits when it leaves
    # temperature/top_k/top_p unset (the seed has no default: an unseeded
    # do_sample request is not replayable and sheds)
    default_temperature: float = 1.0
    default_top_k: int = 0
    default_top_p: float = 0.0

    @field_validator("default_temperature")
    @classmethod
    def _temp(cls, v):
        if v <= 0:
            raise ValueError(
                "serving.sampling.default_temperature must be > 0, "
                f"got {v}")
        return v

    @field_validator("default_top_k")
    @classmethod
    def _topk(cls, v):
        if v < 0:
            raise ValueError(
                "serving.sampling.default_top_k must be >= 0 "
                f"(0 = disabled), got {v}")
        return v

    @field_validator("default_top_p")
    @classmethod
    def _topp(cls, v):
        if not 0.0 <= v <= 1.0:
            raise ValueError(
                "serving.sampling.default_top_p must be in [0, 1] "
                f"(0 = disabled), got {v}")
        return v


class ReplayConfig(DeepSpeedConfigModel):
    """The ``serving.replay`` block: workload-replay defaults consumed by
    :class:`deepspeed_tpu_torch.serving.replay.TraceReplayer` (the trace-driven
    load harness). Pure bookkeeping — the block never touches the serving
    engines; it only parameterizes how a
    recorded arrival trace is replayed against them."""

    enabled: bool = True
    # JSONL arrival trace to replay ("" = the caller passes records)
    trace_path: str = ""
    # simulated seconds each replay iteration advances the fake clock by
    # (one target.step() per iteration — smaller = finer arrival timing,
    # more steps per simulated second)
    step_secs: float = 0.05
    # deterministic prompt-token synthesis seed (same seed + same trace
    # = bit-identical prompts, the replay-determinism contract)
    seed: int = 0
    # synthesized prompt tokens are drawn from [1, vocab_size)
    vocab_size: int = 1000
    # hard iteration bound (0 = run to trace end + drain) — the guard
    # against a wedged target spinning the replay loop forever
    max_steps: int = 0

    @field_validator("step_secs")
    @classmethod
    def _step(cls, v):
        if v <= 0:
            raise ValueError(
                f"serving.replay.step_secs must be > 0 (simulated seconds "
                f"per replay iteration), got {v}")
        return v

    @field_validator("vocab_size")
    @classmethod
    def _vocab(cls, v):
        if v < 2:
            raise ValueError(
                f"serving.replay.vocab_size must be >= 2, got {v}")
        return v


class FleetConfig(DeepSpeedConfigModel):
    """The ``serving.fleet`` block: the SLO error-budget autoscaler over
    the multi-replica router (:class:`deepspeed_tpu_torch.serving.router.
    FleetManager`). Absent (the default) the fleet layer does not exist
    — the router runs its static replica set. Present (requires
    ``serving.router``), scaling decisions walk replicas through the
    router's ``start_drain`` / ``reactivate`` seams against error
    budgets: scale-down drains and parks engines, scale-up reactivates
    parked replicas (warm — their pools and weights are live) or builds
    fresh ones through the ``ReplicaFactory`` seam."""

    enabled: bool = True
    # fleet size bounds (active = HEALTHY + DEGRADED replicas)
    min_replicas: int = 1
    max_replicas: int = 4
    # ---- SLO error budgets (0 = that budget is off) ----
    # TTFT p95 target: at most 5% of finished requests may exceed it (the
    # p95 semantic IS the budget); burn rate = observed-over fraction/0.05
    target_ttft_p95_ms: float = 0.0
    # allowed shed fraction; burn rate = observed shed rate / this
    target_shed_rate: float = 0.0
    # ---- burn-rate windows (router steps) ----
    fast_window_steps: int = 8     # urgent scale-up detection
    slow_window_steps: int = 64    # budget-remaining accounting + quiet gate
    # fast-window burn rate at or above this triggers scale-up (1.0 =
    # burning exactly the budget; >1 tolerates short spikes)
    burn_rate_fast: float = 1.0
    # ---- load thresholds (router overload score, 0..1) ----
    scale_up_load: float = 0.8     # queue pressure alone can trigger growth
    scale_down_load: float = 0.3   # pressure must sit below this to shrink
    # ---- hysteresis + cooldowns (router steps) ----
    scale_up_cooldown_steps: int = 4
    scale_down_cooldown_steps: int = 16
    # consecutive quiet steps (low load AND fast burns within budget)
    # required before a scale-down — the anti-flap guard
    scale_down_quiet_steps: int = 16
    # ---- the ReplicaFactory seam ----
    # steps to wait after a failed factory build before retrying; doubles
    # per consecutive failure (the retry_io exponential series)
    factory_backoff_steps: int = 4
    # a drain older than this many steps force-yields its in-flight work
    # to survivors and parks anyway (0 = wait forever) — scale-down must
    # never deadlock drain() behind one wedged replica
    drain_timeout_steps: int = 0
    # ---- migrate-based defragmentation (needs serving.migration) ----
    # pool-fragmentation gauge (1 - committed/allocated-capacity) at or
    # above this triggers a migrate-based rebalance of the worst replica
    # (0 = rebalance off)
    rebalance_fragmentation: float = 0.0
    # steps between rebalance sweeps — defrag must not thrash the pools
    rebalance_cooldown_steps: int = 16
    # in-flight requests moved off the fragmented replica per sweep
    rebalance_max_requests: int = 1

    @field_validator("min_replicas", "max_replicas", "fast_window_steps",
                     "slow_window_steps", "scale_up_cooldown_steps",
                     "scale_down_cooldown_steps", "scale_down_quiet_steps",
                     "factory_backoff_steps", "rebalance_cooldown_steps",
                     "rebalance_max_requests")
    @classmethod
    def _positive(cls, v, info):
        if v <= 0:
            raise ValueError(
                f"serving.fleet.{info.field_name} must be > 0, got {v}")
        return v

    @field_validator("target_ttft_p95_ms", "target_shed_rate",
                     "burn_rate_fast", "drain_timeout_steps")
    @classmethod
    def _non_negative(cls, v, info):
        if v < 0:
            raise ValueError(
                f"serving.fleet.{info.field_name} must be >= 0, got {v}")
        return v

    @field_validator("rebalance_fragmentation")
    @classmethod
    def _frag(cls, v):
        if not (0.0 <= v <= 1.0):
            raise ValueError(
                "serving.fleet.rebalance_fragmentation must be in [0, 1] "
                f"(0 = rebalance off), got {v}")
        return v

    @model_validator(mode="after")
    def _bounds(self):
        if self.min_replicas > self.max_replicas:
            raise ValueError(
                "serving.fleet needs min_replicas <= max_replicas, got "
                f"{self.min_replicas} > {self.max_replicas}")
        if not (0.0 <= self.scale_down_load < self.scale_up_load <= 1.0):
            raise ValueError(
                "serving.fleet needs 0 <= scale_down_load < scale_up_load "
                f"<= 1 (load hysteresis), got down={self.scale_down_load} "
                f"up={self.scale_up_load}")
        return self


class MigrationConfig(DeepSpeedConfigModel):
    """The ``serving.migration`` block: live KV-block migration — move a
    running sequence's committed pool blocks (plus int8 side pools and
    scales, riding the same block indices) to a peer replica and splice
    the request into a free decode slot there, mid-stream, with no
    prefill dispatch. Absent (the default) the migration layer does not
    exist: failover replays and drains wait in place. Present, three
    consumers use the one primitive: router failover on a breaker trip
    or host-observed stall whose source pool is still readable (a hard
    crash keeps the deterministic-replay path),
    fleet-manager drain/scale-down (``drain_timeout_steps`` becomes the
    fallback, not the plan), and autoscaler-triggered defragmentation of
    the most fragmented replica."""

    enabled: bool = True
    # migrate-first on breaker trip / stall failover (source pool still
    # readable); off = deterministic replay exactly as without the block
    failover: bool = True
    # fleet drains move in-flight work to survivors instead of waiting
    drain: bool = True
    # autoscaler-triggered migrate-based rebalance of fragmented pools
    rebalance: bool = True
    # cap on requests moved per drain/rebalance sweep (0 = all of them)
    max_requests_per_sweep: int = 0

    @field_validator("max_requests_per_sweep")
    @classmethod
    def _sweep(cls, v):
        if v < 0:
            raise ValueError(
                "serving.migration.max_requests_per_sweep must be >= 0 "
                f"(0 = move everything), got {v}")
        return v


class RouterConfig(DeepSpeedConfigModel):
    """The ``serving.router`` block: N replica serving engines behind one
    submit()/drain() front door (:class:`deepspeed_tpu_torch.serving.router.
    ReplicaRouter`). Absent (the default) the router layer does not
    exist — ``init_serving`` returns the plain single-engine
    ``ServingEngine`` and nothing about its behavior changes."""

    enabled: bool = True
    # replica engines init_serving builds when given a model (ignored
    # when the caller passes pre-built replicas)
    replicas: int = 2
    # ---- per-replica health state machine / circuit breaker ----
    # consecutive submit/step failures before the breaker trips
    failure_threshold: int = 3
    # half-open probe delay after a trip; doubles per trip (the same
    # exponential series resilience.integrity.retry_io walks)
    probe_backoff_secs: float = 0.5
    # breaker trips before the replica is declared DEAD
    max_trips: int = 4
    # host-observed step wall time above this is a stall verdict (the
    # hang-watchdog signal at router granularity); 0 = off
    stall_timeout_secs: float = 0.0
    # soft DEGRADED signals from the replica's own telemetry aggregates
    # (TTFT p95 / shed rate over the bounded records window); 0 = off
    degraded_ttft_ms: float = 0.0
    degraded_shed_rate: float = 0.0
    # hysteresis: DEGRADED recovers only below enter * exit_fraction
    degraded_exit_fraction: float = 0.5
    # ---- failover ----
    # resubmissions per request before it is failed as replica_lost
    max_failovers: int = 2
    # ---- SLO-guarded degradation ladder ----
    # overload score (aggregate queue depth / aggregate queue capacity
    # over routable replicas; 1.0 when none are routable) thresholds:
    # crossing enter[t] raises the tier to t+1 immediately, dropping back
    # below exit[t] lowers it one tier AFTER ladder_dwell_steps (the
    # hysteresis guard against tier flapping / timeout storms)
    ladder_enter: List[float] = [0.75, 0.9, 1.0]
    ladder_exit: List[float] = [0.5, 0.65, 0.8]
    ladder_dwell_steps: int = 8
    # tier 1+: clamp per-request max_new_tokens to this budget
    clamp_max_new_tokens: int = 16
    # tier 2+: shed submits whose priority is below this floor
    shed_priority_floor: int = 1

    @field_validator("replicas", "failure_threshold", "max_trips",
                     "max_failovers", "ladder_dwell_steps",
                     "clamp_max_new_tokens")
    @classmethod
    def _positive(cls, v, info):
        if v <= 0:
            raise ValueError(
                f"serving.router.{info.field_name} must be > 0, got {v}")
        return v

    @model_validator(mode="after")
    def _ladder(self):
        if len(self.ladder_enter) != len(self.ladder_exit):
            raise ValueError(
                "serving.router.ladder_enter and ladder_exit must have the "
                f"same length, got {self.ladder_enter} vs {self.ladder_exit}")
        for i, (en, ex) in enumerate(zip(self.ladder_enter,
                                         self.ladder_exit)):
            if ex >= en:
                raise ValueError(
                    "serving.router ladder hysteresis needs exit < enter "
                    f"at every tier, got exit[{i}]={ex} >= enter[{i}]={en}")
        if sorted(self.ladder_enter) != list(self.ladder_enter):
            raise ValueError("serving.router.ladder_enter must be "
                             f"non-decreasing, got {self.ladder_enter}")
        return self


class SloClassConfig(DeepSpeedConfigModel):
    """One SLO class (``serving.gateway.gold`` / ``best_effort`` /
    ``batch``): the knobs a tenant inherits from its class. ``priority``
    feeds the scheduler/router priority floor (the router's degradation
    ladder sheds submits below ``serving.router.shed_priority_floor``),
    ``deadline_ms`` is the class default per-request deadline, and
    ``ttft_ms``/``error_budget`` define the class' error budget: a
    finished request burns budget when it was shed or its TTFT exceeded
    ``ttft_ms`` (0 = shed-only budget)."""

    # scheduler/router priority this class submits at
    priority: int = 0
    # class-default per-request deadline; 0 = engine default
    deadline_ms: float = 0.0
    # TTFT target the error budget counts against; 0 = shed-only
    ttft_ms: float = 0.0
    # fraction of recent requests allowed to violate the SLO
    error_budget: float = 0.05

    @field_validator("priority")
    @classmethod
    def _priority(cls, v):
        if v < 0:
            raise ValueError(
                f"serving.gateway SLO class priority must be >= 0, got {v}")
        return v

    @field_validator("deadline_ms", "ttft_ms", "error_budget")
    @classmethod
    def _nonneg(cls, v, info):
        if v < 0:
            raise ValueError(
                f"serving.gateway SLO class {info.field_name} must be "
                f">= 0, got {v}")
        return v


class GatewayTenantConfig(DeepSpeedConfigModel):
    """One row of ``serving.gateway.tenants``: an API-key identity plus
    its quotas. Rates of 0 mean unlimited; ``burst_*`` of 0 sizes the
    token bucket at one second of the rate (minimum 1)."""

    # tenant identity (the metrics/traces label)
    name: str = ""
    # the shared secret clients present (Authorization: Bearer <key>
    # or X-API-Key header)
    api_key: str = ""
    # SLO class: "gold" | "best_effort" | "batch"
    slo_class: str = SLO_BEST_EFFORT
    # token-bucket rate limits (0 = unlimited)
    requests_per_sec: float = 0.0
    tokens_per_sec: float = 0.0
    # bucket depths; 0 = one second of the rate (minimum 1)
    burst_requests: float = 0.0
    burst_tokens: float = 0.0
    # concurrent admitted-but-unfinished requests (0 = unlimited)
    max_inflight: int = 0
    # per-tenant deadline override; 0 = the SLO class default
    deadline_ms: float = 0.0
    # fraction of this tenant's requests that get a full request trace
    # with a `gateway` root span (0 = never, 1 = every request)
    trace_sample_rate: float = 0.0

    @field_validator("name", "api_key")
    @classmethod
    def _required(cls, v, info):
        if not v:
            raise ValueError(
                f"serving.gateway.tenants[].{info.field_name} is required")
        return v

    @field_validator("slo_class")
    @classmethod
    def _slo(cls, v):
        if v not in SLO_CLASSES:
            raise ValueError(
                "serving.gateway.tenants[].slo_class must be one of "
                f"{SLO_CLASSES}, got {v!r}")
        return v

    @field_validator("requests_per_sec", "tokens_per_sec",
                     "burst_requests", "burst_tokens", "deadline_ms")
    @classmethod
    def _nonneg(cls, v, info):
        if v < 0:
            raise ValueError(
                f"serving.gateway.tenants[].{info.field_name} must be "
                f">= 0, got {v}")
        return v

    @field_validator("max_inflight")
    @classmethod
    def _inflight(cls, v):
        if v < 0:
            raise ValueError(
                "serving.gateway.tenants[].max_inflight must be >= 0 "
                f"(0 = unlimited), got {v}")
        return v

    @field_validator("trace_sample_rate")
    @classmethod
    def _sample(cls, v):
        if not 0.0 <= v <= 1.0:
            raise ValueError(
                "serving.gateway.tenants[].trace_sample_rate must be in "
                f"[0, 1], got {v}")
        return v


class GatewayConfig(DeepSpeedConfigModel):
    """The ``serving.gateway`` block: the HTTP/SSE front door
    (:class:`deepspeed_tpu_torch.serving.gateway.ServingGateway`). Absent (the
    default) the gateway does not exist — requests enter via Python
    ``submit()`` calls (the gateway is pure host code and never imports
    torch). With no ``tenants`` rows the gateway is
    open: requests need no API key and run as the anonymous tenant at
    the ``best_effort`` class with no quotas."""

    enabled: bool = True
    # bind address; port 0 = ephemeral (read it back from .port)
    host: str = "127.0.0.1"
    port: int = 0
    # request hardening: bodies above this are refused with 413
    max_body_bytes: int = 1048576
    # per-connection bounded SSE send queue (tokens); a slow reader that
    # overflows it sheds THAT request only, never the step loop
    send_queue_tokens: int = 256
    # Retry-After seconds attached to 429/503 responses (rate sheds use
    # the bucket's own refill estimate when it is larger)
    retry_after_secs: float = 1.0
    # backend overload score (router/fleet ``overload()``) at or above
    # which new submits get 503 before touching the queue; 0 = off
    overload_reject_threshold: float = 0.0
    # recent finished requests per tenant the error budget is burned
    # over (a bounded sliding window)
    budget_window: int = 256
    # handler wait granularity for terminal-state polls and the pump
    poll_secs: float = 0.05
    # own the step loop: a daemon thread drives ``gateway.step()`` while
    # work is pending (off = the caller drives steps, e.g. trace replay)
    pump: bool = False
    # ---- SLO classes ----
    gold: SloClassConfig = SloClassConfig(priority=2)
    best_effort: SloClassConfig = SloClassConfig(priority=1)
    batch: SloClassConfig = SloClassConfig(priority=0)
    # ---- tenant table (empty = open gateway, anonymous tenant) ----
    tenants: List[GatewayTenantConfig] = []

    @field_validator("port")
    @classmethod
    def _port(cls, v):
        if not 0 <= v <= 65535:
            raise ValueError(
                f"serving.gateway.port must be in [0, 65535], got {v}")
        return v

    @field_validator("max_body_bytes", "send_queue_tokens",
                     "budget_window")
    @classmethod
    def _positive(cls, v, info):
        if v <= 0:
            raise ValueError(
                f"serving.gateway.{info.field_name} must be > 0, got {v}")
        return v

    @field_validator("retry_after_secs", "overload_reject_threshold")
    @classmethod
    def _nonneg(cls, v, info):
        if v < 0:
            raise ValueError(
                f"serving.gateway.{info.field_name} must be >= 0, got {v}")
        return v

    @field_validator("poll_secs")
    @classmethod
    def _poll(cls, v):
        if v <= 0:
            raise ValueError(
                f"serving.gateway.poll_secs must be > 0, got {v}")
        return v

    @model_validator(mode="after")
    def _unique_tenants(self):
        names = [t.name for t in self.tenants]
        keys = [t.api_key for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(
                f"serving.gateway.tenants names must be unique, got {names}")
        if len(set(keys)) != len(keys):
            raise ValueError(
                "serving.gateway.tenants api_keys must be unique (two "
                "tenants sharing a key would be one identity)")
        return self


class ServingConfig(DeepSpeedConfigModel):
    enabled: bool = True
    # ---- paged KV cache ----
    # tokens per cache block; per-layer pools are [num_blocks, block_size,
    # H, D] and block 0 is the reserved garbage sink
    block_size: int = 16
    # total pool blocks; 0 = garbage block + decode_slots full-length
    # sequences (the conservative no-overcommit sizing)
    num_blocks: int = 0
    # longest prompt+generation the runtime admits; 0 = the model window
    max_model_len: int = 0
    # ---- continuous batching ----
    # concurrent decode sequences (the decode step's static batch)
    decode_slots: int = 4
    # prompt-length buckets for prefill; [] = powers of two from
    # block_size up to max_model_len
    prompt_buckets: List[int] = []
    # ---- admission control / backpressure ----
    max_queue_depth: int = 64
    # cap on committed tokens (prompt + max_new over queued + running);
    # 0 = unbounded
    max_inflight_tokens: int = 0
    # "shed": reject a submit that would exceed max_inflight_tokens;
    # "queue": accept it and defer slot admission until work drains
    shed_policy: str = SHED
    # default per-request deadline (submit -> finish), 0 = none
    deadline_ms: float = 0.0
    default_max_new_tokens: int = 64
    # ---- engine-level sampling (greedy default: tokens equal
    # per-request generate()) ----
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    seed: int = 0
    # ---- the serving fast path (all off by default) ----
    # radix prefix cache: admission maps a cached prompt prefix's blocks
    # read-only (refcounted) and prefills only the tail
    prefix_cache: bool = False
    # > 0: prompts prefill in chunks of this many tokens, round-robin
    # under this per-step budget, through the paged attention kernel
    # (0 = whole-prompt bucketed prefill)
    prefill_chunk_tokens: int = 0
    # "" stores the pools in the compute dtype; "int8" quantizes K/V per
    # pool row with an f32 scale side pool
    kv_cache_dtype: str = ""
    # draft-and-verify decoding (None = speculation does not exist)
    speculative: Optional[SpeculativeConfig] = None
    # per-request keyed sampling (None = greedy or engine-level sampling
    # only, every step as without it)
    sampling: Optional[SamplingConfig] = None
    # pad legacy generate() prompts up to the bucket set (left-padded
    # generation: the same tokens, the pads stripped on return)
    bucket_legacy_generate: bool = True
    # ---- multi-replica front door (None = the router layer does not
    # exist; single-engine serving is exactly as before) ----
    router: Optional[RouterConfig] = None
    # ---- fleet manager (None = no autoscaler; the router's replica set
    # is static). Requires a router block. ----
    fleet: Optional[FleetConfig] = None
    # ---- workload-replay defaults (None = no defaults; the replay
    # harness takes explicit arguments). Never touches the engines. ----
    replay: Optional[ReplayConfig] = None
    # ---- live KV-block migration (None = migration does not exist:
    # failover replays, drains wait) ----
    migration: Optional[MigrationConfig] = None
    # ---- HTTP/SSE front door (None = the gateway does not exist;
    # requests enter via Python submit()) ----
    gateway: Optional[GatewayConfig] = None

    @field_validator("block_size", "decode_slots")
    @classmethod
    def _positive(cls, v, info):
        if v <= 0:
            raise ValueError(f"serving.{info.field_name} must be > 0, "
                             f"got {v}")
        return v

    @field_validator("shed_policy")
    @classmethod
    def _policy(cls, v):
        if v not in (SHED, QUEUE):
            raise ValueError(
                f"serving.shed_policy must be '{SHED}' or '{QUEUE}', "
                f"got {v!r}")
        return v

    @field_validator("prompt_buckets")
    @classmethod
    def _buckets(cls, v):
        if any(b <= 0 for b in v):
            raise ValueError(f"serving.prompt_buckets must be positive, "
                             f"got {v}")
        return sorted(set(int(b) for b in v))

    @field_validator("prefill_chunk_tokens")
    @classmethod
    def _chunk(cls, v):
        if v < 0:
            raise ValueError(
                f"serving.prefill_chunk_tokens must be >= 0 (0 = whole-"
                f"prompt bucketed prefill), got {v}")
        return v

    @field_validator("kv_cache_dtype")
    @classmethod
    def _kv_dtype(cls, v):
        if v not in ("", "int8"):
            raise ValueError(
                f"serving.kv_cache_dtype must be '' (model dtype) or "
                f"'int8', got {v!r}")
        return v

    @model_validator(mode="after")
    def _fleet_needs_router(self):
        if (self.fleet is not None and self.fleet.enabled
                and (self.router is None or not self.router.enabled)):
            # the fleet manager scales the ROUTER's replica set through
            # its drain/reactivate seams — without a router there is
            # nothing to scale, and silently ignoring the block would
            # read as "autoscaling is on" when it is not
            raise ValueError(
                "serving.fleet requires a serving.router block (the fleet "
                "manager scales the router's replica set; add \"router\": "
                "{...} or drop the fleet block)")
        return self

    @model_validator(mode="after")
    def _speculative_needs_greedy(self):
        if (self.speculative is not None and self.speculative.enabled
                and self.do_sample):
            # the accept oracle is token equality against the target's
            # own greedy stream; a sampled stream has no such oracle
            raise ValueError(
                "serving.speculative requires greedy decoding "
                "(do_sample: false): draft acceptance is verified "
                "against the greedy token stream")
        return self

    @model_validator(mode="after")
    def _sampling_one_authority(self):
        if self.sampling is not None and self.sampling.enabled:
            if self.do_sample:
                # the engine-level sampler draws from one shared
                # generator: its tokens depend on dispatch order
                raise ValueError(
                    "serving.sampling requires do_sample: false — the "
                    "keyed sampler is per-REQUEST (submit with "
                    "do_sample=True and a seed); the engine-level "
                    "do_sample knob is the legacy shared-rng sampler")
            if self.speculative is not None and self.speculative.enabled:
                raise ValueError(
                    "serving.sampling cannot be combined with "
                    "serving.speculative: draft acceptance is verified "
                    "against the greedy token stream (rejection-sampled "
                    "speculation is not implemented)")
        return self


def resolve_buckets(buckets, max_len: int, floor: int = 8):
    """The prompt-length bucket set: the configured list (clipped to
    ``max_len``), or powers of two from ``floor`` up, always ending at
    ``max_len`` so every admissible prompt has a bucket."""
    max_len = int(max_len)
    if buckets:
        out = sorted(set(int(b) for b in buckets if int(b) <= max_len))
    else:
        out = []
        b = max(1, int(floor))
        while b < max_len:
            out.append(b)
            b *= 2
    if not out or out[-1] != max_len:
        out.append(max_len)
    return out


def bucket_for(n: int, buckets):
    """Smallest bucket >= n, or None when n exceeds them all."""
    for b in buckets:
        if n <= b:
            return b
    return None


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    return max(1, math.ceil(n_tokens / block_size))
