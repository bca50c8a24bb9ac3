"""Serving configuration (counterpart of ``deepspeed_tpu/serving/config.py``).

The ``serving`` block of the inference config. Import-light: no torch, so
the host-side scheduler runs anywhere.

Knobs of the JAX serving layer that the port does not implement yet
are still parsed, and a set one raises :class:`NotImplementedError`
naming the slice that brings it — never accepted and ignored.
"""

import math
from typing import List, Optional

from pydantic import field_validator, model_validator

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel

SHED = "shed"
QUEUE = "queue"

PROMPT_LOOKUP = "prompt_lookup"
DRAFT_MODEL = "draft_model"

_FLEET = "the multi-GPU serving slice (router, fleet, gateway, migration, " \
         "replay)"


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
    # ---- knobs of later slices: parsed, and rejected when set ----
    router: Optional[dict] = None
    fleet: Optional[dict] = None
    replay: Optional[dict] = None
    migration: Optional[dict] = None
    gateway: Optional[dict] = None

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

    @model_validator(mode="after")
    def _unported(self):
        def on(block):
            return block is not None and block.get("enabled", True)

        later = {
            "router": (on(self.router), _FLEET),
            "fleet": (on(self.fleet), _FLEET),
            "replay": (on(self.replay), _FLEET),
            "migration": (on(self.migration), _FLEET),
            "gateway": (on(self.gateway), _FLEET),
        }
        for key, (value, where) in later.items():
            if value:
                raise NotImplementedError(
                    f"serving.{key} is not ported yet: it comes with "
                    f"{where} of the PyTorch port")
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
