"""Serving configuration (counterpart of ``deepspeed_tpu/serving/config.py``).

The ``serving`` block of the inference config. Import-light: no torch, so
the host-side scheduler runs anywhere.

Knobs of the JAX serving layer that this slice of the port does not
implement are still parsed, and a set one raises
:class:`NotImplementedError` naming the slice that brings it — never
accepted and ignored.
"""

import math
from typing import List, Optional

from pydantic import field_validator, model_validator

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel

SHED = "shed"
QUEUE = "queue"

_FAST_PATH = "the serving fast-path slice (prefix cache, chunked prefill, " \
             "speculative decoding, int8 KV with the int8 paged kernel)"
_KEYED = "the keyed-sampling slice"
_FLEET = "the multi-GPU serving slice (router, fleet, gateway, migration, " \
         "replay)"
_PADDED = "the padded-generate slice"


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
    # ---- knobs of later slices: parsed, and rejected when set ----
    prefix_cache: bool = False
    prefill_chunk_tokens: int = 0
    kv_cache_dtype: str = ""
    # the JAX default pads legacy generate() prompts to the bucket set via
    # left-padded generation, which this slice does not port
    bucket_legacy_generate: bool = False
    speculative: Optional[dict] = None
    sampling: Optional[dict] = None
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

    @model_validator(mode="after")
    def _unported(self):
        def on(block):
            return block is not None and block.get("enabled", True)

        later = {
            "prefix_cache": (self.prefix_cache, _FAST_PATH),
            "prefill_chunk_tokens": (self.prefill_chunk_tokens, _FAST_PATH),
            "kv_cache_dtype": (self.kv_cache_dtype, _FAST_PATH),
            "speculative": (on(self.speculative), _FAST_PATH),
            "sampling": (on(self.sampling), _KEYED),
            "router": (on(self.router), _FLEET),
            "fleet": (on(self.fleet), _FLEET),
            "replay": (on(self.replay), _FLEET),
            "migration": (on(self.migration), _FLEET),
            "gateway": (on(self.gateway), _FLEET),
            "bucket_legacy_generate": (self.bucket_legacy_generate, _PADDED),
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
