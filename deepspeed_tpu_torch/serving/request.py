"""One in-flight generation request (copy of
``deepspeed_tpu/serving/request.py``).

Lifecycle: ``queued`` -> ``running`` (owns a decode slot + cache blocks)
-> ``finished`` (reason: ``eos`` | ``max_tokens`` | ``deadline``), or
``shed`` straight from submit/queue (reason: ``queue_full`` |
``inflight_tokens`` | ``too_long`` | ``deadline``). Timestamps are
host-monotonic; :meth:`Request.record` turns them into the telemetry
payload (TTFT, queue wait, tokens/s) the serving event stream carries.
"""

import dataclasses
import itertools
from typing import Any, Callable, List, Optional

QUEUED = "queued"
RUNNING = "running"
FINISHED = "finished"
SHED = "shed"

_ids = itertools.count()


def _auto_id() -> str:
    return f"req-{next(_ids)}"


@dataclasses.dataclass
class Request:
    prompt: Any                       # 1-D int sequence (list/np array)
    max_new_tokens: int = 0           # 0 = serving default
    request_id: str = dataclasses.field(default_factory=_auto_id)
    eos_token_id: int = -1            # -1 disables early stop
    deadline_ms: float = 0.0          # 0 = serving default
    # stream(request, token, done) fires once per generated token, on the
    # scheduler thread, in generation order
    stream: Optional[Callable] = None
    # ---- per-request (keyed) sampling knobs, served under a
    # ``serving.sampling`` block: with do_sample on, token P is a pure
    # function of (seed, P, logits); without the block, or without a
    # seed, a do_sample request sheds at submit ----
    do_sample: bool = False
    seed: Optional[int] = None
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None

    # ---- runtime state (owned by the scheduler/engine) ----
    state: str = QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    submit_ts: float = 0.0
    admit_ts: float = 0.0             # left the queue, won a decode slot
    first_token_ts: float = 0.0
    finish_ts: float = 0.0
    slot: int = -1
    length: int = 0                   # tokens currently in the KV cache
    # ---- prefix-cache / chunked-prefill accounting (set at admit by
    # the scheduler, advanced by the engine's prefill path) ----
    cached_len: int = 0               # prompt tokens already in the pool
    prefix_hit_tokens: int = 0        # matched cached prefix length
    blocks_shared: int = 0            # physical blocks mapped read-only
    prefill_chunks: int = 0           # prefill / chunk calls this prefill
    # (src, dst) pool blocks: dst must receive a device copy of src's
    # rows before any append (partial-tail copy-on-write), or None
    cow: Optional[tuple] = None
    # ---- speculative-decoding accounting (advanced by the engine's
    # verify step; zero when speculation is off or never proposed) ----
    draft_tokens: int = 0             # proposer tokens sent to verify
    accepted_tokens: int = 0          # drafts the target model agreed with
    # ---- span-tracing context (telemetry/tracing.py) ----
    # {"trace": id, "parent": span id, ...}: stamped by the multi-replica
    # router so replica-side spans join the CLIENT's trace under the
    # current attempt span (a failover continues one trace, not two).
    # None when tracing is off — every consumer guards on it.
    trace: Optional[dict] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return self.state in (FINISHED, SHED)

    @property
    def keyed(self) -> bool:
        """Replayable sampled request: every emitted position's token is
        regenerable from (seed, position) by any replica."""
        return self.do_sample and self.seed is not None

    @property
    def positions_emitted(self) -> int:
        """Generated positions already streamed — with ``length`` and the
        token list, the ONLY sampler state there is (counter-based keys
        have no hidden generator to carry across a migration or replay)."""
        return len(self.tokens)

    def emit_token(self, token: int, done: bool):
        self.tokens.append(int(token))
        if self.stream is not None:
            self.stream(self, int(token), done)

    def record(self) -> dict:
        """JSON-safe per-request telemetry payload."""
        gen_secs = max(self.finish_ts - self.first_token_ts, 0.0)
        return {
            "request_id": self.request_id,
            "state": self.state,
            "reason": self.finish_reason,
            "do_sample": bool(self.do_sample),
            "prompt_len": self.prompt_len,
            "new_tokens": len(self.tokens),
            "queue_ms": round(1e3 * max(
                self.admit_ts - self.submit_ts, 0.0), 3)
            if self.admit_ts else None,
            "ttft_ms": round(1e3 * (self.first_token_ts - self.submit_ts), 3)
            if self.first_token_ts else None,
            "tokens_per_sec": round(len(self.tokens) / gen_secs, 2)
            if len(self.tokens) > 1 and gen_secs > 0 else None,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "blocks_shared": self.blocks_shared,
            "prefill_chunks": self.prefill_chunks,
            "draft_tokens": self.draft_tokens,
            "accepted_tokens": self.accepted_tokens,
            "acceptance_rate": round(
                self.accepted_tokens / self.draft_tokens, 4)
            if self.draft_tokens else None,
        }
