"""Telemetry event families and span names (the tables of
``deepspeed_tpu/telemetry/events.py``).

One event is one JSON-serializable dict: ``{"ts", "kind", "name",
"step", "rank", "data"}`` (:func:`make_event`). The engines emit through
their :class:`~deepspeed_tpu_torch.telemetry.manager.Telemetry`, the
serving fleet through whatever ``telemetry=`` object its caller passes
(``emit(kind, name, step=..., **data)``); the JSONL sink writes
:func:`dumps` lines that :func:`load_all_events` (and the repo's
``tools/telemetry_report.py``) read back, rotated segments included.
Everything in ``data`` is JSON-safe (:func:`json_safe`): a 0-d tensor
is never read (``.item()`` would sync the device), only its repr is
kept. The flight recorder (``flightrec.py``) rings the same events.
"""

import json
import os
import time
from typing import Any, Dict, Optional

KINDS = ("compile", "step_cost", "memory", "trace_window", "step",
         "wallclock", "comm", "fault", "serving", "model_time", "topology",
         "router", "aot", "tuning", "span", "fleet", "gateway")

# Registered span names (the ``span`` kind's analog of KINDS): a report
# groups phase tables and waterfalls by these literals, so an
# unregistered name is a span that renders in no summary.
SPANS = (
    # client/router level: one trace per request
    "request",        # root — submit to finish/shed, across failovers
    "attempt",        # one dispatch to one replica (attrs: attempt, replica)
    "deliver",        # tokens streamed to the client by one attempt
    # gateway (HTTP front door) level: one trace per sampled HTTP request
    "gateway",        # root — request received -> response flushed
    #                   (attrs: tenant, route, status, streamed)
    "auth",           # API-key resolution -> tenant identity (or 401/403)
    "quota",          # token-bucket/inflight admission decision
    #                   (attrs: tenant, outcome, retry_after_ms)
    # replica/serving-engine level
    "serve",          # one replica serving one attempt (engine-side root)
    "queue",          # submit/dispatch -> decode-slot admission
    "prefill",        # whole-prompt bucketed prefill
    "prefill_chunk",  # one chunked/tail prefill call
    "cow",            # copy-on-write block copy before a shared-tail append
    "decode",         # first generated token -> finish (one decode segment)
    "draft",          # speculative proposer call (host-side, per request)
    "verify",         # the shared k-token verify step, per-request view
    "spec_commit",    # accepted-prefix commit + rejected-tail drop
    "shed",           # admission/deadline shed (zero-work terminal span)
    "autoscale",      # one fleet scaling action: decision -> executed
    #                   (attrs: action, reason, from_size, to_size, source)
    "migrate",        # one live KV-block migration: export -> transfer ->
    #                   import-commit (attrs: src, dst, reason, outcome,
    #                   blocks, wire_bytes)
    # training step level: one trace per optimizer step
    "step",           # root — first observed phase -> step boundary
    "data",           # host-side batch fetch/assembly
    "fwd",            # forward (engines that split fwd/bwd)
    "bwd",            # backward (engines that split fwd/bwd)
    "fwd_bwd",        # fused forward+backward(+in-graph reduce) step
    "reduce",         # gradient reduction, where host-observable
    "optimizer",      # optimizer apply
    "ckpt_io",        # checkpoint save/load IO (own trace, between steps)
    "exposed_comm",   # measured exposed-comm window (profiled trace close)
)

# the span event envelope's reserved ``data`` keys — everything else in
# a span's data is a user attribute
SPAN_META = ("trace", "span", "parent", "start_ns", "end_ns")


def json_safe(value: Any):
    """Coerce ``value`` to something ``json.dumps`` accepts: numpy
    scalars via ``.item()``, sets/tuples to lists, everything else to its
    repr. A torch tensor is never read (that would sync the device)."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, dict):
        return {str(k): json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        return [json_safe(v) for v in value]
    if type(value).__module__ == "numpy" and getattr(value, "shape",
                                                      None) == ():
        return value.item()
    return repr(value)


def make_event(kind: str, name: str, step: Optional[int], rank: int,
               data: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "ts": round(time.time(), 6),
        "kind": kind,
        "name": name,
        "step": None if step is None else int(step),
        "rank": int(rank),
        "data": json_safe(data or {}),
    }


def dumps(event: Dict[str, Any]) -> str:
    return json.dumps(event, separators=(",", ":"), sort_keys=False)


def load_events(path: str):
    """Parse a JSONL sink file back into event dicts; malformed lines (a
    truncated tail from a crash) are skipped, not end-of-file."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def segment_paths(path: str):
    """Every on-disk segment of a (possibly rotated) JSONL sink, oldest
    first: ``telemetry.jsonl.K`` .. ``.1`` then the live file."""
    numbered = []
    k = 1
    while os.path.exists(f"{path}.{k}"):
        numbered.append(f"{path}.{k}")
        k += 1
    out = list(reversed(numbered))
    if os.path.exists(path):
        out.append(path)
    return out


def load_all_events(path: str):
    """A rotated JSONL sink's segments as one chronological event list."""
    out = []
    for p in segment_paths(path):
        out.extend(load_events(p))
    return out
