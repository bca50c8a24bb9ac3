"""Telemetry event families and span names (the tables of
``deepspeed_tpu/telemetry/events.py``).

One event is one JSON-serializable dict: ``{"ts", "kind", "name",
"step", "rank", "data"}``. The serving fleet emits the ``router``,
``fleet`` and ``gateway`` families through whatever ``telemetry=``
object its caller passes (``emit(kind, name, step=..., **data)``); the
telemetry manager, its JSONL sink and the flight recorder come with the
telemetry slice.
"""

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
