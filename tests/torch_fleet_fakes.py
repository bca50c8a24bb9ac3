"""Fake replicas for holding the port's serving fleet to the JAX
package's (imports neither package nor torch: every class is built over
the request module it is given, so each package's router drives fakes of
its own ``Request``).

- ``FakeReplica``: the ``ServingEngine`` surface — bounded queue ->
  slots -> one deterministic token per running request per ``step()``;
- ``MigratableReplica``: plus ``export_sequence`` / ``import_sequence`` /
  ``migrate_out`` (the delivered prefix is seeded, never re-emitted);
- ``GaugeStub`` / ``FragStub``: queue-pressure and fragmentation dials;
- ``Recorder``: a ``telemetry=`` object that records every event.
"""

import types


def greedy(prompt, pos):
    """The fakes' shared deterministic decode: same prompt -> same token
    at every position, on every replica."""
    return (31 * sum(int(t) for t in prompt) + 7 * pos) % 997


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, secs):
        self.t += secs


class Recorder:
    enabled = True

    def __init__(self):
        self.events = []

    def emit(self, kind, name, step=None, **data):
        self.events.append((kind, name, step, data))


def fakes(rq):
    """The fake replica classes over request module ``rq``."""

    class FakeReplica:
        def __init__(self, slots=2, queue_cap=8, buckets=(8, 16),
                     ttft_p95=None, shed_rate=None, sampling=False):
            self.slots = slots
            self.queue_cap = queue_cap
            self.buckets = list(buckets)
            self.queue = []
            self.running = []
            self._ttft = ttft_p95
            self._shed = shed_rate
            self.submits = 0
            self.steps = 0
            self.cancelled = []
            self.config = types.SimpleNamespace(
                do_sample=sampling, default_max_new_tokens=5)

        def submit(self, prompt, max_new_tokens=0, request_id=None,
                   eos_token_id=-1, deadline_ms=0.0, stream=None,
                   **samp):
            self.submits += 1
            req = rq.Request(prompt=[int(t) for t in prompt],
                             max_new_tokens=int(max_new_tokens) or 4,
                             request_id=request_id or f"f-{self.submits}",
                             eos_token_id=eos_token_id,
                             deadline_ms=deadline_ms, stream=stream, **samp)
            if len(self.queue) >= self.queue_cap:
                req.state, req.finish_reason = rq.SHED, "queue_full"
                return req
            req.state = rq.QUEUED
            self.queue.append(req)
            return req

        def step(self):
            self.steps += 1
            while self.queue and len(self.running) < self.slots:
                head = self.queue.pop(0)
                head.state = rq.RUNNING
                self.running.append(head)
            for req in list(self.running):
                pos = len(req.tokens)
                tok = greedy(req.prompt, pos)
                done = (tok == req.eos_token_id
                        or pos + 1 >= req.max_new_tokens)
                req.emit_token(tok, done)
                if done:
                    req.state = rq.FINISHED
                    req.finish_reason = ("eos" if tok == req.eos_token_id
                                         else "max_tokens")
                    self.running.remove(req)

        def cancel(self, request_id, reason="cancelled"):
            for lst in (self.queue, self.running):
                for r in lst:
                    if r.request_id == request_id:
                        lst.remove(r)
                        r.state, r.finish_reason = rq.SHED, reason
                        self.cancelled.append(request_id)
                        return True
            return False

        def gauges(self):
            return {"queue_depth": len(self.queue),
                    "queue_capacity": self.queue_cap,
                    "slots_busy": len(self.running),
                    "slots_total": self.slots, "free_blocks": 99}

        def stats(self):
            return {"ttft_ms_p95": self._ttft, "shed_rate": self._shed}

    class GaugeStub(FakeReplica):
        def __init__(self, depth=0, cap=10, **kw):
            super().__init__(**kw)
            self.depth, self.cap = depth, cap

        def gauges(self):
            g = super().gauges()
            g["queue_depth"], g["queue_capacity"] = self.depth, self.cap
            return g

    class MigratableReplica(FakeReplica):
        block_size = 8

        def export_sequence(self, request_id):
            req = next((r for r in self.running
                        if r.request_id == request_id), None)
            if req is None:
                return None
            covered = len(req.prompt) + len(req.tokens)
            blocks = max(1, -(-covered // self.block_size))
            return {"request_id": req.request_id,
                    "prompt": list(req.prompt), "tokens": list(req.tokens),
                    "max_new_tokens": req.max_new_tokens,
                    "eos_token_id": req.eos_token_id,
                    "deadline_ms": req.deadline_ms,
                    "blocks": blocks, "wire_bytes": 512 * blocks}

        def import_sequence(self, export, deadline_ms=None, stream=None,
                            request_id=None, trace=None):
            if len(self.running) >= self.slots:
                return None
            req = rq.Request(prompt=list(export["prompt"]),
                             max_new_tokens=int(export["max_new_tokens"]),
                             request_id=request_id or export["request_id"],
                             eos_token_id=export["eos_token_id"],
                             deadline_ms=(export["deadline_ms"]
                                          if deadline_ms is None
                                          else deadline_ms),
                             stream=stream)
            req.tokens = list(export["tokens"])
            req.state = rq.RUNNING
            self.running.append(req)
            return req

        def migrate_out(self, request_id):
            req = next((r for r in self.running
                        if r.request_id == request_id), None)
            if req is None:
                return False
            req.state, req.finish_reason = rq.SHED, "migrated"
            self.running.remove(req)
            return True

    class FragStub(MigratableReplica):
        def __init__(self, frag=0.0, **kw):
            super().__init__(**kw)
            self.frag = frag

        def gauges(self):
            return {**super().gauges(), "kv_fragmentation": self.frag}

    return types.SimpleNamespace(FakeReplica=FakeReplica, GaugeStub=GaugeStub,
                                 MigratableReplica=MigratableReplica,
                                 FragStub=FragStub)
