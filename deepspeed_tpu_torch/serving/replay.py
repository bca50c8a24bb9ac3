"""Trace-driven workload replay: open arrival-trace format, synthetic
generators, and a faster-than-real-time replayer over fake clocks (copy
of ``deepspeed_tpu/serving/replay.py``; the same seed gives the JAX
package's arrivals and prompts).

Pure host-side (no torch; no wall-clock reads — replay time is a
:class:`ReplayClock` the target shares, which is what makes a
20-minute diurnal trace replay in milliseconds and makes every run
bit-deterministic given its seed).

**Trace format** — one JSON object per line (JSONL), open by design so
real request logs convert trivially::

    {"arrival_ts": 12.75, "prompt_len": 96, "max_new_tokens": 64,
     "tenant": "t3", "prefix_len": 32, "priority": 1, "deadline_ms": 0}

``arrival_ts`` is seconds from trace start; ``tenant`` groups arrivals
that share a prompt prefix of ``prefix_len`` tokens (the prefix-cache /
shared-system-prompt workload shape); ``priority`` feeds the router's
degradation ladder; ``deadline_ms`` the admission deadline. Optional
``do_sample``/``temperature``/``top_p``/``seed`` fields request KEYED
sampling — absent keys mean greedy, so every pre-sampling trace loads
unchanged, and the per-arrival seed keeps replays bit-deterministic.

**Generators** — :func:`synthesize_trace` samples a nonhomogeneous
Poisson arrival process by thinning (diurnal sinusoid + burst windows
over a base rate), heavy-tailed (lognormal) prompt/generation lengths,
and a Zipf-skewed tenant mix. :func:`diurnal_trace` /
:func:`burst_trace` are named shapes of the same knobs.

**Replayer** — :class:`TraceReplayer` drives anything with the serving
front-door surface (``submit()``/``step()``/``pending``): one
``step()`` per ``step_secs`` of simulated time, submitting every
arrival whose timestamp has passed, synthesizing prompt tokens
deterministically (same seed + same trace = bit-identical prompts —
tenant prefixes shared, tails unique). :meth:`TraceReplayer.report`
reduces the collected request handles to SLO attainment: TTFT
p50/p95, shed rate, tokens/s of simulated time, and the fraction of
arrivals served within a target — aggregate AND per tenant (the
``tenants`` block feeds per-tenant error budgets).

**HTTP driver** — :class:`HttpReplayDriver` is a replay target that
submits THROUGH a running serving gateway over real HTTP: each arrival
becomes a ``POST /v1/generate`` with the tenant's API key, the SSE
stream is consumed by a reader thread, and ``step()`` drives the
gateway's backend on the shared fake clock. Admission is serialized
(``submit`` returns once the gateway answered status + headers), so
quota decisions and token streams stay bit-deterministic.
"""

import dataclasses
import json
import math
import threading
import urllib.error
import urllib.request
import zlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.serving.config import ReplayConfig


@dataclasses.dataclass
class Arrival:
    """One trace record. ``request_id`` is optional — the replayer
    numbers arrivals when absent."""

    arrival_ts: float
    prompt_len: int
    max_new_tokens: int
    tenant: str = ""          # shared-prefix group ("" = unshared)
    prefix_len: int = 0       # leading tokens shared across the tenant
    priority: int = 0
    deadline_ms: float = 0.0
    request_id: str = ""
    # ---- keyed sampling (optional; absent keys = greedy, so every
    # pre-sampling trace loads unchanged). ``seed`` makes the sampled
    # stream bit-reproducible — replaying the same trace twice emits
    # identical tokens, which is what lets the SLO report compare runs.
    do_sample: bool = False
    temperature: float = 0.0  # 0 = serving default
    top_p: float = 0.0        # 0 = disabled / serving default
    seed: int = 0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        # False == 0, so disabled sampling fields drop with the other
        # defaults and round-trip losslessly
        return {k: v for k, v in d.items() if v not in ("", 0, 0.0)
                or k in ("arrival_ts", "prompt_len", "max_new_tokens")}

    @classmethod
    def from_json(cls, d: dict) -> "Arrival":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def save_trace(path: str, arrivals: Sequence[Arrival]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for a in arrivals:
            f.write(json.dumps(a.to_json(), separators=(",", ":")) + "\n")


def load_trace(path: str) -> List["Arrival"]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(Arrival.from_json(json.loads(line)))
    out.sort(key=lambda a: a.arrival_ts)
    return out


# ---------------------------------------------------------------------------
# synthetic generators


def _heavy_tail(rng, mean: float, sigma: float, lo: int, hi: int) -> int:
    """Lognormal sample with the requested mean (median below it — the
    heavy tail is real: most draws small, a few near ``hi``)."""
    mu = math.log(max(1.0, float(mean))) - sigma * sigma / 2.0
    return int(np.clip(round(rng.lognormal(mu, sigma)), lo, hi))


def synthesize_trace(duration_secs: float, *, seed: int,
                     base_rate: float = 1.0,
                     diurnal_fraction: float = 0.0,
                     diurnal_period_secs: float = 60.0,
                     bursts: Sequence = (),
                     prompt_len_mean: float = 64.0,
                     prompt_len_sigma: float = 0.6,
                     prompt_len_max: int = 512,
                     gen_mean: float = 32.0,
                     gen_sigma: float = 0.6,
                     gen_max: int = 256,
                     tenants: int = 0,
                     shared_fraction: float = 0.0,
                     shared_prefix_len: int = 0,
                     priorities: int = 1,
                     deadline_ms: float = 0.0,
                     sampled_fraction: float = 0.0,
                     temperature: float = 0.0,
                     top_p: float = 0.0) -> List[Arrival]:
    """Sample one arrival trace, fully deterministic given ``seed``.

    The instantaneous arrival rate is ``base_rate * (1 +
    diurnal_fraction * sin(2*pi*t/period))`` plus every ``(start_secs,
    duration_secs, extra_rate)`` burst window covering ``t`` — sampled
    exactly by Poisson thinning. Prompt and generation lengths are
    lognormal (heavy-tailed). With ``tenants > 0``, ``shared_fraction``
    of arrivals join a Zipf-skewed tenant whose prompts share their
    first ``shared_prefix_len`` tokens (the prefix-cache shape);
    priorities are uniform over ``range(priorities)``. With
    ``sampled_fraction > 0`` that fraction of arrivals carry keyed
    sampling fields (a per-arrival seed plus the given
    ``temperature``/``top_p``); at 0 no extra rng draws happen, so
    legacy traces stay bit-identical for the same seed."""
    if base_rate <= 0 or duration_secs <= 0:
        raise ValueError("synthesize_trace needs base_rate > 0 and "
                         f"duration_secs > 0, got {base_rate}/"
                         f"{duration_secs}")
    if not (0.0 <= diurnal_fraction <= 1.0):
        raise ValueError("diurnal_fraction must be in [0, 1], got "
                         f"{diurnal_fraction}")
    rng = np.random.default_rng(int(seed))
    bursts = [(float(s), float(d), float(r)) for s, d, r in bursts]

    def rate(t: float) -> float:
        r = base_rate * (1.0 + diurnal_fraction
                         * math.sin(2.0 * math.pi * t
                                    / diurnal_period_secs))
        for start, dur, extra in bursts:
            if start <= t < start + dur:
                r += extra
        return max(r, 0.0)

    rate_max = base_rate * (1.0 + diurnal_fraction) \
        + sum(r for _, _, r in bursts)
    out: List[Arrival] = []
    t = 0.0
    while True:
        # thinning: candidate arrivals at rate_max, accepted at rate(t)
        t += float(rng.exponential(1.0 / rate_max))
        if t >= duration_secs:
            break
        if rng.random() >= rate(t) / rate_max:
            continue
        tenant, prefix = "", 0
        if tenants > 0 and shared_fraction > 0 \
                and rng.random() < shared_fraction:
            # Zipf-skewed popularity: tenant 1 is the hot system prompt
            # (the distribution's unbounded tail folds into it, so the
            # hottest tenant really is t1, not the clip boundary)
            z = int(rng.zipf(1.5))
            tenant = f"t{z if z <= tenants else 1}"
            prefix = int(shared_prefix_len)
        p_lo = max(1, prefix + 1)   # at least one unshared prompt token
        samp = {}
        if sampled_fraction > 0 and rng.random() < sampled_fraction:
            samp = {"do_sample": True,
                    "seed": int(rng.integers(1, 2**31 - 1)),
                    "temperature": float(temperature),
                    "top_p": float(top_p)}
        out.append(Arrival(
            arrival_ts=round(t, 6),
            prompt_len=max(p_lo, _heavy_tail(rng, prompt_len_mean,
                                             prompt_len_sigma, 1,
                                             prompt_len_max)),
            max_new_tokens=_heavy_tail(rng, gen_mean, gen_sigma, 1,
                                       gen_max),
            tenant=tenant, prefix_len=prefix,
            priority=int(rng.integers(0, max(1, priorities))),
            deadline_ms=float(deadline_ms), **samp))
    return out


def diurnal_trace(duration_secs: float, *, seed: int, base_rate: float,
                  peak_fraction: float = 0.5,
                  period_secs: float = 60.0, **kw) -> List[Arrival]:
    """A diurnal wave: rate swings ``±peak_fraction`` around base."""
    return synthesize_trace(duration_secs, seed=seed, base_rate=base_rate,
                            diurnal_fraction=peak_fraction,
                            diurnal_period_secs=period_secs, **kw)


def burst_trace(duration_secs: float, *, seed: int, base_rate: float,
                bursts: Sequence, **kw) -> List[Arrival]:
    """Poisson bursts over a flat base rate: ``bursts`` is a sequence of
    ``(start_secs, duration_secs, extra_rate)`` windows."""
    return synthesize_trace(duration_secs, seed=seed, base_rate=base_rate,
                            bursts=bursts, **kw)


# ---------------------------------------------------------------------------
# replay


class ReplayClock:
    """The injectable fake clock the replayer advances and the target
    (router/scheduler/health/autoscaler) reads — simulated seconds,
    decoupled from wall time. Also quacks as an injectable ``sleep`` so
    chaos stalls advance simulated time instead of blocking the test."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, secs: float) -> None:
        self.t += float(secs)

    sleep = advance


def _pct(values, q: float):
    if not values:
        return None
    vs = sorted(values)
    k = min(len(vs) - 1, max(0, math.ceil(q / 100.0 * len(vs)) - 1))
    return round(float(vs[k]), 3)


class TraceReplayer:
    """Replay one arrival trace against a serving front door.

    ``target`` is anything with ``submit()``/``step()``/``pending`` —
    a :class:`~deepspeed_tpu_torch.serving.router.ReplicaRouter`, a
    :class:`~deepspeed_tpu_torch.serving.router.FleetManager`, or a single
    ``ServingEngine``. ``clock`` must be the same :class:`ReplayClock`
    the target was built with (replay determinism is exactly this: one
    simulated timebase everywhere). ``on_step(replayer, done_records)``
    fires after every step — the seam the capacity model and tests hook.
    """

    def __init__(self, target, trace: Sequence[Arrival], clock: ReplayClock,
                 *, config: Optional[ReplayConfig] = None,
                 step_secs: Optional[float] = None, seed: Optional[int] = None,
                 vocab_size: Optional[int] = None,
                 max_steps: Optional[int] = None,
                 on_step: Optional[Callable] = None):
        if config is None:
            config = ReplayConfig()
        elif isinstance(config, dict):
            config = ReplayConfig(**config)
        self.target = target
        self.trace = sorted(trace, key=lambda a: a.arrival_ts)
        self.clock = clock
        self.step_secs = float(step_secs if step_secs is not None
                               else config.step_secs)
        self.seed = int(seed if seed is not None else config.seed)
        self.vocab = int(vocab_size if vocab_size is not None
                         else config.vocab_size)
        self.max_steps = int(max_steps if max_steps is not None
                             else config.max_steps)
        self.on_step = on_step
        # the router front door takes priority; a bare ServingEngine
        # does not — probe the surface once, not per submit
        self._routerlike = hasattr(target, "overload") \
            or hasattr(target, "router")
        self.handles: List = []
        self.tenants: List[str] = []   # aligned with handles
        self.steps = 0
        self._t0 = clock()

    # ------------------------------------------------------------------
    def prompt_for(self, arrival: Arrival, index: int) -> List[int]:
        """Deterministic token synthesis: a tenant's shared prefix comes
        from the tenant's own stream (identical across its arrivals —
        what the prefix cache deduplicates), the tail from the arrival's
        stream (unique)."""
        n, prefix = int(arrival.prompt_len), 0
        tokens: List[int] = []
        if arrival.tenant and arrival.prefix_len > 0:
            prefix = min(int(arrival.prefix_len), n - 1)
            # crc32, not hash(): str hashing is salted per process and
            # would break cross-process replay determinism
            trng = np.random.default_rng(
                [self.seed, zlib.crc32(arrival.tenant.encode())])
            tokens += [int(x) for x in
                       trng.integers(1, self.vocab, prefix)]
        arng = np.random.default_rng([self.seed, 0x5EED, index])
        tokens += [int(x) for x in
                   arng.integers(1, self.vocab, n - prefix)]
        return tokens

    def _submit(self, arrival: Arrival, index: int):
        kwargs = dict(max_new_tokens=int(arrival.max_new_tokens),
                      request_id=arrival.request_id or f"replay-{index}",
                      deadline_ms=float(arrival.deadline_ms))
        if arrival.do_sample:
            kwargs["do_sample"] = True
            kwargs["seed"] = int(arrival.seed)
            if arrival.temperature:
                kwargs["temperature"] = float(arrival.temperature)
            if arrival.top_p:
                kwargs["top_p"] = float(arrival.top_p)
        if self._routerlike:
            kwargs["priority"] = int(arrival.priority)
        if getattr(self.target, "accepts_tenant", False):
            # the HTTP driver maps the tenant to its API key
            kwargs["tenant"] = arrival.tenant
        return self.target.submit(self.prompt_for(arrival, index), **kwargs)

    def run(self) -> dict:
        """Replay to completion (trace exhausted AND target drained, or
        ``max_steps``); returns :meth:`report`'s payload."""
        i = 0
        while i < len(self.trace) or self.target.pending:
            now = self.clock()
            while i < len(self.trace) and self.trace[i].arrival_ts <= now:
                self.handles.append(self._submit(self.trace[i], i))
                self.tenants.append(self.trace[i].tenant or "")
                i += 1
            done = self.target.step()
            self.steps += 1
            if self.on_step is not None:
                self.on_step(self, done)
            self.clock.advance(self.step_secs)
            if self.max_steps and self.steps >= self.max_steps:
                break
        # HTTP-driver seam: wait (real time, no simulated steps) for the
        # reader threads to drain their streams before reporting
        finish = getattr(self.target, "finish", None)
        if finish is not None:
            finish()
        return self.report()

    # ------------------------------------------------------------------
    def _reduce(self, recs: List[dict], slo: Optional[dict]) -> dict:
        """One TTFT/shed/attainment block over a record subset (the
        aggregate report and every per-tenant row share this shape)."""
        finished = [r for r in recs if r["state"] == "finished"]
        shed = [r for r in recs if r["state"] == "shed"]
        ttfts = [r["ttft_ms"] for r in finished
                 if r.get("ttft_ms") is not None]
        out = {
            "requests": len(recs),
            "finished": len(finished),
            "shed": len(shed),
            "shed_rate": round(len(shed) / len(recs), 4) if recs else None,
            "tokens_out": sum(r.get("new_tokens") or 0 for r in finished),
            "ttft_ms_p50": _pct(ttfts, 50),
            "ttft_ms_p95": _pct(ttfts, 95),
        }
        if slo:
            target = float(slo.get("ttft_p95_ms") or 0.0)
            good = [r for r in finished
                    if not target or (r.get("ttft_ms") is not None
                                      and r["ttft_ms"] <= target)]
            out["slo_attainment"] = (round(len(good) / len(recs), 4)
                                     if recs else None)
        return out

    def report(self, slo: Optional[dict] = None) -> dict:
        """SLO attainment over every replayed arrival. With ``slo``
        (``{"ttft_p95_ms": X}``) adds ``slo_attainment`` — the fraction
        of arrivals that finished with TTFT within the target (a shed
        arrival is a miss by definition) — and ``slo_ok``, whether the
        aggregate window met both targets. Traces with tenant labels get
        a ``tenants`` block: the same TTFT/shed/attainment breakdown per
        tenant (one aggregate line would hide a starved tenant behind a
        healthy mix — this is what per-tenant error budgets read)."""
        recs = [h.record() for h in self.handles]
        finished = [r for r in recs if r["state"] == "finished"]
        shed = [r for r in recs if r["state"] == "shed"]
        ttfts = [r["ttft_ms"] for r in finished
                 if r.get("ttft_ms") is not None]
        sim_secs = self.clock() - self._t0
        tokens = sum(r.get("new_tokens") or 0 for r in finished)
        out = {
            "requests": len(recs),
            "finished": len(finished),
            "shed": len(shed),
            "shed_rate": round(len(shed) / len(recs), 4) if recs else None,
            "incomplete": len(recs) - len(finished) - len(shed),
            "tokens_out": tokens,
            "sim_secs": round(sim_secs, 6),
            "steps": self.steps,
            "tokens_per_sim_sec": round(tokens / sim_secs, 2)
            if sim_secs > 0 else None,
            "ttft_ms_p50": _pct(ttfts, 50),
            "ttft_ms_p95": _pct(ttfts, 95),
        }
        if slo:
            target = float(slo.get("ttft_p95_ms") or 0.0)
            good = [r for r in finished
                    if not target or (r.get("ttft_ms") is not None
                                      and r["ttft_ms"] <= target)]
            out["slo_attainment"] = (round(len(good) / len(recs), 4)
                                     if recs else None)
            shed_target = slo.get("shed_rate")
            out["slo_ok"] = bool(
                (not target or (out["ttft_ms_p95"] is not None
                                and out["ttft_ms_p95"] <= target))
                and (shed_target is None
                     or (out["shed_rate"] or 0.0) <= float(shed_target)))
        if (len(self.tenants) == len(recs)
                and any(t for t in self.tenants)):
            by_tenant: Dict[str, List[dict]] = {}
            for tenant, rec in zip(self.tenants, recs):
                by_tenant.setdefault(tenant or "", []).append(rec)
            out["tenants"] = {tenant: self._reduce(by_tenant[tenant], slo)
                              for tenant in sorted(by_tenant)}
        if any(r.get("do_sample") for r in recs):
            # keyed sampling adds in-graph filtering work to every
            # decode step of a sampled slot: the SLO split keeps the two
            # populations' TTFT/shed/attainment from masking each other
            out["sampling"] = {
                "sampled": self._reduce(
                    [r for r in recs if r.get("do_sample")], slo),
                "greedy": self._reduce(
                    [r for r in recs if not r.get("do_sample")], slo),
            }
        return out


# ---------------------------------------------------------------------------
# HTTP driver: replay THROUGH the serving gateway

class _HttpHandle:
    """A replay handle for one HTTP request: quacks like a Request
    (``state`` / ``done`` / ``record()``) so the replayer's report path
    is identical either way. Terminal state comes from the server — the
    ``done`` SSE event carries the backend's own record."""

    def __init__(self, request_id: str, prompt_len: int,
                 do_sample: bool = False):
        self.request_id = request_id
        self.state = "queued"
        self.tokens: List[int] = []
        self.finished = threading.Event()
        # do_sample is stamped at submit so a REJECTED sampled request
        # still lands in the report's sampled population
        self._record = {"request_id": request_id, "state": self.state,
                        "reason": None, "prompt_len": prompt_len,
                        "do_sample": bool(do_sample),
                        "new_tokens": 0, "ttft_ms": None}

    @property
    def done(self) -> bool:
        return self.state in ("finished", "shed")

    def reject(self, status: int, reason: str):
        self.state = "shed"
        self._record.update(state="shed", reason=reason,
                            http_status=status)
        self.finished.set()

    def finish(self, record: dict):
        self.state = str(record.get("state") or "finished")
        self._record.update(record)
        self._record["state"] = self.state
        self.finished.set()

    def error(self, reason: str):
        self.state = "shed"
        self._record.update(state="shed", reason=reason,
                            new_tokens=len(self.tokens))
        self.finished.set()

    def record(self) -> dict:
        rec = dict(self._record)
        rec.setdefault("new_tokens", len(self.tokens))
        return rec


class HttpReplayDriver:
    """Replay target that routes every submit through a running
    :class:`~deepspeed_tpu_torch.serving.gateway.ServingGateway` over real
    HTTP. ``submit()`` POSTs to ``/v1/generate`` with the tenant's API
    key and returns once the gateway answered (status + headers) — so
    admission/quota decisions interleave deterministically with the
    fake-clock step loop — then a daemon reader thread consumes the SSE
    stream into the handle. ``step()`` drives the gateway (deferred
    cancels + one backend step)."""

    accepts_tenant = True

    def __init__(self, gateway, *, api_keys: Optional[Dict[str, str]] = None,
                 timeout_secs: float = 60.0):
        self.gateway = gateway
        self.url = gateway.url
        if api_keys is None:
            api_keys = {t.name: t.api_key
                        for t in gateway.config.tenants}
        self.api_keys = api_keys
        self.timeout_secs = float(timeout_secs)
        self._threads: List[threading.Thread] = []
        self._count = 0

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 0, request_id: str = "",
               deadline_ms: float = 0.0, tenant: str = "",
               do_sample: bool = False, seed: Optional[int] = None,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None, **kwargs) -> _HttpHandle:
        self._count += 1
        request_id = request_id or f"http-{self._count}"
        handle = _HttpHandle(request_id, len(prompt), do_sample=do_sample)
        body = {"prompt": [int(t) for t in prompt],
                "max_new_tokens": int(max_new_tokens),
                "request_id": request_id, "stream": True}
        if deadline_ms:
            body["deadline_ms"] = float(deadline_ms)
        if do_sample:
            body["do_sample"] = True
            if seed is not None:
                body["seed"] = int(seed)
            if temperature is not None:
                body["temperature"] = float(temperature)
            if top_p is not None:
                body["top_p"] = float(top_p)
        headers = {"Content-Type": "application/json"}
        key = self.api_keys.get(tenant)
        if key:
            headers["Authorization"] = f"Bearer {key}"
        req = urllib.request.Request(self.url + "/v1/generate",
                                     data=json.dumps(body).encode("utf-8"),
                                     headers=headers, method="POST")
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout_secs)
        except urllib.error.HTTPError as exc:
            try:
                payload = json.loads(exc.read().decode("utf-8"))
                reason = payload.get("error", {}).get("reason", "")
            except Exception:
                reason = ""
            exc.close()
            handle.reject(exc.code, f"gateway_{reason or exc.code}")
            return handle
        reader = threading.Thread(target=self._read_sse,
                                  args=(resp, handle), daemon=True)
        reader.start()
        self._threads.append(reader)
        return handle

    @staticmethod
    def _read_sse(resp, handle: _HttpHandle):
        event, data = "", ""
        try:
            for raw in resp:
                line = raw.decode("utf-8").rstrip("\n")
                if line.startswith("event: "):
                    event = line[len("event: "):]
                elif line.startswith("data: "):
                    data = line[len("data: "):]
                elif line == "":
                    if event == "token":
                        handle.tokens.append(int(json.loads(data)["token"]))
                    elif event == "done":
                        handle.finish(json.loads(data))
                        return
                    elif event == "error":
                        handle.error(str(json.loads(data).get("reason")
                                         or "stream_error"))
                        return
                    event, data = "", ""
        except (OSError, ValueError):
            pass
        finally:
            resp.close()
            if not handle.finished.is_set():
                handle.error("stream_closed")

    # ------------------------------------------------------------------
    def step(self):
        return self.gateway.step()

    @property
    def pending(self) -> bool:
        return self.gateway.pending

    def drain(self, max_steps: Optional[int] = None):
        return self.gateway.drain(max_steps)

    def finish(self):
        """Join every reader thread (bounded): streams whose backend
        work completed finish without further steps; a stuck stream
        times out and stays incomplete in the report."""
        for thread in self._threads:
            thread.join(self.timeout_secs)
        self._threads = [t for t in self._threads if t.is_alive()]
