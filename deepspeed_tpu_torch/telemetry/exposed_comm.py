"""Per-step exposed-communication accounting (counterpart of
``deepspeed_tpu/telemetry/exposed_comm.py``; the interval arithmetic and
the static estimate are its copies).

"Exposed comm" is the share of a step's critical path spent in
collectives that did NOT overlap compute. Two sources, each number
labeled with the one that produced it:

- **profiled** (``source: "profiled"``): a closed ``torch.profiler``
  window's Chrome trace is read for CUDA kernel events; NCCL kernels
  (``nccl*``) are the collectives, every other kernel is compute, and
  the collective time not covered by concurrent compute is the measured
  exposed time. A trace that holds no collective kernel (gloo ranks,
  whose collectives run on the host, or an NCCL world of one that
  launches none) returns its reason instead of a number, as the JAX
  source does when it cannot parse.
- **static estimate** (``source: "static_estimate"``): from the step's
  ``step_cost`` (FLOPs by ``FlopCounterMode``, collective bytes from the
  comm plan) and the configured rates, assuming ZERO overlap: comm time
  over comm + compute time, an upper bound. The rates keep JAX's names
  ``ici_gbps`` / ``axis_gbps`` / ``peak_tflops``; on the card they price
  NVLink or the network, and the card's dense peak.
"""

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]  # (start_ns, end_ns), end >= start


def merge_intervals(intervals: Sequence[Interval]) -> List[Interval]:
    """Union of possibly-overlapping intervals, sorted, coalesced."""
    out: List[Interval] = []
    for s, e in sorted((int(s), int(e)) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def total_ns(intervals: Sequence[Interval]) -> int:
    return sum(e - s for s, e in merge_intervals(intervals))


def overlap_ns(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """Length of the intersection of two interval sets."""
    ma, mb = merge_intervals(a), merge_intervals(b)
    i = j = 0
    out = 0
    while i < len(ma) and j < len(mb):
        s = max(ma[i][0], mb[j][0])
        e = min(ma[i][1], mb[j][1])
        if s < e:
            out += e - s
        if ma[i][1] <= mb[j][1]:
            i += 1
        else:
            j += 1
    return out


def exposed_fraction(comm: Sequence[Interval],
                     compute: Sequence[Interval]) -> Dict:
    """Measured exposure: collective time NOT covered by concurrent
    compute, as a fraction of the total busy window (union of both)."""
    comm_total = total_ns(comm)
    exposed = comm_total - overlap_ns(comm, compute)
    busy = total_ns(list(comm) + list(compute))
    return {
        "comm_ns": comm_total,
        "exposed_comm_ns": exposed,
        "busy_ns": busy,
        "exposed_comm_fraction": round(exposed / busy, 4) if busy else 0.0,
    }


# ---------------------------------------------------------------------------
# static-estimate fallback (always available)

# collective kernels as they appear in a CUDA trace: NCCL names every
# kernel it launches nccl... (ncclDevKernel_AllReduce_..., and so on)
COMM_KERNEL_STEMS = ("nccl",)


def _axis_rate(key: str, axis_gbps: Dict[str, float],
               ici_gbps: float) -> float:
    """Wire rate for one attribution key: a single axis reads its
    configured override (default ``ici_gbps``); a joint ``"a+b"`` key
    (one collective spanning several axes) is bounded by its SLOWEST
    link, so it takes the min of the parts."""
    parts = [p for p in key.split("+") if p] or [key]
    return min(float(axis_gbps.get(p, ici_gbps)) for p in parts)


def static_estimate(cost: Dict, ici_gbps: float, peak_tflops: float,
                    axis_gbps: Optional[Dict[str, float]] = None
                    ) -> Optional[Dict]:
    """Zero-overlap upper bound from a compiled program's ``step_cost``
    payload: comm time = collective operand bytes at ``ici_gbps`` (on the
    card: the NVLink or network rate the collectives ride),
    compute time = FLOPs at ``peak_tflops``. Returns None when the cost
    model carries neither (cost analysis unavailable on this backend).

    With ``axis_gbps`` overrides AND a per-axis attribution in the cost
    payload (``collective_bytes_per_axis``, received-bytes units), comm
    time is instead summed per mesh axis at each axis's own rate — the
    per-axis wire model a hierarchical (in-replica) gather or a slow DCN
    data axis needs to be priced honestly. An empty/absent ``axis_gbps``
    leaves the single-rate arithmetic untouched (numerically identical
    output)."""
    comm_bytes = cost.get("collective_operand_bytes") or 0
    flops = cost.get("flops") or 0.0
    per_axis = cost.get("collective_bytes_per_axis") or {}
    if comm_bytes <= 0 and flops <= 0:
        return None
    comm_secs_by_axis = None
    if axis_gbps and per_axis:
        comm_secs_by_axis = {
            key: (b / (_axis_rate(key, axis_gbps, ici_gbps) * 1e9)
                  if _axis_rate(key, axis_gbps, ici_gbps) > 0 else 0.0)
            for key, b in per_axis.items()}
        comm_secs = sum(comm_secs_by_axis.values())
    else:
        comm_secs = (comm_bytes / (float(ici_gbps) * 1e9)
                     if ici_gbps > 0 else 0.0)
    compute_secs = (float(flops) / (float(peak_tflops) * 1e12)
                    if peak_tflops > 0 else 0.0)
    denom = comm_secs + compute_secs
    out = {
        "exposed_comm_fraction": round(comm_secs / denom, 4) if denom
        else 0.0,
        "comm_secs_est": round(comm_secs, 6),
        "compute_secs_est": round(compute_secs, 6),
        "collective_operand_bytes": int(comm_bytes),
        "source": "static_estimate",
    }
    if per_axis:
        out["collective_bytes_per_axis"] = dict(per_axis)
    if comm_secs_by_axis is not None:
        out["comm_secs_by_axis"] = {
            k: round(v, 6) for k, v in comm_secs_by_axis.items()}
    return out


def default_peak_tflops() -> float:
    """The card's dense bf16 peak (TFLOP/s) when the config leaves
    ``peak_tflops: 0``: 989.4 for an H100 SXM, a small nominal figure
    elsewhere (the estimate is about ratios, and CPU runs check
    correctness)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available():
        return 0.1
    name = torch.cuda.get_device_name(0)
    return 989.4 if "H100" in name else 0.1


# ---------------------------------------------------------------------------
# profiled path: a torch.profiler Chrome trace's CUDA kernel events
def trace_intervals(trace: Dict) -> Tuple[List[Interval], List[Interval]]:
    """(comm, compute) intervals (ns) of a Chrome trace's kernel events:
    NCCL kernels are the collectives, every other kernel compute."""
    comm: List[Interval] = []
    compute: List[Interval] = []
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") != "kernel" or "dur" not in ev:
            continue
        s = int(float(ev["ts"]) * 1e3)
        e = s + int(float(ev["dur"]) * 1e3)
        if e <= s:
            continue
        name = str(ev.get("name", "")).lower()
        if any(stem in name for stem in COMM_KERNEL_STEMS):
            comm.append((s, e))
        else:
            compute.append((s, e))
    return comm, compute


def from_profiler_dir(trace_dir: str) -> Tuple[Optional[Dict],
                                               Optional[str]]:
    """Measured exposed-comm over a closed trace window: the newest
    ``*.json`` Chrome trace under ``trace_dir``, tagged ``source:
    "profiled"``; ``(None, reason)`` where it cannot be measured."""
    paths = sorted((os.path.join(d, f) for d, _, fs in os.walk(trace_dir)
                    for f in fs if f.endswith(".json")),
                   key=os.path.getmtime)
    if not paths:
        return None, f"no Chrome trace (*.json) under {trace_dir!r}"
    try:
        with open(paths[-1]) as f:
            comm, compute = trace_intervals(json.load(f))
    except (OSError, ValueError) as e:
        return None, f"Chrome trace parse failed: {e}"
    if not compute and not comm:
        return None, "no CUDA kernel events in the captured trace"
    if not comm:
        return None, ("no collective kernel in the captured trace (gloo "
                      "collectives run on the host; an NCCL world of one "
                      "launches none)")
    out = exposed_fraction(comm, compute)
    out["source"] = "profiled"
    out["trace"] = paths[-1]
    return out, None
