"""Prometheus text exposition for the metric registry (the part of
``deepspeed_tpu/telemetry/prom.py`` the gateway's ``/metrics`` needs).

:func:`render_exposition` renders a registry snapshot (the deterministic
dict :meth:`~deepspeed_tpu_torch.telemetry.registry.MetricRegistry.
snapshot` produces) as Prometheus text format 0.0.4 with a trailing
``# EOF`` marker (OpenMetrics convention), served as
:data:`CONTENT_TYPE`. No timestamps are emitted, so equal snapshots
render byte-identically — the fake-clock determinism contract. The
per-process metrics server, the text-file dump and the parser come with
the telemetry slice.
"""

from typing import Dict, List

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_value(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(labels: Dict[str, str], extra=()) -> str:
    items = [(k, labels[k]) for k in sorted(labels)] + list(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in items)
    return "{" + body + "}"


def render_exposition(snapshot: Dict) -> str:
    """Exposition text for a registry snapshot dict. Families sort by
    name, series by label set — byte-deterministic for equal
    snapshots."""
    out: List[str] = []
    for name in sorted(snapshot):
        fam = snapshot[name]
        mtype = fam.get("type", "gauge")
        help_text = (fam.get("help") or "").replace("\n", " ")
        out.append(f"# HELP {name} {help_text}")
        out.append(f"# TYPE {name} {mtype}")
        for row in fam.get("series", []):
            labels = row.get("labels") or {}
            if mtype == "histogram":
                bounds = row.get("bounds") or []
                counts = row.get("counts") or []
                cum = 0
                for bound, c in zip(bounds, counts):
                    cum += int(c)
                    out.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels, [('le', _fmt_value(bound))])}"
                        f" {cum}")
                cum += int(counts[len(bounds)]) if len(counts) > \
                    len(bounds) else 0
                out.append(f"{name}_bucket"
                           f"{_fmt_labels(labels, [('le', '+Inf')])} {cum}")
                out.append(f"{name}_sum{_fmt_labels(labels)} "
                           f"{_fmt_value(row.get('sum', 0.0))}")
                out.append(f"{name}_count{_fmt_labels(labels)} "
                           f"{int(row.get('count', 0))}")
            else:
                out.append(f"{name}{_fmt_labels(labels)} "
                           f"{_fmt_value(row.get('value', 0.0))}")
        if fam.get("dropped_label_sets"):
            out.append(f"# {name}: {fam['dropped_label_sets']} label "
                       f"set(s) over the cardinality bound folded into "
                       f'{{overflow="true"}}')
    out.append("# EOF")
    return "\n".join(out) + "\n"
