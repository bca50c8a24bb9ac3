"""Prometheus text exposition for the metric registry (the part of
``deepspeed_tpu/telemetry/prom.py`` the gateway's ``/metrics`` needs).

:func:`render_exposition` renders a registry snapshot (the deterministic
dict :meth:`~deepspeed_tpu_torch.telemetry.registry.MetricRegistry.
snapshot` produces) as Prometheus text format 0.0.4 with a trailing
``# EOF`` marker (OpenMetrics convention), served as
:data:`CONTENT_TYPE`. No timestamps are emitted, so equal snapshots
render byte-identically — the fake-clock determinism contract.
:func:`parse_exposition` reads it back, :class:`MetricsServer` serves a
registry per process (``telemetry.metrics_port``) and
:func:`write_textfile` dumps it atomically (``telemetry.metrics_file``).
"""

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
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


# ---------------------------------------------------------------------------
# parsing (the CLI/report side)

def _parse_labels(body: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    i = 0
    while i < len(body):
        eq = body.index("=", i)
        key = body[i:eq].strip().strip(",")
        assert body[eq + 1] == '"'
        j = eq + 2
        val = []
        while body[j] != '"':
            if body[j] == "\\":
                nxt = body[j + 1]
                val.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
            else:
                val.append(body[j])
                j += 1
        out[key] = "".join(val)
        i = j + 1
    return out


def _split_sample(line: str):
    """``name{labels} value`` -> (name, labels dict, float value)."""
    if "{" in line:
        name, rest = line.split("{", 1)
        body, tail = rest.rsplit("}", 1)
        labels = _parse_labels(body)
    else:
        parts = line.split()
        name, tail = parts[0], " ".join(parts[1:])
        labels = {}
    raw = tail.strip().split()[0]
    value = {"+Inf": float("inf"), "-Inf": float("-inf"),
             "NaN": float("nan")}.get(raw)
    return name.strip(), labels, float(raw) if value is None else value


def parse_exposition(text: str) -> Dict:
    """Parse exposition text back into a snapshot-shaped dict. Histogram
    ``_bucket``/``_sum``/``_count`` samples regroup under their base
    family with non-cumulative ``counts``; malformed lines are skipped
    (a truncated scrape must still parse)."""
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    samples = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(None, 3)
            types[name] = mtype.strip()
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) == 4:
                helps[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        try:
            samples.append(_split_sample(line))
        except Exception:
            continue
    out: Dict[str, Dict] = {}

    def family(name: str) -> Dict:
        return out.setdefault(name, {
            "type": types.get(name, "gauge"),
            "help": helps.get(name, ""), "series": []})

    def series_for(fam: Dict, labels: Dict) -> Dict:
        for row in fam["series"]:
            if row["labels"] == labels:
                return row
        row = {"labels": labels}
        fam["series"].append(row)
        return row

    for name, labels, value in samples:
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            cand = name[:-len(suffix)] if name.endswith(suffix) else None
            if cand and types.get(cand) == "histogram":
                base = (cand, suffix)
                break
        if base is None:
            series_for(family(name), labels)["value"] = value
            continue
        cand, suffix = base
        fam = family(cand)
        key = {k: v for k, v in labels.items() if k != "le"}
        row = series_for(fam, key)
        if suffix == "_bucket":
            le = labels.get("le", "+Inf")
            bound = float("inf") if le == "+Inf" else float(le)
            row.setdefault("_cum", []).append((bound, value))
        elif suffix == "_sum":
            row["sum"] = value
        else:
            row["count"] = int(value)
    # cumulative buckets -> (bounds, per-bucket counts)
    for fam in out.values():
        if fam["type"] != "histogram":
            continue
        for row in fam["series"]:
            cum = sorted(row.pop("_cum", []))
            bounds = [b for b, _ in cum if b != float("inf")]
            counts, prev = [], 0
            for _, c in cum:
                counts.append(int(c - prev))
                prev = int(c)
            row["bounds"] = bounds
            row["counts"] = counts
            row.setdefault("count", prev)
    return out


def snapshot_from_file(path: str) -> Dict:
    """Load a snapshot from either a JSON snapshot file or exposition
    text (sniffed) — what ``--prom`` arguments accept."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("{"):
        return json.loads(text)
    return parse_exposition(text)


# ---------------------------------------------------------------------------
# the per-process endpoint

class _Handler(BaseHTTPRequestHandler):
    server_version = "ds-metrics/1"

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        if self.path.split("?", 1)[0] not in ("/metrics", "/"):
            self.send_error(404, "only /metrics lives here")
            return
        registry = self.server.registry  # type: ignore[attr-defined]
        try:
            registry.counter("ds_scrapes_total").inc()
            body = registry.expose().encode("utf-8")
        except Exception as e:  # noqa: BLE001 — a scrape must not crash
            self.send_error(500, f"exposition failed: {e}")
            return
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet: scrapes are periodic
        pass


class MetricsServer:
    """Serve one registry at ``http://host:port/metrics`` from a daemon
    thread. ``port=0`` binds an ephemeral port (read ``.port``)."""

    def __init__(self, registry, port: int = 0,
                 host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.registry = registry  # type: ignore[attr-defined]
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"ds-metrics[{self.port}]", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self):
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)


def write_textfile(path: str, text: str) -> None:
    """Atomic exposition dump for scrape-less environments (tmp +
    fsync + ``os.replace`` — a concurrent reader sees old or new,
    never a torn file)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


__all__ = ["render_exposition", "parse_exposition", "snapshot_from_file",
           "MetricsServer", "write_textfile", "CONTENT_TYPE"]
