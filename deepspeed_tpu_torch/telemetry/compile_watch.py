"""Global kernel-build watch (the eager port's counterpart of
``deepspeed_tpu/telemetry/compile_watch.py``).

The JAX package listens to XLA's compile events. The port compiles
nothing at dispatch: its only compiles are the ``nvcc`` builds of
``csrc/`` that :mod:`deepspeed_tpu_torch.ops.op_builder.builder` runs at
first use. The builder reports each one here, and each load of a library
already in its build directory as a cache hit, with its label (the
kernel source's name) and seconds. The counters keep JAX's names
(``backend_compiles`` are the builds, ``persistent_cache_hits`` the
libraries found built); the trace and lowering timers stay 0, as the
port has no such stage. Telemetry managers subscribe to hear every build
as a ``compile`` event. Passive: nothing runs outside a build or a load.
"""

import threading
import weakref
from typing import Dict

_lock = threading.Lock()

_counts: Dict[str, float] = {
    "backend_compiles": 0,
    "backend_compile_secs": 0.0,
    "jaxpr_trace_secs": 0.0,
    "mlir_lower_secs": 0.0,
    "persistent_cache_hits": 0,
}
_by_label: Dict[str, Dict[str, float]] = {}
_subscribers = []


def record_build(label: str, secs: float, cache_hit: bool = False):
    """One kernel library built (``cache_hit`` False) or found built."""
    with _lock:
        per = _by_label.setdefault(label, {"compiles": 0, "secs": 0.0,
                                           "cache_hits": 0})
        if cache_hit:
            _counts["persistent_cache_hits"] += 1
            per["cache_hits"] += 1
        else:
            _counts["backend_compiles"] += 1
            _counts["backend_compile_secs"] += secs
            per["compiles"] += 1
            per["secs"] += secs
    for ref in list(_subscribers):
        cb = ref()
        if cb is None:
            unsubscribe_ref(ref)
            continue
        try:
            cb(label, secs, cache_hit)
        except Exception:
            pass


def subscribe(callback) -> None:
    """``callback(label, secs, cache_hit)`` on every build or cache hit,
    held weakly (a dropped manager is not kept alive by it)."""
    try:
        ref = weakref.WeakMethod(callback)
    except TypeError:
        ref = weakref.ref(callback)
    _subscribers.append(ref)


def unsubscribe_ref(ref) -> None:
    try:
        _subscribers.remove(ref)
    except ValueError:
        pass


def unsubscribe(callback) -> None:
    for ref in list(_subscribers):
        cb = ref()
        if cb is None or cb == callback:
            unsubscribe_ref(ref)


def snapshot() -> Dict:
    """Copy of the global counters + per-label attribution so far."""
    with _lock:
        return {**{k: (int(v) if isinstance(v, int) else round(v, 6))
                   for k, v in _counts.items()},
                "by_label": {k: dict(v) for k, v in _by_label.items()}}
