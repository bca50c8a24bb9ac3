"""Watched engine callables: call signatures and a once-a-signature step
cost (the eager port's counterpart of
``deepspeed_tpu/telemetry/jit_watch.py``).

The JAX package compiles one program per argument signature and reads
its cost from the compiled executable. The port runs eagerly, so the
thing to watch is the signature itself: :class:`WatchedFunction` keys
each call of an engine's step, forward or decode callable by its
arguments' shapes, dtypes and devices (Python scalars by type). A new
signature is what a recompile is to JAX: it is reported to the manager
(``record_compile``), which emits a ``compile`` event, marks it
``retrace: true`` past ``warmup_steps`` and warns after
``recompile_warn_after`` of them. That one call of a new signature also
runs under a FLOP counter (``telemetry/flops.py``: ``FlopCounterMode``
with the port's kernels' formulas) and a tally of the collectives it
launches through the comm facade with their operand bytes (the step's
comm plan as run; the engine's ``cost_fn`` adds the plan's own counts):
the ``step_cost`` event.
Every later call with a seen signature is the raw callable plus one
dict lookup. Nothing here reads a device value.
"""

import time
from typing import Any, Callable, Dict, Optional

from deepspeed_tpu_torch.utils.logging import logger


def _leaf_key(leaf):
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(shape), str(dtype), str(getattr(leaf, "device", "")))
    if isinstance(leaf, (list, tuple)):
        return (type(leaf).__name__,) + tuple(_leaf_key(x) for x in leaf)
    if isinstance(leaf, dict):
        return tuple((k, _leaf_key(v)) for k, v in sorted(leaf.items()))
    return ("py", type(leaf).__name__)


def signature(args, kwargs):
    """The dispatch key of one call: every argument's (shape, dtype,
    device), nested lists / tuples / dicts walked, scalars by type."""
    return (tuple(_leaf_key(a) for a in args),
            tuple((k, _leaf_key(v)) for k, v in sorted(kwargs.items())))


class WatchedFunction:
    """A callable whose new call signatures are reported to a telemetry
    manager (module docstring). ``cost_fn()``, when given, returns the
    step's comm plan (``{op: count}``) for its ``step_cost``;
    ``name_of(*args, **kwargs)``, when given, names each call with its
    shape suffix (JAX's ``serving.prefill[T=16]``: one name a program,
    the family before the bracket), and the name is part of the key."""

    def __init__(self, fn: Callable, name: str, telemetry,
                 cost_fn: Optional[Callable] = None,
                 name_of: Optional[Callable] = None):
        self._fn = fn
        self.name = name
        self._telemetry = telemetry
        self._cost_fn = cost_fn
        self._name_of = name_of
        self._seen = set()
        self.compiles = 0

    def __call__(self, *args, **kwargs):
        label = (self._name_of(*args, **kwargs) if self._name_of is not None
                 else self.name)
        key = (label, signature(args, kwargs))
        if key in self._seen:
            return self._fn(*args, **kwargs)
        self._seen.add(key)
        self.compiles += 1
        self.name = label
        tele = self._telemetry
        count = bool(tele.config.hlo_cost)
        start = time.perf_counter()
        if count:
            from deepspeed_tpu_torch.comm import comm
            from deepspeed_tpu_torch.telemetry import flops

            with flops.counter() as counter, comm.tally() as launched:
                out = self._fn(*args, **kwargs)
        else:
            out = self._fn(*args, **kwargs)
        secs = time.perf_counter() - start
        cost = None
        if count:
            cost = {"flops": float(counter.get_total_flops()),
                    **collective_cost(launched)}
            if self._cost_fn is not None:
                cost["comm_plan"] = dict(self._cost_fn())
        try:
            tele.record_compile(self, trace_secs=0.0, compile_secs=secs,
                                cost=cost)
        except Exception as e:
            logger.warning(f"telemetry: recording signature of "
                           f"{self.name!r} failed ({e}); event dropped")
        return out


def collective_cost(collectives: Dict[str, Dict[str, Any]]) -> Dict:
    """``step_cost``'s collective fields from ``{op: {"count",
    "operand_bytes"}}`` (JAX's shape of the compiled program's)."""
    collectives = {op: {"count": int(v.get("count", 0)),
                        "operand_bytes": int(v.get("operand_bytes", 0))}
                   for op, v in sorted((collectives or {}).items())}
    return {"collectives": collectives,
            "collective_operand_bytes": sum(
                v["operand_bytes"] for v in collectives.values())}
