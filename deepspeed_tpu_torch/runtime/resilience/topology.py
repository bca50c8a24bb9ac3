"""Checkpoint topology manifest (counterpart of
``deepspeed_tpu/runtime/resilience/topology.py``) — the contract that
makes a checkpoint restorable onto a *different* mesh on purpose instead
of by accident.

Every commit made with ``elasticity.enabled`` writes ``topology.json``
beside the integrity manifest:

- mesh axes/shape, world size, process count;
- ZeRO stage and micro-batch/GAS geometry (the batch triangle the
  restarted job must keep solving to the SAME global batch);
- per-tensor logical shape + dtype + partition spec for params and
  optimizer state, under the JAX package's names for the keys in the
  file (``params/<flax path>``, ``opt_state/.exp_avg/<flax path>``), so
  a manifest written by either package validates in the other;
- data-pipeline cursor (loader ``state_dict``) + step counters + RNG —
  the sample-exact replay anchor.

At load, the manifest is diffed against the live engine
(:func:`diff_topology`); an impossible reshard — a tensor whose logical
shape/dtype no longer matches, a missing tensor — raises
:class:`TopologyShiftError` carrying the structured saved-vs-current
diff. A *possible* reshard (mesh/world/stage changed, tensors intact)
proceeds: the port loads each tensor whole and lays it out for the
current stage and tp degree.
"""

import json
import os
from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import logger

TOPOLOGY_MANIFEST_NAME = "topology.json"
TOPOLOGY_MANIFEST_VERSION = 1


class TopologyShiftError(RuntimeError):
    """Resharding the checkpoint onto the current topology is impossible
    (or unsafe). Carries the structured saved-vs-current diff so launch
    tooling can render it; deliberately NOT a
    :class:`CheckpointCorruptionError` — falling back to an older
    checkpoint cannot fix a topology mismatch, so the resilience
    fallback chain must not swallow it."""

    def __init__(self, message: str, saved: Optional[Dict] = None,
                 current: Optional[Dict] = None,
                 diff: Optional[Dict] = None):
        super().__init__(message)
        self.saved = saved or {}
        self.current = current or {}
        self.diff = diff or {}


# ----------------------------------------------------------------------
# read / write
def write_topology_manifest(checkpoint_engine, tag_dir: str,
                            manifest: Dict) -> str:
    """Publish ``manifest`` as ``<tag_dir>/topology.json`` through the
    checkpoint engine's ``save_text`` seam (so it stages under the
    tiered engine's atomic publish and rides the integrity layer's
    retry/chaos seams, and — written before ``commit`` — is hashed into
    the integrity manifest like any payload file)."""
    path = os.path.join(tag_dir, TOPOLOGY_MANIFEST_NAME)
    checkpoint_engine.save_text(
        path, json.dumps(manifest, indent=1, sort_keys=True))
    return path


def read_topology_manifest(tag_dir: str) -> Optional[Dict]:
    """The topology manifest of a committed tag directory, or ``None``
    for a pre-elastic checkpoint (no manifest — loads take the legacy
    path unchanged). An unreadable manifest is loud: a half-written
    topology record must not silently demote an elastic restore."""
    path = os.path.join(tag_dir, TOPOLOGY_MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (ValueError, OSError) as e:
        raise TopologyShiftError(
            f"checkpoint {tag_dir!r}: topology manifest unreadable ({e}) — "
            "the tag was saved with elasticity enabled but its topology "
            "record is damaged; verify the checkpoint (integrity manifest) "
            "or load with an explicit same-topology engine")


# ----------------------------------------------------------------------
# diff / validate
def _mesh_desc(manifest: Dict) -> Dict:
    return manifest.get("mesh", {}) or {}


def _normalize_axes(axes: Optional[Dict]) -> Dict[str, int]:
    """Canonical view of a manifest's mesh-axes dict: alias names fold
    ("model" -> "tp" — pre-3-axis checkpoints restore onto the renamed
    axis without a phantom diff) and size-1 axes drop (a 5-axis-era
    manifest without "fsdp" equals a new one carrying fsdp=1)."""
    from deepspeed_tpu_torch.parallel.topology import AXIS_ALIASES

    return {AXIS_ALIASES.get(str(a), str(a)): int(s)
            for a, s in (axes or {}).items() if int(s) != 1}


def diff_topology(saved: Dict, current: Dict) -> Dict:
    """Structured saved-vs-current comparison. ``changed`` lists benign
    shifts (mesh axes — rendered axis-by-axis, world size, ZeRO stage,
    batch geometry — the reshard path handles those); ``fatal`` lists
    differences no reshard can bridge (tensor set/shape/dtype
    mismatches)."""
    changed: Dict[str, Any] = {}
    fatal: Dict[str, Any] = {}

    s_mesh, c_mesh = _mesh_desc(saved), _mesh_desc(current)
    s_axes = _normalize_axes(s_mesh.get("axes"))
    c_axes = _normalize_axes(c_mesh.get("axes"))
    # axis-by-axis: a tp=1 -> tp=2 restore renders as "mesh.axes.tp",
    # not an opaque whole-dict swap
    for axis in sorted(set(s_axes) | set(c_axes)):
        sv, cv = s_axes.get(axis, 1), c_axes.get(axis, 1)
        if sv != cv:
            changed[f"mesh.axes.{axis}"] = {"saved": sv, "current": cv}
    for field in ("world_size", "process_count"):
        sv, cv = s_mesh.get(field), c_mesh.get(field)
        if sv != cv:
            changed[f"mesh.{field}"] = {"saved": sv, "current": cv}
    if saved.get("zero_stage") != current.get("zero_stage"):
        changed["zero_stage"] = {"saved": saved.get("zero_stage"),
                                 "current": current.get("zero_stage")}
    s_batch, c_batch = saved.get("batch", {}) or {}, current.get("batch", {}) or {}
    for field in sorted(set(s_batch) | set(c_batch)):
        if s_batch.get(field) != c_batch.get(field):
            changed[f"batch.{field}"] = {"saved": s_batch.get(field),
                                         "current": c_batch.get(field)}

    s_t = saved.get("tensors") or {}
    c_t = current.get("tensors") or {}
    if s_t and c_t:
        missing_cur = sorted(set(s_t) - set(c_t))
        missing_saved = sorted(set(c_t) - set(s_t))
        if missing_cur:
            fatal["tensors_missing_in_current"] = missing_cur
        if missing_saved:
            fatal["tensors_missing_in_saved"] = missing_saved
        shape_mm, dtype_mm, spec_changed = {}, {}, {}
        for k in sorted(set(s_t) & set(c_t)):
            se, ce = s_t[k], c_t[k]
            if list(se.get("shape", [])) != list(ce.get("shape", [])):
                shape_mm[k] = {"saved": se.get("shape"),
                               "current": ce.get("shape")}
            elif se.get("dtype") != ce.get("dtype"):
                dtype_mm[k] = {"saved": se.get("dtype"),
                               "current": ce.get("dtype")}
            elif se.get("spec") != ce.get("spec"):
                spec_changed[k] = {"saved": se.get("spec"),
                                   "current": ce.get("spec")}
        if shape_mm:
            fatal["tensor_shape_mismatch"] = shape_mm
        if dtype_mm:
            fatal["tensor_dtype_mismatch"] = dtype_mm
        if spec_changed:
            changed["tensor_spec_changed"] = len(spec_changed)
    return {"changed": changed, "fatal": fatal}


def format_topology_diff(diff: Dict, limit: int = 8) -> str:
    """Human-readable rendering of :func:`diff_topology` output."""
    lines: List[str] = []
    for kind in ("fatal", "changed"):
        entries = diff.get(kind) or {}
        for key, val in entries.items():
            if isinstance(val, dict) and set(val) == {"saved", "current"}:
                lines.append(f"  [{kind}] {key}: saved={val['saved']} -> "
                             f"current={val['current']}")
            elif isinstance(val, dict):
                shown = list(val.items())[:limit]
                for name, mm in shown:
                    lines.append(f"  [{kind}] {key} {name}: "
                                 f"saved={mm.get('saved')} -> "
                                 f"current={mm.get('current')}")
                if len(val) > limit:
                    lines.append(f"  [{kind}] {key}: ... and "
                                 f"{len(val) - limit} more")
            elif isinstance(val, list):
                shown = ", ".join(val[:limit])
                more = f" (+{len(val) - limit} more)" if len(val) > limit else ""
                lines.append(f"  [{kind}] {key}: {shown}{more}")
            else:
                lines.append(f"  [{kind}] {key}: {val}")
    return "\n".join(lines) if lines else "  (identical topologies)"


def validate_reshard(saved: Dict, current: Dict, where: str) -> Dict:
    """Raise :class:`TopologyShiftError` (with the full structured diff)
    when the saved checkpoint cannot be materialized under the current
    topology; return the diff otherwise so callers can log/emit it."""
    diff = diff_topology(saved, current)
    if diff["fatal"]:
        raise TopologyShiftError(
            f"cannot reshard checkpoint {where}: the saved topology is "
            "incompatible with the current engine —\n"
            + format_topology_diff(diff)
            + "\n(the tensor set/shapes/dtypes must match; mesh/world/"
            "ZeRO-stage changes alone are reshardable)",
            saved=saved, current=current, diff=diff)
    if diff["changed"]:
        logger.info(
            f"[elastic] topology shift at {where}:\n"
            + format_topology_diff(diff))
    return diff


def topology_shifted(diff: Dict) -> bool:
    """True when the mesh/world actually changed (vs. a same-topology
    resume) — the bit the ``topology`` telemetry event reports."""
    changed = diff.get("changed") or {}
    return any(k.startswith("mesh.") for k in changed)
