"""deepspeed_tpu_torch.runtime.resilience — the fault-tolerance layer
(counterpart of ``deepspeed_tpu/runtime/resilience/``).

Verified-good checkpoints with a fallback chain (``integrity``),
NaN/loss-spike policy enforcement beyond the fp16 path (``sentinel``),
stalled-step detection with dump-and-abort (``watchdog``), the topology
manifest (``topology``), the per-engine facade (``manager``) and the
deterministic fault injectors the tests prove every degradation path
with (``chaos``).

Off by default; enable via the ``resilience`` config block::

    {"resilience": {"enabled": true,
                    "checkpoint": {"keep_last_n": 3},
                    "sentinel": {"policy": "rollback"},
                    "watchdog": {"timeout_secs": 600}}}
"""

from deepspeed_tpu_torch.runtime.resilience import chaos  # noqa: F401
from deepspeed_tpu_torch.runtime.resilience.integrity import (  # noqa: F401
    CheckpointCorruptionError,
    ResilientCheckpointEngine,
    atomic_write_text,
    read_verified,
    verify_tag_dir,
    write_manifest,
)
from deepspeed_tpu_torch.runtime.resilience.manager import (  # noqa: F401
    Resilience,
    fast_forward,
)
from deepspeed_tpu_torch.runtime.resilience.sentinel import (  # noqa: F401
    SentinelAbort,
    StepSentinel,
)
from deepspeed_tpu_torch.runtime.resilience.topology import (  # noqa: F401
    TOPOLOGY_MANIFEST_NAME,
    TopologyShiftError,
    diff_topology,
    format_topology_diff,
    read_topology_manifest,
    write_topology_manifest,
)
from deepspeed_tpu_torch.runtime.resilience.watchdog import (  # noqa: F401
    HangWatchdog)
