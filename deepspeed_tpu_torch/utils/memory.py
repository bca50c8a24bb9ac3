"""Device/host memory reporting (counterpart of ``deepspeed_tpu/utils/
memory.py``, reference ``see_memory_usage``, ``deepspeed/runtime/
utils.py:821``).

The card's numbers are the ``torch.cuda`` caching allocator's counters
(MA / Max_MA / CA: allocated, peak allocated, reserved), read without a
sync; the host's are this process's peak RSS and the machine's used
memory. Rank-0 gated, and the peak is reset after each report so
successive call sites bracket phases, as in the reference.
"""

import gc
import os

import torch

from deepspeed_tpu_torch.utils.logging import log_dist

_GB = 1024 ** 3


def memory_stats(device_index=None) -> dict:
    """Normalized device + host memory snapshot."""
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    dev = {"bytes_in_use": torch.cuda.memory_allocated(device_index)
           if cuda else 0,
           "peak_bytes_in_use": torch.cuda.max_memory_allocated(device_index)
           if cuda else 0,
           "bytes_reserved": torch.cuda.memory_reserved(device_index)
           if cuda else 0,
           "bytes_limit": torch.cuda.get_device_properties(
               device_index or 0).total_memory if cuda else 0,
           "source": "torch.cuda" if cuda else "none"}
    import resource

    rss = 1024 * int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
    pages, page = os.sysconf("SC_PHYS_PAGES"), os.sysconf("SC_PAGE_SIZE")
    avail = os.sysconf("SC_AVPHYS_PAGES")
    used = (pages - avail) * page
    return {"device": dev, "host_rss_bytes": rss,
            "host_used_bytes": int(used),
            "host_percent": 100.0 * used / (pages * page)}


def see_memory_usage(message: str, force: bool = False, device_index=None):
    """Log a one-line memory report (rank 0); ``force`` gates it exactly
    like the reference, so ungated call sites cost nothing."""
    if not force:
        return
    gc.collect()
    s = memory_stats(device_index)
    d = s["device"]
    limit = d["bytes_limit"] / _GB if d["bytes_limit"] else float("nan")
    log_dist(
        f"{message} | device MA {d['bytes_in_use'] / _GB:.2f} GB "
        f"Max_MA {d['peak_bytes_in_use'] / _GB:.2f} GB "
        f"CA {d['bytes_reserved'] / _GB:.2f} GB "
        f"limit {limit:.2f} GB ({d['source']}) | "
        f"host peak RSS {s['host_rss_bytes'] / _GB:.2f} GB "
        f"used {s['host_used_bytes'] / _GB:.2f} GB "
        f"({s['host_percent']:.0f}%)", ranks=[0])
    if d["source"] == "torch.cuda":
        torch.cuda.reset_peak_memory_stats(device_index)
