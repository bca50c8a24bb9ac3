"""Communication op logging (copy of ``deepspeed_tpu/utils/
comms_logging.py``, reference ``deepspeed/utils/comms_logging.py``).

Records per-op message size, latency, algorithmic and bus bandwidth. The
port's collectives run eagerly, one ``torch.distributed`` call each, so
every logged op has a latency: CUDA events around it on the card (their
wait is the one sync the logger adds, and only when ``prof_all`` or
``prof_ops`` asks for the op), the host clock on the CPU. The step's
planned collectives (the telemetry ``step_cost``) are mirrored in as
``plan:...`` records with size only.
"""

import math
from typing import Dict, List

from deepspeed_tpu_torch.utils.logging import log_dist


def get_caller_func(frame=3):
    import sys

    return sys._getframe(frame).f_code.co_name


def calc_bw_log(comm_op: str, size: int, duration: float, n: int):
    """algbw/busbw in GB/s for an op of ``size`` bytes over ``n`` participants
    (NCCL-tests bus-bandwidth conventions, as in the reference)."""
    duration = max(duration, 1e-12)
    if comm_op in ("all_to_all", "all_to_all_single"):
        algbw = size / duration
        busbw = algbw * ((n - 1) / max(n, 1))
    elif comm_op in ("all_gather", "all_gather_base", "reduce_scatter", "reduce_scatter_base"):
        size *= n
        algbw = size / duration
        busbw = algbw * ((n - 1) / max(n, 1))
    elif comm_op in ("all_reduce",):
        algbw = size / duration
        busbw = algbw * (2 * (n - 1) / max(n, 1))
    else:  # broadcast / send / recv / pt2pt / reduce / barrier
        algbw = size / duration
        busbw = algbw
    # convert to Gbps-style GB/s and ms
    return size, duration * 1e3, algbw / 1e9, busbw / 1e9


class CommsLogger:
    """Reference ``CommsLogger`` (``utils/comms_logging.py:23``)."""

    def __init__(self, enabled=False, verbose=False, prof_all=True, prof_ops=None, debug=False):
        self.comms_dict: Dict[str, Dict[int, List[float]]] = {}
        self.verbose = verbose
        self.debug = debug
        self.prof_ops = prof_ops or []
        self.prof_all = prof_all
        self.enabled = enabled

    def configure(self, comms_config):
        self.enabled = comms_config.enabled
        self.verbose = comms_config.verbose
        self.debug = comms_config.debug
        self.prof_ops = list(comms_config.prof_ops)
        self.prof_all = comms_config.prof_all

    def start_profiling_comms(self):
        self.prof_all = True

    def stop_profiling_comms(self):
        self.prof_all = False

    def start_profiling_op(self, op_name_list):
        self.prof_ops = list(set(self.prof_ops) | set(op_name_list))

    def stop_profiling_op(self, op_name_list):
        self.prof_ops = [op for op in self.prof_ops if op not in op_name_list]

    def append(self, raw_name, record_name, latency, msg_size, n_participants):
        size, duration_ms, algbw, busbw = calc_bw_log(raw_name, msg_size, latency, n_participants)
        if record_name in self.comms_dict:
            if size in self.comms_dict[record_name]:
                self.comms_dict[record_name][size][0] += 1
                self.comms_dict[record_name][size][1].append(duration_ms)
                self.comms_dict[record_name][size][2].append(algbw)
                self.comms_dict[record_name][size][3].append(busbw)
            else:
                self.comms_dict[record_name][size] = [1, [duration_ms], [algbw], [busbw]]
        else:
            self.comms_dict[record_name] = {size: [1, [duration_ms], [algbw], [busbw]]}
        if self.verbose:
            log_dist(
                f"rank=? | comm op: {record_name} | time (ms): {duration_ms:.2f} | "
                f"msg size: {convert_size(size)} | algbw (Gbps): {algbw * 8:.2f} | "
                f"busbw (Gbps): {busbw * 8:.2f}", ranks=[0])

    def log_all(self, print_log=True, show_straggler=False):
        from numpy import mean

        if print_log:
            header = f"{'Comm. Op': <20}{'Message Size': <20}{'Count': <20}" \
                     f"{'Total Latency(ms)': <20}{'Avg Latency(ms)': <20}" \
                     f"{'tput_avg (Gbps)': <20}{'busbw_avg (Gbps)': <20}"
            log_dist(header, ranks=[0])
        results = {}
        for record_name in self.comms_dict.keys():
            if print_log:
                log_dist(record_name, ranks=[0])
            results[record_name] = {}
            for msg_size, vals in sorted(self.comms_dict[record_name].items()):
                count, durations, algbws, busbws = vals
                results[record_name][msg_size] = {
                    "count": count,
                    "total_latency_ms": sum(durations),
                    "avg_latency_ms": mean(durations),
                    "algbw_gbps": mean(algbws) * 8,
                    "busbw_gbps": mean(busbws) * 8,
                }
                if print_log:
                    r = results[record_name][msg_size]
                    log_dist(
                        f"{'': <20}{convert_size(msg_size): <20}{count: <20}"
                        f"{r['total_latency_ms']: <20.2f}{r['avg_latency_ms']: <20.2f}"
                        f"{r['algbw_gbps']: <20.2f}{r['busbw_gbps']: <20.2f}", ranks=[0])
        return results


def convert_size(size_bytes: int) -> str:
    if size_bytes == 0:
        return "0B"
    size_name = ("B", "KB", "MB", "GB", "TB", "PB")
    i = int(math.floor(math.log(size_bytes, 1024)))
    p = math.pow(1024, i)
    s = round(size_bytes / p, 2)
    return f"{s} {size_name[i]}"
