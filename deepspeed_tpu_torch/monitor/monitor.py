"""Experiment monitoring (copy of ``deepspeed_tpu/monitor/monitor.py``,
reference ``deepspeed/monitor/monitor.py:24``: ``MonitorMaster`` +
tb/wandb/csv writers).

Writers activate only on rank 0 (``torch.distributed``'s rank where a
process group runs). A writer whose package is missing (``tensorboardX``,
``wandb``) warns and disables itself; the others keep writing.
"""

import csv
import os
from typing import List, Tuple

from deepspeed_tpu_torch.telemetry.sink import process_rank
from deepspeed_tpu_torch.utils.logging import logger


class Monitor:
    def __init__(self, monitor_config):
        self.monitor_config = monitor_config

    def write_events(self, event_list: List[Tuple]):
        raise NotImplementedError


def _is_rank0() -> bool:
    return process_rank() == 0


class TensorBoardMonitor(Monitor):
    def __init__(self, tensorboard_config):
        super().__init__(tensorboard_config)
        self.enabled = tensorboard_config.enabled and _is_rank0()
        self.summary_writer = None
        if self.enabled:
            try:
                from tensorboardX import SummaryWriter

                log_dir = os.path.join(tensorboard_config.output_path or "./runs",
                                       tensorboard_config.job_name)
                self.summary_writer = SummaryWriter(log_dir=log_dir)
            except ImportError:
                logger.warning("tensorboardX not available; disabling "
                               "TensorBoardMonitor")
                self.enabled = False

    def write_events(self, event_list, flush=True):
        if self.enabled and self.summary_writer is not None:
            for event in event_list:
                self.summary_writer.add_scalar(*event)
            if flush:
                self.summary_writer.flush()


class WandbMonitor(Monitor):
    def __init__(self, wandb_config):
        super().__init__(wandb_config)
        self.enabled = wandb_config.enabled and _is_rank0()
        if self.enabled:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=wandb_config.project,
                           group=wandb_config.group,
                           entity=wandb_config.team)
            except ImportError:
                logger.warning("wandb not available; disabling WandbMonitor")
                self.enabled = False

    def write_events(self, event_list):
        if self.enabled:
            for name, value, step in event_list:
                self._wandb.log({name: value}, step=int(step))


class csvMonitor(Monitor):
    def __init__(self, csv_config):
        super().__init__(csv_config)
        self.enabled = csv_config.enabled and _is_rank0()
        self.filenames = {}
        self.output_path = None
        if self.enabled:
            self.output_path = os.path.join(csv_config.output_path or ".",
                                            csv_config.job_name)
            os.makedirs(self.output_path, exist_ok=True)

    def write_events(self, event_list):
        if not self.enabled:
            return
        for name, value, step in event_list:
            fname = os.path.join(self.output_path, name.replace("/", "_") + ".csv")
            new = not os.path.exists(fname)
            with open(fname, "a", newline="") as f:
                w = csv.writer(f)
                if new:
                    w.writerow(["step", name])
                w.writerow([int(step), float(value)])


class MonitorMaster(Monitor):
    """Fans events out to every enabled writer (reference ``monitor.py:24``)."""

    def __init__(self, monitor_config):
        super().__init__(monitor_config)
        self.tb_monitor = TensorBoardMonitor(monitor_config.tensorboard)
        self.wandb_monitor = WandbMonitor(monitor_config.wandb)
        self.csv_monitor = csvMonitor(monitor_config.csv_monitor)
        self.enabled = (self.tb_monitor.enabled or self.wandb_monitor.enabled
                        or self.csv_monitor.enabled)

    def write_events(self, event_list):
        if self.tb_monitor.enabled:
            self.tb_monitor.write_events(event_list)
        if self.wandb_monitor.enabled:
            self.wandb_monitor.write_events(event_list)
        if self.csv_monitor.enabled:
            self.csv_monitor.write_events(event_list)
