"""Wall-clock and throughput timers (copy of ``deepspeed_tpu/utils/
timer.py``, reference ``deepspeed/utils/timer.py``).

``SynchronizedWallClockTimer`` fences the card at every start and stop
(``torch.cuda.synchronize()``; nothing on the CPU): it is what
``wall_clock_breakdown`` asks for, and the engines create and run it only
then. ``ThroughputTimer`` reports samples a second the same way.
"""

import time

from deepspeed_tpu_torch.utils.logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
BACKWARD_INNER_MICRO_TIMER = "bwd_inner_microstep"
BACKWARD_INNER_GLOBAL_TIMER = "bwd_inner"
BACKWARD_REDUCE_MICRO_TIMER = "bwd_allreduce_microstep"
BACKWARD_REDUCE_GLOBAL_TIMER = "bwd_allreduce"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"


def _device_synchronize():
    """Block until all outstanding device work is complete."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """A single named timer with start/stop/elapsed accumulation."""

    def __init__(self, name, synchronize=True):
        self.name_ = name
        self.synchronize = synchronize
        self.started_ = False
        self.start_time = 0.0
        self.elapsed_ = 0.0
        self.count = 0

    def start(self):
        assert not self.started_, f"{self.name_} timer has already been started"
        if self.synchronize:
            _device_synchronize()
        self.start_time = time.time()
        self.started_ = True

    def stop(self, reset=False, record=False):
        assert self.started_, f"{self.name_} timer is not started"
        if self.synchronize:
            _device_synchronize()
        elapsed = time.time() - self.start_time
        if reset:
            self.elapsed_ = elapsed
        else:
            self.elapsed_ += elapsed
        self.count += 1
        self.started_ = False

    def reset(self):
        self.started_ = False
        self.elapsed_ = 0.0
        self.count = 0

    def elapsed(self, reset=True):
        started = self.started_
        if started:
            self.stop()
        elapsed = self.elapsed_
        if reset:
            self.reset()
        if started:
            self.start()
        return elapsed

    def mean(self):
        return (self.elapsed_ / self.count) if self.count else 0.0


class SynchronizedWallClockTimer:
    """Named-timer registry; every start/stop fences the device."""

    def __init__(self):
        self.timers = {}

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    def get_timers(self):
        return self.timers

    @staticmethod
    def memory_usage():
        import torch

        if not torch.cuda.is_available():
            return "Mem stats unavailable"
        in_use = torch.cuda.memory_allocated() / (1024**3)
        peak = torch.cuda.max_memory_allocated() / (1024**3)
        return f"Mem in-use {in_use:.2f} GB | peak {peak:.2f} GB"

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False, ranks=None):
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                string += f" | {name}: {elapsed_time:.2f}"
        if memory_breakdown:
            string += f" | {self.memory_usage()}"
        log_dist(string, ranks=ranks or [0])

    def get_mean(self, names, normalizer=1.0, reset=True):
        assert normalizer > 0.0
        means = {}
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].mean() * 1000.0 / normalizer
                means[name] = elapsed_time
                if reset:
                    self.timers[name].reset()
        return means


class ThroughputTimer:
    """Samples/sec and tokens/sec over training steps (reference ``ThroughputTimer``)."""

    def __init__(self, batch_size, start_step=2, steps_per_output=50, monitor_memory=False, logging_fn=None):
        self.start_time = 0.0
        self.end_time = 0.0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or log_dist
        self.initialized = False

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def _init_timer(self):
        self.initialized = True

    def start(self):
        self._init_timer()
        self.started = True
        if self.global_step_count >= self.start_step:
            _device_synchronize()
            self.start_time = time.time()

    def stop(self, global_step=False, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        if self.start_time > 0:
            _device_synchronize()
            self.end_time = time.time()
            duration = self.end_time - self.start_time
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            if global_step:
                if report_speed and self.global_step_count % self.steps_per_output == 0:
                    self.logging(
                        f"epoch={self.epoch_count}/micro_step={self.micro_step_count}/"
                        f"global_step={self.global_step_count}, "
                        f"RunningAvgSamplesPerSec={self.avg_samples_per_sec():.6g}, "
                        f"CurrSamplesPerSec={self.batch_size / self.step_elapsed_time:.6g}"
                    )
                self.step_elapsed_time = 0.0

    def avg_samples_per_sec(self):
        if self.global_step_count > self.start_step and self.total_elapsed_time > 0:
            samples = self.batch_size * (self.global_step_count - self.start_step)
            return samples / self.total_elapsed_time
        return float("-inf")
