"""Logger of the port (counterpart of ``deepspeed_tpu/utils/logging.py``,
without the JAX process-index lookup: the port runs one process per card
and reads its rank from ``RANK``)."""

import functools
import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _rank() -> int:
    return int(os.environ.get("RANK", 0))


def create_logger(name="deepspeed_tpu_torch", level=logging.INFO):
    logger_ = logging.getLogger(name)
    if logger_.handlers:
        return logger_
    logger_.setLevel(level)
    logger_.propagate = False
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d:%(funcName)s] "
        "%(message)s"))
    logger_.addHandler(handler)
    return logger_


logger = create_logger()


@functools.lru_cache(None)
def warn_once(msg: str):
    logger.warning(msg)


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` only on the given ranks (None → all)."""
    rank = _rank()
    if ranks is None or rank in ranks or -1 in ranks:
        logger.log(level, f"[Rank {rank}] {message}")


def print_rank_0(message):
    if _rank() == 0:
        print(message, flush=True)


def get_current_level() -> int:
    return logger.getEffectiveLevel()


def should_log_le(max_log_level_str: str) -> bool:
    """True if the logger's effective level is <= the named level."""
    if not isinstance(max_log_level_str, str):
        raise ValueError("max_log_level_str must be a string")
    level = LOG_LEVELS.get(max_log_level_str.lower())
    if level is None:
        raise ValueError(f"Unknown log level: {max_log_level_str}")
    return get_current_level() <= level
