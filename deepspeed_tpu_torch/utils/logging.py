"""Logger of the port (counterpart of ``deepspeed_tpu/utils/logging.py``,
without the JAX process-index lookup: the port runs one process per card
and reads its rank from ``RANK``)."""

import logging
import os
import sys


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


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` only on the given ranks (None → all)."""
    rank = int(os.environ.get("RANK", 0))
    if ranks is None or rank in ranks or -1 in ranks:
        logger.log(level, f"[Rank {rank}] {message}")
