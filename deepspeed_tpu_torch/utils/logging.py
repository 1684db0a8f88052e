"""Logging (reference ``deepspeed/utils/logging.py``): ``logger`` and
``log_dist``. The port runs as a single process, so every rank filter
resolves to rank 0."""

import logging
import os
import sys

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name, level):
    formatter = logging.Formatter(
        "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d:%(funcName)s] %(message)s")
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(level)
        ch.setFormatter(formatter)
        logger_.addHandler(ch)
    return logger_


logger = _create_logger("DeepSpeedTorch",
                        log_levels.get(os.environ.get("DSTPU_LOG_LEVEL", "info"), logging.INFO))


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` when rank 0 is listed in ``ranks`` (``-1`` = all)."""
    ranks = [-1] if ranks is None else ranks
    if 0 in ranks or -1 in ranks:
        logger.log(level, f"[Rank 0] {message}")
