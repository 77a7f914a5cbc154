"""Logging setup: the port's own copy of `tpu_diffusion/utils/logging.py`
(rebuilds `amortised diffusion/src/utils/log_utils.py:8-59`:
console + timed-rotating-file handlers; the reference also notes a broken
`src.utils.logging` import — this module is the working version of both)."""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional


def setup_logging(name: str = "tpu_diffusion",
                  log_dir: Optional[str] = None,
                  level: int = logging.INFO,
                  rotate_when: str = "H", backup_count: int = 48
                  ) -> logging.Logger:
    """Console handler always; timed-rotating file handler when `log_dir`
    is given. Idempotent (re-calling reconfigures rather than duplicating
    handlers)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s")
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    logger.addHandler(console)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fileh = logging.handlers.TimedRotatingFileHandler(
            os.path.join(log_dir, f"{name}.log"), when=rotate_when,
            backupCount=backup_count)
        fileh.setFormatter(fmt)
        logger.addHandler(fileh)
    logger.propagate = False
    return logger
