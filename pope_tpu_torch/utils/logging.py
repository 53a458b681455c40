"""Logging, a copy of pope_tpu/utils/logging.py (the reference uses loguru everywhere, e.g. pope_model_api.py:9;
loguru is not in this runtime, so this is a thin stdlib-logging facade with
the same call surface: logger.info/warning/error/debug + stdout+file sinks
like src/logger.py's Logger classes)."""

from __future__ import annotations

import logging
import sys
from typing import Optional

_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s - %(message)s"


def get_logger(name: str = "pope_tpu", log_file: Optional[str] = None, level=logging.INFO):
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(level)
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(sh)
    if log_file and not any(
        isinstance(h, logging.FileHandler) and h.baseFilename == log_file for h in logger.handlers
    ):
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger


logger = get_logger()
