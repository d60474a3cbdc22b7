"""File + stdout logger (the YOLO trainer is the only reference pipeline
with real logging, *_yolo12n/train.py:185-206; everything else prints).
One logger for the whole framework. A copy of the JAX package's
``utils/logging.py``."""

from __future__ import annotations

import logging
import os
import sys
from datetime import datetime
from typing import Optional


def setup_logger(
    name: str = "mtgseg", log_dir: Optional[str] = None, level: int = logging.INFO
) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        fh = logging.FileHandler(os.path.join(log_dir, f"train_{stamp}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
