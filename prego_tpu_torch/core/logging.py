"""Console + file logger (reference: step_recognition/utils/logger.py:4-16)."""

from __future__ import annotations

import logging
import os
from typing import Optional


def get_logger(output_path: Optional[str] = None, name: str = "prego_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if not any(isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        console = logging.StreamHandler()
        console.setLevel(logging.INFO)
        console.setFormatter(logging.Formatter("%(asctime)s %(message)s", "%H:%M:%S"))
        logger.addHandler(console)
    if output_path is not None:
        log_file = os.path.join(output_path, "log.txt")
        if not any(isinstance(h, logging.FileHandler) and h.baseFilename == os.path.abspath(log_file)
                   for h in logger.handlers):
            os.makedirs(output_path, exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setLevel(logging.INFO)
            logger.addHandler(fh)
    return logger
