"""Rotating file and console logger (the port's own copy of
``arflow_tpu/utils/logger.py``)."""

from __future__ import annotations

import logging
import logging.handlers
import os


def init_logger(level="INFO", log_dir="./", log_name="arflow_tpu_torch", filename="main.log"):
    logger = logging.getLogger(log_name)
    logger.handlers.clear()

    os.makedirs(log_dir, exist_ok=True)
    fh = logging.handlers.RotatingFileHandler(
        os.path.join(log_dir, filename), "w", 20 * 1024 * 1024, 5
    )
    fh.setFormatter(
        logging.Formatter(
            "%(asctime)s %(levelname)5s - %(name)s "
            "[%(filename)s line %(lineno)d] - %(message)s",
            datefmt="%m-%d %H:%M:%S",
        )
    )
    logger.addHandler(fh)

    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
    logger.addHandler(sh)

    logger.setLevel(level)
    return logger
