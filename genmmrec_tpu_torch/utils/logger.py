"""Logging set-up (counterpart of ``genmmrec_tpu/utils/logger.py``): one
file handler on ``./log/<model>-<dataset>-<time>.log`` and one stream
handler on the root logger, at the level of ``config["state"]``."""

from __future__ import annotations

import logging
import os

from genmmrec_tpu_torch.utils.misc import get_local_time

LEVELS = {
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "error": logging.ERROR,
    "warning": logging.WARNING,
    "critical": logging.CRITICAL,
}


def init_logger(config, main: bool = True) -> None:
    """Replace the root logger's handlers, so that a second call (the next
    run of a grid) leaves one file and one stream handler. A rank other
    than global rank 0 of a mesh (``main`` False) writes no file and logs
    warnings alone."""
    level = LEVELS.get((config["state"] or "info").lower(), logging.INFO)
    fmt = "%(asctime)-15s %(levelname)s %(message)s"
    handlers = []
    if main:
        log_root = "./log/"
        os.makedirs(log_root, exist_ok=True)
        name = f"{config['model'] or 'model'}-{config['dataset'] or 'dataset'}-{get_local_time()}.log"
        fh = logging.FileHandler(os.path.join(log_root, name), "w", "utf-8")
        fh.setLevel(level)
        fh.setFormatter(logging.Formatter(fmt, "%a %d %b %Y %H:%M:%S"))
        handlers.append(fh)
    else:
        level = max(level, logging.WARNING)
    sh = logging.StreamHandler()
    sh.setLevel(level)
    sh.setFormatter(logging.Formatter(fmt, "%d %b %H:%M"))
    handlers.append(sh)

    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    root.setLevel(level)
    for h in handlers:
        root.addHandler(h)
