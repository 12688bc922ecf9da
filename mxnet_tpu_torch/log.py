"""Colored logging helper (port of `mxnet_tpu/log.py`; parity:
python/mxnet/log.py — get_logger with a level-colored formatter when the
stream is a TTY)."""
from __future__ import annotations

import logging
import sys

PY3 = True

COLOR = {
    "WARNING": "\033[0;33m", "INFO": "\033[0;32m", "DEBUG": "\033[0;34m",
    "CRITICAL": "\033[0;35m", "ERROR": "\033[0;31m",
}
RESET = "\033[0m"


class _Formatter(logging.Formatter):
    def __init__(self, colored):
        self.colored = colored
        super().__init__(datefmt="%m%d %H:%M:%S")

    def _fmt_for(self, level):
        if self.colored and level in COLOR:
            return (COLOR[level] + "%(levelname).1s%(asctime)s" + RESET +
                    " %(message)s")
        return "%(levelname).1s%(asctime)s %(message)s"

    def format(self, record):
        self._style._fmt = self._fmt_for(record.levelname)
        return super().format(record)


def get_logger(name=None, filename=None, filemode=None, level=None):
    """Return a logger with the mxnet-style colored formatter.

    Parity: log.py:63 getLogger — colors only when logging to a terminal.
    A bare re-get (no level argument) leaves the configured level alone.
    """
    logger = logging.getLogger(name)
    if getattr(logger, "_init_done", False):
        if level is not None:
            logger.setLevel(level)
        return logger
    level = logging.WARNING if level is None else level
    logger._init_done = True
    if filename:
        mode = filemode or "a"
        hdlr = logging.FileHandler(filename, mode)
        colored = False
    else:
        hdlr = logging.StreamHandler(sys.stderr)
        colored = hasattr(sys.stderr, "isatty") and sys.stderr.isatty()
    hdlr.setFormatter(_Formatter(colored))
    logger.addHandler(hdlr)
    logger.setLevel(level)
    return logger


getLogger = get_logger  # reference alias
