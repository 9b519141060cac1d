"""The `das` package's logger (reference das/logger.py:3-43).

The port logs through `logging.getLogger("das_tpu_torch")`; `logger()`
returns that logger at the level asked for.  It writes no file: the
caller attaches the handlers it wants."""

import logging


def logger(level: str = "INFO") -> logging.Logger:
    log = logging.getLogger("das_tpu_torch")
    log.setLevel(getattr(logging, level.upper(), logging.INFO))
    return log
