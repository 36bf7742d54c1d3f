"""Colored, source-located logging macros.

Equivalent of the reference's print layer (`include/print.h:10-24`):
ANSI-colored severity tags with the emitting
``file:line``, plus a level filter the reference lacks (PA_TPU_LOG_LEVEL
= debug | info | message | error; default shows everything but debug).

These are plain host-side prints; drivers log between phases.  A copy of
`privacy_auction_tpu/utils/log.py`, so the PyTorch port imports nothing of
the JAX package.
"""

from __future__ import annotations

import inspect
import os
import sys

_RESET = "\x1b[0m"
_COLORS = {
    "MESSAGE": "\x1b[32m",   # green   (PRINT_MESSAGE, print.h:10)
    "ERROR": "\x1b[31m",     # red     (PRINT_ERROR,   print.h:14)
    "DEBUG": "\x1b[33m",     # yellow  (PRINT_DEBUG,   print.h:18)
    "INFO": "\x1b[36m",      # cyan    (PRINT_INFO,    print.h:22)
}
_LEVELS = {"debug": 0, "info": 1, "message": 2, "error": 3}


def _min_level() -> int:
    return _LEVELS.get(os.environ.get("PA_TPU_LOG_LEVEL", "info"), 1)


def _use_color(stream) -> bool:
    return hasattr(stream, "isatty") and stream.isatty()


def _emit(tag: str, level: int, msg: str, stream=None):
    if level < _min_level():
        return
    stream = stream or (sys.stderr if tag == "ERROR" else sys.stdout)
    frame = inspect.currentframe().f_back.f_back
    loc = f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"
    if _use_color(stream):
        print(f"{_COLORS[tag]}[{tag}] {loc}: {msg}{_RESET}", file=stream)
    else:
        print(f"[{tag}] {loc}: {msg}", file=stream)


def message(msg: str):
    """Protocol-outcome lines (PRINT_MESSAGE)."""
    _emit("MESSAGE", _LEVELS["message"], msg)


def error(msg: str):
    """Failures (PRINT_ERROR); goes to stderr."""
    _emit("ERROR", _LEVELS["error"], msg)


def debug(msg: str):
    """Verbose diagnostics (PRINT_DEBUG); hidden unless
    PA_TPU_LOG_LEVEL=debug."""
    _emit("DEBUG", _LEVELS["debug"], msg)


def info(msg: str):
    """Progress lines (PRINT_INFO)."""
    _emit("INFO", _LEVELS["info"], msg)
