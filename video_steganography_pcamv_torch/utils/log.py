"""x264-style leveled logging (reference: x264_log, common/common.c:591).

Levels mirror X264_LOG_*: NONE(-1) ERROR(0) WARNING(1) INFO(2) DEBUG(3).
The CLI maps --quiet / --verbose / --log-level onto set_level; library
callers log through here instead of bare prints, and fatal conditions
surface as PcamvError (the analog of the reference's negative-return
contract, x264.c:786-790) rather than asserts.
"""

from __future__ import annotations

import sys

LOG_NONE = -1
LOG_ERROR = 0
LOG_WARNING = 1
LOG_INFO = 2
LOG_DEBUG = 3

_NAMES = {LOG_ERROR: "error", LOG_WARNING: "warning",
          LOG_INFO: "info", LOG_DEBUG: "debug"}
_level = LOG_INFO


class PcamvError(Exception):
    """Recoverable library failure (bad params, damaged stream...)."""


def set_level(level: int) -> None:
    global _level
    _level = level


def get_level() -> int:
    return _level


def log(level: int, msg: str) -> None:
    if level <= _level:
        print(f"pcamv [{_NAMES.get(level, '?')}]: {msg}",
              file=sys.stderr)


def error(msg: str) -> None:
    log(LOG_ERROR, msg)


def warning(msg: str) -> None:
    log(LOG_WARNING, msg)


def info(msg: str) -> None:
    log(LOG_INFO, msg)


def debug(msg: str) -> None:
    log(LOG_DEBUG, msg)
