"""Structured logging with a global atomic level (a copy of
``testground_tpu/logging/__init__.py``; reference pkg/logging/log.go:1-111).

The reference wraps zap: a process-global sugared logger (``S()``) with
console encoding and microsecond UTC timestamps. This is that logger over
the stdlib ``logging`` module, as far as the engine's status reporter
uses it; ``TESTGROUND_LOG_LEVEL`` sets its level.
"""

from __future__ import annotations

import logging as _pylog
import os
import sys
import time
from typing import Optional

_LOGGER_NAME = "testground"

_LEVELS = {
    "debug": _pylog.DEBUG,
    "info": _pylog.INFO,
    "warn": _pylog.WARNING,
    "warning": _pylog.WARNING,
    "error": _pylog.ERROR,
    "fatal": _pylog.CRITICAL,
}

_terminal: bool = sys.stderr.isatty() if hasattr(sys.stderr, "isatty") else False


class _ConsoleFormatter(_pylog.Formatter):
    """`LEVEL<tab>Mon _2 15:04:05.000000<tab>msg {k=v ...}` — the reference's
    development console encoding (CapitalColorLevelEncoder + StampMicro UTC)."""

    _COLORS = {
        "DEBUG": "\x1b[35m",
        "INFO": "\x1b[34m",
        "WARNING": "\x1b[33m",
        "ERROR": "\x1b[31m",
        "CRITICAL": "\x1b[31m",
    }
    _RESET = "\x1b[0m"

    def format(self, record: _pylog.LogRecord) -> str:
        ts = time.strftime("%b %d %H:%M:%S", time.gmtime(record.created))
        ts += ".%06d" % int((record.created % 1) * 1e6)
        level = record.levelname
        if _terminal and level in self._COLORS:
            level = f"{self._COLORS[level]}{level}{self._RESET}"
        msg = record.getMessage()
        extra = getattr(record, "kv", None)
        if extra:
            msg += "  " + " ".join(f"{k}={v!r}" for k, v in extra.items())
        return f"{level}\t{ts}\t{msg}"


class Logger:
    """Sugared logger: positional printf-style plus ``kw`` structured fields
    (zap's ``SugaredLogger`` ``Infow``-style calls collapse into kwargs)."""

    def __init__(self, py: _pylog.Logger, kv: Optional[dict] = None) -> None:
        self._py = py
        self._kv = dict(kv or {})

    def _log(self, lvl: int, msg: str, *args, **kw) -> None:
        kv = dict(self._kv)
        kv.update(kw)
        self._py.log(lvl, msg, *args, extra={"kv": kv})

    def debugf(self, msg: str, *args, **kw) -> None:
        self._log(_pylog.DEBUG, msg, *args, **kw)

    def infof(self, msg: str, *args, **kw) -> None:
        self._log(_pylog.INFO, msg, *args, **kw)

    def warnf(self, msg: str, *args, **kw) -> None:
        self._log(_pylog.WARNING, msg, *args, **kw)

    def errorf(self, msg: str, *args, **kw) -> None:
        self._log(_pylog.ERROR, msg, *args, **kw)


def _root() -> _pylog.Logger:
    lg = _pylog.getLogger(_LOGGER_NAME)
    if not lg.handlers:
        h = _pylog.StreamHandler(sys.stderr)
        h.setFormatter(_ConsoleFormatter())
        lg.addHandler(h)
        lg.propagate = False
        lvl = os.environ.get("TESTGROUND_LOG_LEVEL", "info")
        lg.setLevel(_LEVELS.get(lvl.lower(), _pylog.INFO))
    return lg


_global: Optional[Logger] = None


def S() -> Logger:  # noqa: N802 — reference surface name (logging.S())
    """The process-global sugared logger."""
    global _global
    if _global is None:
        _global = Logger(_root())
    return _global
