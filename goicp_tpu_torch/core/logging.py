"""Leveled, colored, timestamped logger.

Behavioral counterpart of the reference ``Logger`` (``src/common.h:182-268``,
duplicated at ``src/fgoicp/fgoicp_common.hpp:171-256``): Debug/Info/Warning/
Error levels, ANSI colors (blue/green/yellow/red), ``HH:MM:SS`` timestamps.
Implemented on Python's stdlib logging so it composes with pytest/absl.
"""

from __future__ import annotations

import enum
import logging as _pylog
import os
import sys
import time


class LogLevel(enum.IntEnum):
    Debug = 10
    Info = 20
    Warning = 30
    Error = 40


_COLORS = {
    LogLevel.Debug: "\033[34m",   # blue   (common.h:225)
    LogLevel.Info: "\033[32m",    # green  (common.h:229)
    LogLevel.Warning: "\033[33m", # yellow (common.h:233)
    LogLevel.Error: "\033[31m",   # red    (common.h:237)
}
_RESET = "\033[0m"
_NAMES = {
    LogLevel.Debug: "Debug",
    LogLevel.Info: "Info",
    LogLevel.Warning: "Warning",
    LogLevel.Error: "Error",
}


class _Formatter(_pylog.Formatter):
    def __init__(self, color: bool):
        super().__init__()
        self.color = color

    def format(self, record):
        level = LogLevel(min(max(record.levelno // 10 * 10, 10), 40))
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        prefix = f"[{_NAMES[level]} {ts}] "
        msg = record.getMessage()
        if self.color:
            return f"{_COLORS[level]}{prefix}{msg}{_RESET}"
        return prefix + msg


class Logger:
    """Stream-style logger: ``Logger(LogLevel.Info) << "err: " << 0.5`` works,
    as does plain ``log.info("err: %s", 0.5)`` via :func:`get_logger`."""

    def __init__(self, level: LogLevel = LogLevel.Debug):
        self.level = level
        self._parts = []

    def __lshift__(self, msg) -> "Logger":
        self._parts.append(_fmt(msg))
        return self

    def __del__(self):  # flush-on-destruct, like the reference
        try:
            self.flush()
        except Exception:
            pass

    def flush(self):
        if self._parts:
            get_logger().log(int(self.level), "".join(self._parts))
            self._parts = []


def _fmt(msg) -> str:
    import numpy as np

    arr = None
    if hasattr(msg, "shape"):
        arr = np.asarray(msg)
    if arr is not None and arr.shape == (3,):
        return "\t".join(f"{v:.6f}" for v in arr)
    if arr is not None and arr.shape == (3, 3):
        rows = ["\t" + "\t".join(f"{v:.4f}" for v in row) for row in arr]
        return "\n" + "\n".join(rows)
    return str(msg)


_logger = None


def get_logger() -> _pylog.Logger:
    global _logger
    if _logger is None:
        _logger = _pylog.getLogger("goicp_tpu_torch")
        _logger.propagate = False
        # stderr, not stdout: stdout belongs to machine-readable surfaces
        # (the serve.py JSON-lines protocol, bench.py's JSON line); the
        # reference Logger likewise writes std::cerr for Error and keeps
        # human chatter off structured outputs (common.h:235-241)
        h = _pylog.StreamHandler(sys.stderr)
        h.setFormatter(_Formatter(color=sys.stderr.isatty() or bool(os.environ.get("GOICP_COLOR"))))
        _logger.addHandler(h)
        _logger.setLevel(
            getattr(_pylog, os.environ.get("GOICP_LOGLEVEL", "INFO").upper(), _pylog.INFO)
        )
    return _logger
