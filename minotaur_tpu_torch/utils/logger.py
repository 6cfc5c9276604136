"""Leveled logger (reference: src/base/Logger.h:37, Types.h:207-215)."""

from __future__ import annotations

import io
import sys
from typing import TextIO

from .types import LogLevel


class _NullStream(io.TextIOBase):
    def write(self, s: str) -> int:  # noqa: D102
        return len(s)


_NULL = _NullStream()


class Logger:
    """``msg_stream(level)`` returns a writable stream that is a null sink
    when ``level`` is above the configured maximum — same contract as the
    reference's ``Logger::msgStream`` (Logger.h:44)."""

    def __init__(self, max_level: LogLevel = LogLevel.INFO, out: TextIO | None = None):
        self.max_level = LogLevel(max_level)
        self.out = out if out is not None else sys.stdout

    def msg_stream(self, level: LogLevel) -> TextIO:
        return self.out if level <= self.max_level else _NULL  # type: ignore[return-value]

    def log(self, level: LogLevel, msg: str) -> None:
        if level <= self.max_level:
            self.out.write(msg if msg.endswith("\n") else msg + "\n")

    def error(self, msg: str) -> None:
        self.log(LogLevel.ERROR, msg)

    def info(self, msg: str) -> None:
        self.log(LogLevel.INFO, msg)

    def debug(self, msg: str) -> None:
        self.log(LogLevel.DEBUG, msg)
