"""Shared structured-logging suite for the CLIs.

Feature parity with the reference's logging flags (scripts/run_pipeline.py:
23-156 and run_dashboard.py:89-182): --log-level, --log-file with 10 MB x 5
rotation, --log-format standard|detailed|json, ANSI colors with --no-color.
"""

from __future__ import annotations

import json
import logging
import sys
from logging.handlers import RotatingFileHandler
from typing import Optional

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[35m",
}
_RESET = "\033[0m"

_FORMATS = {
    "standard": "%(asctime)s %(levelname)s %(name)s: %(message)s",
    "detailed": (
        "%(asctime)s %(levelname)s [%(name)s:%(lineno)d] "
        "(%(funcName)s) %(message)s"
    ),
}

ROTATE_BYTES = 10 * 1024 * 1024
ROTATE_COUNT = 5


class ColoredFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        color = _COLORS.get(record.levelname)
        return f"{color}{msg}{_RESET}" if color else msg


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": self.formatTime(record),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry)


def add_logging_args(parser) -> None:
    parser.add_argument("--log-level", default="INFO",
                        choices=["DEBUG", "INFO", "WARNING", "ERROR"])
    parser.add_argument("--log-file", default=None,
                        help="also log to this file (plain append; --log-rotate adds 10 MB x 5 rotation)")
    parser.add_argument("--log-format", default="standard",
                        choices=["standard", "detailed", "json"])
    parser.add_argument("--log-rotate", action="store_true",
                        help="rotate the log file (10 MB x 5)")
    parser.add_argument("--no-color", action="store_true",
                        help="disable ANSI colors on the console")


def setup_logging(
    level: str = "INFO",
    log_file: Optional[str] = None,
    log_format: str = "standard",
    rotate: bool = True,
    no_color: bool = False,
) -> None:
    root = logging.getLogger()
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.handlers.clear()

    if log_format == "json":
        console_fmt: logging.Formatter = JsonFormatter()
        file_fmt: logging.Formatter = JsonFormatter()
    else:
        pattern = _FORMATS[log_format]
        use_color = (not no_color) and sys.stderr.isatty()
        console_fmt = (ColoredFormatter if use_color else logging.Formatter)(pattern)
        file_fmt = logging.Formatter(pattern)

    console = logging.StreamHandler()
    console.setFormatter(console_fmt)
    root.addHandler(console)

    if log_file:
        if rotate:
            fh: logging.Handler = RotatingFileHandler(
                log_file, maxBytes=ROTATE_BYTES, backupCount=ROTATE_COUNT
            )
        else:
            fh = logging.FileHandler(log_file)
        fh.setFormatter(file_fmt)
        root.addHandler(fh)
