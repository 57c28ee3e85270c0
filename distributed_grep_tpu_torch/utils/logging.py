"""Structured logging: one format and a per-component child logger (the
reference's utils/logging.py).

``get_logger(name)`` is the logger ``distributed_grep_tpu_torch.<name>``.
Library code only logs through it; a handler exists once an entry point
calls ``configure`` (the CLI does when DGREP_LOG names a level), so a
caller that imports the package sees nothing on stderr it did not ask for.
"""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "distributed_grep_tpu_torch"
_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"{_ROOT}.{name}")


def configure(level: str | None = None) -> bool:
    """Send the package's log to stderr at ``level`` (default DGREP_LOG);
    False, and nothing done, when neither names one."""
    level = level or os.environ.get("DGREP_LOG")
    if not level:
        return False
    logging.basicConfig(level=level.upper(), stream=sys.stderr,
                        format=_FORMAT)
    return True
