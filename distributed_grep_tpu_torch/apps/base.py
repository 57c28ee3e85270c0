"""Core application type: the intermediate record of Map and Reduce."""

from __future__ import annotations

from typing import NamedTuple


class KeyValue(NamedTuple):
    """One intermediate record emitted by Map and consumed by Reduce.
    Keys are strings (hashed for partitioning, sorted for grouping);
    values are strings."""

    key: str
    value: str
