"""Core application types: KeyValue and the Application protocol (the
reference's apps/base.py).

An application is any object (usually a module) exposing ``map_fn`` and
``reduce_fn`` (the loader also accepts ``Map``/``Reduce``), plus an
optional ``configure`` hook through which job options reach it.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Protocol, runtime_checkable


class KeyValue(NamedTuple):
    """One intermediate record emitted by Map and consumed by Reduce.
    Keys are strings (hashed for partitioning, sorted for grouping);
    values are strings."""

    key: str
    value: str


@runtime_checkable
class Application(Protocol):
    """The pluggable application boundary (a structural protocol)."""

    def map_fn(self, filename: str, contents: bytes) -> list[KeyValue]:
        """Process one input split; emit intermediate key/value records."""
        ...

    def reduce_fn(self, key: str, values: list[str]) -> str:
        """Fold all values of one key into one output string."""
        ...


def sort_by_key(records: Iterable[KeyValue]) -> list[KeyValue]:
    """Stable sort by key: the grouping's first step."""
    return sorted(records, key=lambda kv: kv.key)


def group_reduce(records: list[KeyValue], reduce_fn) -> dict[str, str]:
    """Sort-merge grouping: one reduce call per distinct key, with its
    values in their original order."""
    out: dict[str, str] = {}
    kva = sort_by_key(records)
    i = 0
    n = len(kva)
    while i < n:
        j = i
        while j < n and kva[j].key == kva[i].key:
            j += 1
        out[kva[i].key] = reduce_fn(kva[i].key,
                                    [kva[k].value for k in range(i, j)])
        i = j
    return out
