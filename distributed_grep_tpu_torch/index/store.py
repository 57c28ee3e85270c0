"""Persistent shard summaries: one file a shard under a root directory
(the reference's index/store.py, on-disk format and names unchanged, so
a store either package wrote is read by the other).

``<root>/<sha256(identity)[:40]>.tgs`` holds a JSON header line (``v``,
``identity``, ``validators``, ``m``) and then the bloom's bytes.  A write
goes to a temporary file and ``os.replace``s it (readers see the old or
the new summary, never a torn one), with no fsync: a lost summary is
built again by the next cold scan.  A load compares identity and
validators with the caller's fresh stat; a record whose validators
differ is stale, deleted, and never served.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from pathlib import Path

_VERSION = 1


def _canon(obj):
    """Tuples to lists, recursively: the shape a header has after JSON."""
    if isinstance(obj, (list, tuple)):
        return [_canon(x) for x in obj]
    return obj


class IndexStore:
    def __init__(self, root):
        self.root = Path(root)
        self._made = False

    def _path_for(self, identity) -> Path:
        blob = json.dumps(_canon(identity), ensure_ascii=True,
                          separators=(",", ":"))
        h = hashlib.sha256(blob.encode("utf-8", "surrogatepass")).hexdigest()
        return self.root / f"{h[:40]}.tgs"

    def load(self, key) -> bytes | None:
        """The stored summary of ``key``, or None; a stale record is
        deleted."""
        p = self._path_for(key.identity)
        try:
            with open(p, "rb") as f:
                header = json.loads(f.readline())
                blob = f.read()
        except (OSError, ValueError):
            return None
        if (header.get("v") != _VERSION
                or header.get("identity") != _canon(key.identity)
                or len(blob) != header.get("m")):
            return None
        if header.get("validators") != _canon(key.validators):
            try:
                os.unlink(p)
            except OSError:
                pass
            return None
        return blob

    def save(self, key, summary: bytes) -> None:
        """Persist ``summary`` under ``key`` atomically; an OSError (a full
        disk) leaves the shard unsummarized and the scan unharmed."""
        p = self._path_for(key.identity)
        header = json.dumps({
            "v": _VERSION,
            "identity": _canon(key.identity),
            "validators": _canon(key.validators),
            "m": len(summary),
        }, ensure_ascii=True, separators=(",", ":"))
        tmp = p.with_name(f".{p.name}.{os.getpid()}.{threading.get_ident()}"
                          f".tmp")
        try:
            if not self._made:
                self.root.mkdir(parents=True, exist_ok=True)
                self._made = True
            with open(tmp, "wb") as f:
                f.write(header.encode("utf-8", "surrogatepass"))
                f.write(b"\n")
                f.write(summary)
            os.replace(tmp, p)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
