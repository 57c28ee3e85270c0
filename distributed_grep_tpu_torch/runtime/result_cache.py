"""The query-result cache, the service's fourth warm tier (the reference's
runtime/result_cache.py).

The engine cache answers "same pattern", the corpus cache "same data",
the shard index "cannot match"; this tier answers "same pattern over the
same data" with the stored result: a repeated query over unchanged inputs
is a stat walk and a cache read, not a scan, and launches no kernel.
Results are stored a map split: the split's final output records with its
content identity.  So invalidation is a split: when one file of a thousand
changes, only its split scans again, and the merge with the cached splits
is byte-identical to a full scan (the keys are unique (file, line) pairs,
so any k-way ``fileline_sorted`` merge is independent of the partition).

Key: ``(fusion_key(config), query_spec(options))`` times the split's
identity.  ``fusion_key`` already folds in the application, every app
option but the query and the split-planning window; the query spec tells
the tenants apart (fusion may run two queries in one scan, their results
are never interchangeable).  The split identity is the corpus cache's
validator tuple (realpath, size, mtime_ns, inode) from a fresh stat: a
changed file evicts its entry, and a stale result is never served.

Persistence (under ``<work_root>/results/``): a file a (query, split),
named by a content hash, a JSON header line and the raw record bytes,
written to a temp file and renamed, without fsync (a lost entry costs a
scan).  A whole-entry LRU keeps the store under ``DGREP_RESULT_BYTES``
(mtime is the recency clock, a load touches it); an entry larger than the
whole budget is declined, never evicting smaller ones.

No scan-stack import: eligibility and planning run on the daemon's control
plane, and every stat or store I/O here runs with no service lock held.

Knobs:

* ``DGREP_RESULT_CACHE``: 0/false/no turns the tier off (no ``results/``
  dir, no /status key).  The daemon has it on; one-shot CLI jobs never
  consult it.
* ``DGREP_RESULT_BYTES``: the store's byte budget (default 256 MiB); 0
  turns the tier off too.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from pathlib import Path

from distributed_grep_tpu_torch.runtime import fusion as fusion_mod
from distributed_grep_tpu_torch.runtime.job import parse_grep_key_bytes

_VERSION = 1
DEFAULT_RESULT_BYTES = 256 << 20


def env_result_cache(default: bool = True) -> bool:
    """DGREP_RESULT_CACHE: on by default; "0", "false" or "no" is off."""
    raw = os.environ.get("DGREP_RESULT_CACHE")
    if raw is None or raw == "":
        return default
    return raw.strip().lower() not in ("0", "false", "no")


def env_result_bytes(default: int = DEFAULT_RESULT_BYTES) -> int:
    """DGREP_RESULT_BYTES, the store's budget (malformed keeps
    ``default``; a negative value is 0, the tier off)."""
    raw = os.environ.get("DGREP_RESULT_BYTES")
    if raw is None or raw == "":
        return default
    try:
        return max(0, int(raw))
    except ValueError:
        return default


def result_key(config) -> tuple | None:
    """The cache key of a JobConfig's query, or None when its results are
    never cached: whatever cannot fuse (fusion.fusion_key gates on the
    port's ``grep_cuda`` application, print mode, no approximate
    matching, mesh, backreference or empty pattern), a standing query
    (no terminal result) and ``-v`` (its output is the complement: every
    line of a file without a match, entries as large as the corpus)."""
    if getattr(config, "follow", False):
        return None
    fkey = fusion_mod.fusion_key(config)
    if fkey is None:
        return None
    opts = config.effective_app_options()
    if opts.get("invert"):
        return None
    qspec = fusion_mod.query_spec(opts)
    if qspec is None:
        return None
    return (fkey, qspec)


def _canon(obj):
    """Tuples to lists and bytes to str (surrogateescape), recursively: a
    stored header equals a live key's fields after one JSON round trip."""
    if isinstance(obj, (list, tuple)):
        return [_canon(x) for x in obj]
    if isinstance(obj, bytes):
        return obj.decode("utf-8", "surrogateescape")
    return obj


class ResultKey:
    """One (query, split) address.  ``identity`` names the entry (the
    query key, the members' given names and their realpaths: stable
    across content changes, so a changed split's lookup finds the same
    entry and evicts it); ``validators`` is the split identity a load
    checks.  The given names matter: stored records carry the publishing
    job's spellings of its paths, so a submit naming the same content
    through another path must miss."""

    __slots__ = ("identity", "validators")

    def __init__(self, query_key: tuple, split, split_ident: tuple):
        members = split if isinstance(split, (list, tuple)) else [split]
        self.identity = (
            _canon(query_key),
            [os.fsdecode(os.fspath(m)) for m in members],
            [m[0] for m in split_ident],
        )
        self.validators = split_ident


class ResultStore:
    """The entries under ``root`` with an LRU byte budget.  Every I/O is
    best effort, with no lock held: a full disk or a lost entry costs a
    scan, never a wrong line."""

    def __init__(self, root):
        self.root = Path(root)
        self._made = False
        # written by the daemon's planning paths only; read unlocked
        self.stale_evictions = 0
        self.lru_evictions = 0
        # temp files a crash left between the write and the rename:
        # _evict counts only *.res, so they would pile up across daemon
        # lifetimes (the store's owner has the work root to itself)
        try:
            with os.scandir(self.root) as it:
                for e in it:
                    if e.name.endswith(".tmp"):
                        try:
                            os.unlink(e.path)
                        except OSError:
                            pass
        except OSError:
            pass

    def _path_for(self, identity) -> Path:
        blob = json.dumps(_canon(identity), ensure_ascii=True,
                          separators=(",", ":"))
        h = hashlib.sha256(blob.encode("utf-8", "surrogatepass")).hexdigest()
        return self.root / f"{h[:40]}.res"

    def load(self, key: ResultKey) -> bytes | None:
        """The stored records of ``key``, or None.  An entry whose
        validators differ from the key's fresh stat is stale: deleted and
        never served.  A hit touches the entry's mtime (the LRU clock)."""
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
            self.stale_evictions += 1
            try:
                os.unlink(p)
            except OSError:
                pass
            return None
        try:
            os.utime(p)
        except OSError:
            pass
        return blob

    def save(self, key: ResultKey, records: bytes) -> bool:
        """Store one split's records (temp file, rename), then keep the
        budget by evicting the oldest entries but this one.  An entry
        larger than the whole budget is declined: storing it would evict
        every smaller entry for a result that could never be kept."""
        budget = env_result_bytes()
        if budget <= 0 or len(records) > budget:
            return False
        p = self._path_for(key.identity)
        header = json.dumps({
            "v": _VERSION,
            "identity": _canon(key.identity),
            "validators": _canon(key.validators),
            "m": len(records),
        }, ensure_ascii=True, separators=(",", ":"))
        tmp = p.with_name(
            f".{p.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            if not self._made:
                self.root.mkdir(parents=True, exist_ok=True)
                self._made = True
            with open(tmp, "wb") as f:
                f.write(header.encode("utf-8", "surrogatepass"))
                f.write(b"\n")
                f.write(records)
            os.replace(tmp, p)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        self._evict(budget, keep=p)
        return True

    def _evict(self, budget: int, keep: Path) -> None:
        """Drop the oldest-mtime entries until the store fits."""
        rows = []
        total = 0
        try:
            with os.scandir(self.root) as it:
                for e in it:
                    if not e.name.endswith(".res"):
                        continue
                    try:
                        st = e.stat()
                    except OSError:
                        continue
                    rows.append((st.st_mtime_ns, st.st_size, e.path))
                    total += st.st_size
        except OSError:
            return
        if total <= budget:
            return
        keep_s = os.fspath(keep)
        for _mtime, size, path in sorted(rows):
            if total <= budget:
                break
            if path == keep_s:
                continue
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= size
            self.lru_evictions += 1


class ResultPlan:
    """One job's cache verdicts at submit: the splits answered from the
    cache (their index and record blob) and those to scan (``remaining``,
    with the identities publication checks again)."""

    __slots__ = ("query_key", "splits", "cached", "remaining",
                 "remaining_identities", "bytes_unscanned")

    def __init__(self, query_key):
        self.query_key = query_key
        self.splits: list = []
        self.cached: list[tuple[int, bytes]] = []
        self.remaining: list = []
        self.remaining_identities: list = []
        self.bytes_unscanned = 0

    @property
    def full(self) -> bool:
        return bool(self.splits) and not self.remaining

    @property
    def splits_reused(self) -> int:
        return len(self.cached)


def plan_lookup(store: ResultStore, query_key: tuple,
                splits: list) -> ResultPlan:
    """Look each planned split up with a fresh stat of its members (a
    changed entry is evicted inside load()).  A split with no identity
    (a member that cannot be statted, or a split too large) always scans
    and is never published."""
    plan = ResultPlan(query_key)
    plan.splits = list(splits)
    for i, split in enumerate(splits):
        ident = fusion_mod.split_identity(split)
        blob = None
        if ident is not None:
            blob = store.load(ResultKey(query_key, split, ident))
        if blob is not None:
            plan.cached.append((i, blob))
            plan.bytes_unscanned += fusion_mod.split_n_bytes(ident)
        else:
            plan.remaining.append(split)
            plan.remaining_identities.append(ident)
    return plan


def bucket_records(output_paths, splits) -> list[bytes] | None:
    """A finished job's committed records split back into one blob a
    split, each sorted by (file, line), so each is itself a
    ``fileline_sorted`` stream for the merge.  None when a record cannot
    be attributed (a key that does not parse, a path no split owns, a
    member listed twice): a job publishes all its splits or none.  Paths
    order by surrogateescape code points, as the merge compares them."""
    owner: dict[bytes, int] = {}
    for i, split in enumerate(splits):
        members = split if isinstance(split, (list, tuple)) else [split]
        for m in members:
            key = os.fsencode(os.fspath(m))
            if key in owner:
                return None
            owner[key] = i
    buckets: list[list] = [[] for _ in splits]
    for path in output_paths:
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        # split at '\n' only, the records' terminator: splitlines would
        # also end a record at a bare '\r' inside a matched line (C12)
        for line in data.split(b"\n"):
            if not line:
                continue
            line += b"\n"
            parsed = parse_grep_key_bytes(line.split(b"\t", 1)[0])
            if parsed is None:
                return None
            path_b, lineno = parsed
            i = owner.get(path_b)
            if i is None:
                return None
            buckets[i].append(
                (path_b.decode("utf-8", "surrogateescape"), lineno, line))
    out = []
    for rows in buckets:
        rows.sort(key=lambda t: (t[0], t[1]))
        out.append(b"".join(t[2] for t in rows))
    return out
