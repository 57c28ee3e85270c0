"""Scan fusion: one scan answers K grep queries (the reference's
ops/fuse.py; runtime/fusion.py is the planning half).

A ``FusedScanner`` takes K query specs, builds one union engine, scans
each input once through it (the kernels, cross-file batching and the
corpus cache, unchanged), then gives each query its exact result by
confirming the union's matched lines with that query's own host engine.

The union's lines are a superset of every member's: a line a member
matches matches that member's branch of the alternation; the union folds
case when any member does (more candidates for the others, never fewer);
a set union is the merged set.  Each member's confirm is an exact host
engine (``backend="cpu"``) scanning a slab of the candidate lines only:
slab line i is candidate line i, whole and '\\n'-terminated, so per-line
semantics ('^', '$', empty lines) hold, and the map back to source line
numbers is an index.  Each fused result is therefore the solo scan's.

Only specs no union can host raise ``FuseError`` (the caller then scans
them solo): an empty pattern or member, a backreference, approximate
matching or a mesh, a union the model compiler rejects (its own
ValueError), and on the card a union that no kernel hosts (its engine
routes to a host scanner, mode "native" or "re": a fused scan never runs
on the host where its queries alone would run on the card).  Nothing
else is caught: an error of the union's kernels (a build, a launch, a
result of the wrong shape) fails the scan, as any other scan fails
(ROADMAP.md D7).
"""

from __future__ import annotations

import re as _re
from dataclasses import dataclass

import numpy as np

from distributed_grep_tpu_torch.ops.engine import (
    GrepEngine,
    ScanResult,
    cached_engine,
)
from distributed_grep_tpu_torch.ops.lines import newline_index
from distributed_grep_tpu_torch.utils import lockdep
from distributed_grep_tpu_torch.utils import spans as spans_mod


class FuseError(ValueError):
    """These specs cannot share one union scan: scan them solo."""


@dataclass(frozen=True)
class QuerySpec:
    """One query: exactly one of ``pattern`` (a regex) and ``patterns``
    (literal members, grep -F), and its case flag."""

    pattern: str | None = None
    patterns: tuple[str, ...] | None = None
    ignore_case: bool = False

    @staticmethod
    def normalize(spec) -> "QuerySpec":
        """A QuerySpec, or one made of a (pattern, patterns, ignore_case)
        tuple (runtime/fusion.query_spec's shape)."""
        if isinstance(spec, QuerySpec):
            s = spec
        else:
            pat, pats, ic = spec
            s = QuerySpec(pattern=pat,
                          patterns=tuple(pats) if pats is not None else None,
                          ignore_case=bool(ic))
        if (s.pattern is None) == (s.patterns is None):
            raise FuseError("spec needs exactly one of pattern/patterns")
        if s.pattern is not None and not s.pattern:
            raise FuseError("empty pattern is not fusable")
        if s.patterns is not None and (
                not s.patterns or any(p == "" for p in s.patterns)):
            raise FuseError("empty literal in pattern set is not fusable")
        return s


def union_engine_args(specs: list[QuerySpec]) -> dict:
    """The union engine's construction arguments: literal sets merge into
    one set (first occurrence kept); with any regex member, one
    alternation of ``(?:...)`` branches, literal members ``re.escape``d;
    ``ignore_case`` the OR over the members."""
    ic_any = any(s.ignore_case for s in specs)
    if all(s.patterns is not None for s in specs):
        merged: list[str] = []
        seen: set[str] = set()
        for s in specs:
            for p in s.patterns:
                if p not in seen:
                    seen.add(p)
                    merged.append(p)
        return {"patterns": merged, "ignore_case": ic_any}
    from distributed_grep_tpu_torch.runtime.fusion import has_backref

    branches: list[str] = []
    for s in specs:
        if s.patterns is not None:
            branches.extend(_re.escape(p) for p in s.patterns)
        else:
            if has_backref(s.pattern):
                raise FuseError(f"pattern {s.pattern!r} uses backreferences: "
                                f"it cannot join an alternation")
            branches.append(s.pattern)
    return {"pattern": "(?:" + "|".join(f"(?:{b})" for b in branches) + ")",
            "ignore_case": ic_any}


# ----------------------------------------------------------- counters
# {} while all 0; read by runtime/worker._engine_cache_counters
_fuse_stats_lock = lockdep.make_lock("fuse-stats")
_fuse_stats = {
    "fused_queries": 0,  # queries answered by shared scans
    "fused_dispatches": 0,  # union scan passes that served K >= 2 queries
    "fused_dispatches_saved": 0,  # (K - 1) x those passes
    "fusion_bytes_saved": 0,  # (K - 1) x the bytes each pass scanned once
}


def fusion_counters() -> dict:
    with _fuse_stats_lock:
        if not any(_fuse_stats.values()):
            return {}
        return dict(_fuse_stats)


def fusion_counters_clear() -> None:
    with _fuse_stats_lock:
        for k in _fuse_stats:
            _fuse_stats[k] = 0


def _count_fusion(n_queries: int, dispatches: int, n_bytes: int) -> None:
    if n_queries < 2:
        return
    with _fuse_stats_lock:
        _fuse_stats["fused_queries"] += n_queries
        _fuse_stats["fused_dispatches"] += dispatches
        _fuse_stats["fused_dispatches_saved"] += (n_queries - 1) * dispatches
        _fuse_stats["fusion_bytes_saved"] += (n_queries - 1) * n_bytes


class FusedScanner:
    """K queries, one scan.  Builds the union engine with the shared
    ``engine_opts`` (device, backend, batch_bytes, ...: the planner makes
    the fused jobs agree on them) and an exact host engine a query, all
    through ``cached_engine``."""

    def __init__(self, specs, **engine_opts):
        self.specs = [QuerySpec.normalize(s) for s in specs]
        if not self.specs:
            raise FuseError("no specs")
        if engine_opts.get("mesh") is not None or engine_opts.get(
                "max_errors"):
            raise FuseError("mesh/approx engines are not fusable")
        args = union_engine_args(self.specs)
        try:
            self.union, _verdict = cached_engine(
                args.get("pattern"), patterns=args.get("patterns"),
                ignore_case=args["ignore_case"], **engine_opts)
        except ValueError as e:  # the model compiler refused the union
            raise FuseError(f"union engine construction failed: {e}") from e
        if self.union.backend == "device" and self.union.mode in ("native",
                                                                  "re"):
            # no kernel hosts the union: K solo scans on the card beat
            # one on the host
            raise FuseError(f"the union routes to the host (mode "
                            f"{self.union.mode}): scan the queries solo")
        self.confirms: list[GrepEngine] = []
        try:
            for s in self.specs:
                eng, _ = cached_engine(
                    s.pattern,
                    patterns=list(s.patterns) if s.patterns is not None
                    else None,
                    ignore_case=s.ignore_case, backend="cpu")
                self.confirms.append(eng)
        except ValueError as e:
            raise FuseError(f"confirm engine construction failed: {e}") from e

    def _confirm_all(self, data: bytes, union_res: ScanResult
                     ) -> tuple[list[ScanResult], np.ndarray | None]:
        """Each query's exact result from the union's candidate lines, and
        the newline index used (None when no line was a candidate): the
        candidates gathered into a '\\n'-terminated slab, scanned by each
        query's host engine.  The index is the union result's own where
        it has one."""
        from distributed_grep_tpu_torch.runtime.columnar import (
            gather_ranges,
            line_spans,
        )

        cl = union_res.matched_lines
        n = len(data)
        if cl.size == 0:
            return [ScanResult(np.zeros(0, dtype=np.int64), 0, n)
                    for _ in self.specs], None
        nl = (union_res.nl_index if union_res.nl_index is not None
              else newline_index(data))
        starts, ends = line_spans(cl, nl, n)
        # each line with its '\n' (the last line may have none: the slab
        # scan still counts it, as the source scan does)
        slab, _offsets = gather_ranges(np.frombuffer(data, dtype=np.uint8),
                                       starts, np.minimum(ends + 1, n))
        out: list[ScanResult] = []
        # the confirms are part of the union's scan, as a solo scan's host
        # confirm of its candidates is: they record no scan of their own,
        # so a fused job's routing report names the union's route
        with spans_mod.suspended():
            for eng in self.confirms:
                sub = eng.scan(slab)
                ml = cl[sub.matched_lines - 1].astype(np.int64)
                out.append(ScanResult(ml, int(ml.size), n))
        return out, nl

    def scan(self, data: bytes, progress=None, corpus_key=None
             ) -> list[ScanResult]:
        """One document, K exact results: one union scan (through the
        corpus cache with ``corpus_key``), K slab confirms."""
        union_res = self.union.scan(data, progress=progress,
                                    corpus_key=corpus_key)
        results, _nl = self._confirm_all(data, union_res)
        _count_fusion(len(self.specs), 1, len(data))
        return results

    def scan_suffix(self, path, offset: int = 0, *, final: bool = False,
                    max_bytes: int | None = None):
        """One live-append suffix, K exact results (the fused follow
        tier's scan of a grown file): one union suffix scan with
        ``GrepEngine.scan_file_suffix``'s contract (``offset`` a line
        start, the read cut at its last newline, a partial tail carried),
        then the candidate-slab confirm a query.  Returns ``(results,
        consumed, data)``: a ScanResult a spec with lines 1-based within
        ``data``, the shared cursor advance and the bytes scanned.  Each
        result is the member's own solo ``scan_file_suffix`` over the
        same window, for the reason ``scan``'s are.  The batch fusion
        counters are not touched: the follow tier counts its own wakes
        (runtime/follow.follow_fused_counters)."""
        union_res, consumed, data = self.union.scan_file_suffix(
            path, offset, final=final, max_bytes=max_bytes)
        if consumed == 0:
            return [ScanResult(np.zeros(0, dtype=np.int64), 0, 0)
                    for _ in self.specs], 0, data
        results, _nl = self._confirm_all(data, union_res)
        return results, consumed, data

    def scan_batch(self, items, progress=None, emit=None):
        """Many inputs through the union's packed batching: one scan a
        window serves every query.  ``items`` are (name, bytes or path)
        as for GrepEngine.scan_batch.  Returns a list a spec of
        ``[(name, ScanResult)]`` in input order; ``emit(index, name, data,
        results_per_spec, nl_index)`` is called per input while its bytes
        are in hand (``nl_index``: its newline index when the confirm
        made one, for the K record builds to share)."""
        outs: list[list] = [[] for _ in self.specs]
        pos = [0]
        total_bytes = [0]

        def on_item(name, data, union_res) -> None:
            results, nl = self._confirm_all(data, union_res)
            i = pos[0]
            pos[0] += 1
            total_bytes[0] += len(data)
            for k, res in enumerate(results):
                outs[k].append((name, res))
            if emit is not None:
                emit(i, name, data, results, nl)

        self.union.scan_batch(items, progress=progress, emit=on_item)
        # the union's batch counters are stamped when scan_batch returns
        st = self.union.stats
        dispatches = (int(st.get("batch_dispatches", 0))
                      + int(st.get("solo_dispatches", 0)))
        _count_fusion(len(self.specs), max(1, dispatches), total_bytes[0])
        return outs
