"""The per-segment device pipeline of GrepEngine.scan.

The document is cut into segments of ``engine.segment_bytes`` (a tail of
at most an eighth of that joins the last full segment).  For each:

1. prepare (one-slot feed thread): copy the segment into pinned host
   memory padded with '\\n' as (lanes, chunk) stripes (the document as
   it lies) and start its host-to-device copy on a side stream -- so
   segment i+1 is uploading while segment i scans.  The Shift-And,
   approx, pairset and SWAR kernels read those stripes as they are.  The
   NFA and FDR kernels read the (chunk, lanes) column layout, so for
   their routes the side stream also transposes the upload into it (on
   the card: on the host, a strided copy of the segment costs more than
   the rest of this pipeline, PERF.md); ``transposes`` counts those.  A
   mixed set keeps both: FDR reads the columns, its pairset sidecar the
   stripes;
2. dispatch (scanning thread): wait for the copy, launch the kernel of
   the engine's mode -- the coarse Shift-And kernel with the rare-class
   filter model (or the full model), or the Glushkov NFA kernel with the
   relaxed filter model (or the exact one);
3. collect (two pool threads, overlapping the next segment's scan): fetch
   the nonzero words (ops/scan_torch.py) and decode them.

   Shift-And: words name 32-byte spans; their lines are candidates.  Up to
   SPAN_CONFIRM_LINE_LIMIT candidate lines, the vectorized host matcher
   confirms them; above it (the dense confirm), one exact-mode kernel pass
   over the segment, still on the device, decoded to match-end lines.  If
   the filter model produced mostly false candidates (true lines * 4 <
   candidate lines), the remaining segments of this scan run the full
   model (the defeat guard).  Then the boundary stitch: a match the device
   missed must span one of the segment's stripe starts or the segment
   start, so it lies inside the window of m-1 bytes on either side of that
   boundary (clipped to the boundary's line; m = pattern length), and the
   host checks just those windows and adds what it finds.

   NFA: exact words give match-end offsets, hence lines.  A filter's words
   give candidate lines: up to SPAN_CONFIRM_LINE_LIMIT, the host oracle
   (the DFA walk or re, ops/host_match.py) confirms them; above it, the
   exact NFA kernel runs over the segment on the card when an exact model
   exists (else the host oracle confirms them all), with the same defeat
   guard swapping in the exact model.  Then the stitch by replacement: a
   regex match has no length bound and a '^' pattern sees a false line
   start at every stripe head, so every line containing a stripe start or
   a segment start after 0 gets the host verdict in place of the device
   verdict, once all segments are in (ops/lines.stitch_lines).

   SWAR (``DGREP_SWAR=1``, ``use_swar``): the same Shift-And path with
   the packed kernel (four stripes per uint32, csrc/shift_and_swar.cu) in
   place of the coarse one, its words decoded to the same span starts;
   the lane multiple becomes 128, and the dense confirm keeps the exact
   unpacked kernel; both read the segment's stripes.

   Approx (``max_errors=k``): the kernel's words are exact match ends, so
   collect decodes them to lines with no confirm.  The kernel seeds every
   stripe head with the line-start rows, so each match it reports lies
   inside one line: it reports no false line.  It misses a match only
   where the match's text starts before a stripe or segment start b and
   ends at or after b (the lane from b sees only the text's tail).  That
   text holds at most m + k bytes (m symbols, at most k insertions), so it
   lies inside [b - (m+k-1), b + (m+k-1)), and it holds no '\\n', so also
   inside b's line.  The stitch checks just those windows, clipped to b's
   line, with the host recurrence (``host_match.approx_windows_match``)
   and adds the lines that match: every line it adds is a true line and
   every missed line is found, so the result equals the reference's,
   which replaces the verdict of every boundary line with a per-line
   Python check.

   Literal sets: FDR mode launches one filter kernel per bank, OR'd into
   one word plane, then the pairset sidecar OR'd in; pairset mode one
   exact pairset launch.  Collect decodes the end offsets; FDR candidates
   are confirmed against the WHOLE document (ops/confirm_set.py), so a
   member reaching back across the segment start still confirms; pairset
   words are exact.  Then an offset-exact stitch: FDR seeds prev = 0 at
   every stripe head and so misses a true match only where it ends at b+1
   .. b+m after a stripe or segment start b (m the bank's slots); pairset
   seeds prev = '\\n' and misses only at b+1.  The confirm set checks those
   end offsets (``engine.stitch_window``) and their lines are added;
   neither kernel can give a false line, so nothing is removed.

Corpus cache (ops/layout.CorpusCache): a scan given a content key
(``corpus_key``) under a budget (``eng._corpus_budget()``) takes its
segments' stripes from the cache when they are resident -- no pad, no
pinned copy, no upload; the NFA and FDR routes still transpose them on
the card -- and otherwise keeps the stripes it uploads and publishes them
once the whole scan has succeeded.  An input whose padded segments exceed
the budget is not cached at all.  ``uploads`` counts the segments a scan
uploaded, ``resident_segments`` those it took from the cache.

Table DFA (mode "dfa", a mesh engine's pattern outside the kernel
subset): each table's exact words, K1's or, where the engine's
``dfa_plans`` composed a stride table, K2's, OR'd; collected and stitched
as the NFA's exact words (the replacing stitch, since a '$' accept at a
stripe's end counts the stripe's last byte as followed by '\n').

The cards: off a mesh, segment i goes to the engine's device i mod n
(``devices``), each card with a prepare slot of its own (its side stream
for the copy), two segments a card in flight, and collect threads as the
reference sizes them (its device_scan.py:776; the port's two at the
least).  On a mesh, each segment's stripes split into one contiguous
block of rows an entry, copied on that entry's card's side stream (and
transposed there for the NFA and FDR kernels, one transpose a segment in
``transposes``); the route's kernel runs on every block, the words come
back in lane order, and ``psum_candidates`` sums the blocks' nonzero-word
counts over the scan (parallel/sharded_kernels.py).  The dense confirms
run sharded too.  Mode "dfa" has no sharded kernel: it scans on the
mesh's first entry (``mesh_unsharded``).  With the engine's
``pattern_axis``, an FDR set of same-plan banks copies each lane block
to every entry along that axis, entry (i, j) runs bank run j, and the
words are OR'd across the axis (``sharded_fdr_pattern_step``); a mixed
set's pairset sidecar runs lane-sharded beside it and is OR'd in.  On a
mesh spanning processes every rank runs this pipeline over the same
input and each segment is collected before the next dispatches, so the
ranks' collectives come in one order.

Segments can be collected in any order.  A build, launch or CUDA failure
raises: nothing falls back to another route, entry or card.  Before its first segment a
scan on the card builds the route's libraries that have no build yet
(ops/_build.py), and first declares that silent time to the progress
callback as a grace of BUILD_GRACE_S, so a task's failure detector does
not re-issue a task that is compiling.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from distributed_grep_tpu_torch.models.dfa import StrideTable
from distributed_grep_tpu_torch.models.shift_and import swar_values
from distributed_grep_tpu_torch.ops import (
    _build,
    approx_scan,
    cuda_scan,
    dfa_scan,
    fdr_scan,
    nfa_scan,
    pairset_scan,
    swar_scan,
)
from distributed_grep_tpu_torch.ops import engine as engine_mod
from distributed_grep_tpu_torch.ops import layout as layout_mod
from distributed_grep_tpu_torch.ops import lines as lines_mod
from distributed_grep_tpu_torch.ops.layout import (
    COLUMNS,
    STRIPES,
    choose_layout,
)
from distributed_grep_tpu_torch.ops.fdr_scan import or_into
from distributed_grep_tpu_torch.ops.scan_torch import sparse_nonzero
from distributed_grep_tpu_torch.parallel import sharded_kernels as shk
from distributed_grep_tpu_torch.utils import lockdep
from distributed_grep_tpu_torch.utils import spans as spans_mod
from distributed_grep_tpu_torch.ops.sparse import (
    offsets_from_sparse_words,
    span_starts_from_packed_words,
    span_starts_from_sparse_words,
)

log = logging.getLogger("distributed_grep_tpu_torch.device_scan")

MAX_INFLIGHT = 2  # segments a card dispatched but not yet collected

# The silent time a scan declares before it builds its route's libraries
# (nvcc takes about a minute for csrc/nfa.cu, seconds for the others).
BUILD_GRACE_S = 180.0

# Segments transposed into the column layout (on the card, or on the host
# for a CPU engine): incremented once per transpose, nowhere else.
# chip_smoke.py reads it around each query: 0 on the Shift-And, approx,
# pairset and SWAR routes, one per segment on the NFA and FDR routes.
_count_lock = threading.Lock()
transposes = 0


def reset_transposes() -> None:
    global transposes
    with _count_lock:
        transposes = 0


def _count_transpose() -> None:
    global transposes
    with _count_lock:
        transposes += 1


def kernel_launches() -> dict[str, int]:
    """Each scan kernel's launch count in this process, by library; K2
    (csrc/dfa.cu's stride kernel) as "dfa_stride"."""
    out = {m.LIBRARY: m.launches for m in (
        cuda_scan, nfa_scan, fdr_scan, pairset_scan, approx_scan, swar_scan,
        dfa_scan)}
    out["dfa_stride"] = dfa_scan.stride.launches
    return out

# The SWAR route's lane multiple: 4 stripes per packed uint32 element and
# 32 elements per warp (the kernel's blocks own 256 lanes and take a
# ragged last block; 65536 lanes fill every block).
SWAR_LANE_MULTIPLE = 128


def use_swar(eng) -> bool:
    """The reference's SWAR rule (its device_scan.py:313-328): enabled
    (``DGREP_SWAR=1``, read now), a Shift-And engine, and both the full
    model and the rare-class filter ``swar_values``-eligible -- the defeat
    guard swaps one for the other mid-scan, on the same packed layout."""
    return (eng.mode == "shift_and" and swar_scan.swar_enabled()
            and swar_values(eng.shift_and) is not None
            and (eng._sa_filtered is None
                 or swar_values(eng._sa_filtered) is not None))


def _expand_line_ranges(l0: np.ndarray, l1: np.ndarray) -> np.ndarray:
    """Sorted unique union of the inclusive line ranges [l0[i], l1[i]]."""
    counts = l1 - l0 + 1
    base = np.repeat(l0 - np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
    return np.unique(base + np.arange(int(counts.sum()), dtype=np.int64))


def scan_device(eng, data: bytes, progress=None, corpus_key=None):
    t_wall0 = time.perf_counter()
    nfa = eng.mode == "nfa"
    dfa = eng.mode == "dfa"
    lit_set = eng.mode in ("fdr", "pairset")
    approx = eng.mode == "approx"
    swar = use_swar(eng)
    # the cards: a mesh shards each segment's lanes over its entries
    # (parallel/sharded_kernels.py); else segments round-robin over the
    # engine's devices.  The table DFA has no sharded kernel: on a mesh
    # it scans on the first entry, as the reference's scans on its
    # default device, logged and counted (``mesh_unsharded``)
    mesh = eng.mesh
    if mesh is not None and dfa:
        log.warning("mesh requested but mode %r has no sharded kernel -- "
                    "scanning on the mesh's first entry %s", eng.mode,
                    eng.device)
        mesh = None
    devs = [eng.device] if eng.mesh is not None else list(eng.devices)
    # the pattern axis: a set's same-plan FDR banks shard over it, lanes
    # over ``mesh_axis``; mixed-plan banks shard lanes alone (the
    # reference's device_scan.py:401-410)
    ep_axis = None
    if mesh is not None and eng.mode == "fdr" and eng.pattern_axis:
        if not shk.same_plan(eng.fdr.banks):
            log.info("mixed-plan FDR banks: pattern-parallel sharding "
                     "unavailable — lanes shard over the full mesh instead")
        else:
            ep_axis = eng.pattern_axis
    # the kernel modules this route launches, its dense confirm included;
    # each segment is prepared in the layouts they read (their LAYOUT)
    if dfa:
        kernels = [dfa_scan]
    elif eng.mode == "fdr":
        kernels = [fdr_scan] + ([pairset_scan] if eng.fdr_pairset is not None
                                else [])
    elif eng.mode == "pairset":
        kernels = [pairset_scan]
    elif nfa:
        kernels = [nfa_scan]
    elif approx:
        kernels = [approx_scan]
    else:
        kernels = [cuda_scan] + ([swar_scan] if swar else [])
    layouts = {k.LAYOUT for k in kernels}
    st = {"candidates": 0, "segments": 0, "uploads": 0,
          "resident_segments": 0, "feed_wait_seconds": 0.0, "prepare_seconds": 0.0,
          "collect_seconds": 0.0, "confirm_seconds": 0.0,
          "stitch_seconds": 0.0}
    if lit_set:
        st.update(stitch_offsets=0)
    elif dfa:
        st.update(stitch_lines=0, mesh_unsharded=eng.mesh is not None)
    elif nfa:
        st.update(dense_confirms=0, stitch_lines=0, nfa_filter_defeated=False)
    elif approx:
        st.update(stitch_windows=0)
    else:
        st.update(dense_confirms=0, stitch_windows=0, filter_defeated=False,
                  swar=swar)
    eng.stats = st
    n = len(data)
    view = memoryview(data)
    nl = lines_mod.newline_index(data)
    device = eng.device
    on_cuda = device.type == "cuda"
    todo = _build.unbuilt([k.LIBRARY for k in kernels], device)
    if todo:
        if progress is not None:
            progress(grace_s=BUILD_GRACE_S)
        _build.build_all(tuple(todo))
    full = eng.shift_and
    lay_kwargs = eng.layout_kwargs()
    if swar:
        lay_kwargs["lane_multiple"] = SWAR_LANE_MULTIPLE
    if mesh is not None:
        # whole lane tiles an entry; the lanes the engine asks for at least
        mult = shk.mesh_lane_multiple(mesh, eng.mesh_axis, swar)
        lay_kwargs["lane_multiple"] = mult
        lay_kwargs["target_lanes"] = max(lay_kwargs["target_lanes"], mult)
        psum: list = []  # each segment's summed nonzero-word count
    # bytes a match missed at a boundary b can reach past it on either
    # side: m - 1 for Shift-And, m + k - 1 for approx (module docstring)
    reach = (eng.approx.length + eng.approx.k - 1 if approx
             else full.length - 1 if full is not None else 0)
    seg = eng.segment_bytes
    seg_starts = list(range(0, n, seg))
    # a short tail joins the segment before it: a segment of a few bytes
    # still pays a whole prepare, launch and collect (a file's last
    # scan_file chunk is a full block after the tail line carried into it)
    if len(seg_starts) > 1 and n - seg_starts[-1] <= seg // 8:
        seg_starts.pop()
    seg_ends = seg_starts[1:] + [n]
    # the corpus cache: resident stripes in place of the upload, or the
    # uploaded stripes kept and published after the scan (module docstring)
    resident = None
    corpus_put = None
    built: list = []  # (seg_start, Layout, stripes tensor), a segment each
    if corpus_key is not None and n > 0 and mesh is None:
        budget = eng._corpus_budget()
        padded = sum(choose_layout(e - s_, **lay_kwargs).padded
                     for s_, e in zip(seg_starts, seg_ends))
        if 0 < budget and padded <= budget:
            cache = layout_mod.corpus_cache()
            sig = (seg, tuple(sorted(lay_kwargs.items())))
            resident = cache.resident_segments(corpus_key, sig)
            if resident is not None and [r[0] for r in resident] != seg_starts:
                resident = None
            if resident is None:
                corpus_put = (cache, sig, budget)
            spans_mod.instant(
                f"corpus:{'hit' if resident is not None else 'miss'}",
                cat="engine", bytes=n)
    lock = lockdep.make_lock("device-scan-state")
    # scan-local models, swapped by the defeat guards: the Shift-And
    # filter is dropped, the NFA filter gives way to the exact model
    scan_state = {"filtered": eng._sa_filtered,
                  "nfa": (eng.glushkov, eng._nfa_filter)}
    found: list[np.ndarray] = []
    suspects: list[np.ndarray] = []  # NFA: boundary lines and their
    verdicts: list[np.ndarray] = []  # host verdicts, replaced at the end
    stitch_found: list[np.ndarray] = []  # sets, approx: lines the stitch added

    def prepare(i: int):
        t0 = time.perf_counter()
        try:
            return _prepare(i)
        finally:
            with lock:
                st["prepare_seconds"] += time.perf_counter() - t0

    def _prepare(i: int):
        """Segment i as (start, length, layout, views, ready, stripes):
        ``views`` one dict layout -> tensor an entry (one, off a mesh),
        ``ready`` the (device, copy event) pairs the scan waits for,
        ``stripes`` the uploaded segment (None on a mesh)."""
        seg_start = seg_starts[i]
        seg_len = seg_ends[i] - seg_start
        if resident is not None:  # warm: on the card already
            _start, lay, stripes = resident[i]
            return (seg_start, seg_len, lay, [segment_views(stripes)], [],
                    stripes)
        seg_view = view[seg_start : seg_ends[i]]
        lay = choose_layout(seg_len, **lay_kwargs)
        with lock:
            st["uploads"] += 1
        if not on_cuda:
            stripes = torch.from_numpy(layout_mod.padded_stripes(seg_view,
                                                                 lay))
            if mesh is not None:
                return (seg_start, seg_len, lay, mesh_views(stripes), [],
                        None)
            return (seg_start, seg_len, lay, [segment_views(stripes)], [],
                    stripes)
        host = torch.empty((lay.lanes, lay.chunk), dtype=torch.uint8,
                           pin_memory=True)
        layout_mod.padded_stripes(seg_view, lay, out=host.numpy())
        if mesh is not None:
            entries = mesh_views(host)
            ready = []
            for dev in entries.local_devices():
                ev = torch.cuda.Event()
                ev.record(eng.copy_stream(dev))
                ready.append((dev, ev))
            return seg_start, seg_len, lay, entries, ready, None
        dev = devs[i % len(devs)]
        side = eng.copy_stream(dev)
        with torch.cuda.stream(side):
            stripes = host.to(dev, non_blocking=True)
            views = segment_views(stripes)
            ready = torch.cuda.Event()
            ready.record(side)
        return seg_start, seg_len, lay, [views], [(dev, ready)], stripes

    def segment_views(stripes: torch.Tensor) -> dict:
        """Layout -> the segment in it, for the layouts of ``kernels``."""
        views = {STRIPES: stripes} if STRIPES in layouts else {}
        if COLUMNS in layouts:
            views[COLUMNS] = stripes.t().contiguous()
            _count_transpose()
        return views

    def mesh_views(stripes: torch.Tensor) -> list[dict]:
        """The segment's entries on the mesh (``shk.prepare_tiles``: each
        entry's rows copied to its card on that card's side stream, and
        transposed there for the NFA and FDR kernels: one transpose a
        segment in the count)."""
        entries = shk.prepare_tiles(
            stripes, mesh, eng.mesh_axis, tuple(layouts),
            stream_for=eng.copy_stream if on_cuda else None, swar=swar,
            pattern_axis=ep_axis)
        if COLUMNS in layouts:
            _count_transpose()
        return entries

    def on_views(views: list[dict], fn, count: bool = False):
        """``fn(views)`` on the segment: on its one device, or on each
        mesh entry and reassembled in lane order (``count``: the
        entries' nonzero-word counts join ``psum``)."""
        if mesh is None:
            return fn(views[0])
        words, total = shk.sharded_words(views, fn)
        if count:
            with lock:
                psum.append(total)
        return words

    def pattern_words(views):
        """The pattern axis's candidate words: the banks' runs over
        ``ep_axis`` (``shk.sharded_fdr_pattern_step``), a mixed set's
        pairset sidecar OR'd in lane-sharded (the reference's
        device_scan.py:863-878); the union's nonzero words join
        ``psum``."""
        words, _total = shk.sharded_fdr_pattern_step(
            views, eng.fdr, mesh, eng.mesh_axis, ep_axis,
            fold_case=eng.ignore_case, tabs_dev=eng._fdr_ep_tables(ep_axis))
        if eng.fdr_pairset is not None:
            pw, _ = shk.sharded_pairset_words(views.lanes_only(),
                                              eng.fdr_pairset, mesh,
                                              eng.mesh_axis)
            or_into(words, pw)
        with lock:
            psum.append(torch.count_nonzero(words.view(torch.int32)))
        return words

    confirm_active = [0]  # live confirm legs; the peak goes to the stats

    def confirming(fn, *args):
        """``fn(*args)``, a confirm leg, counted while it runs: legs of
        different segments overlap on the collect pool
        (``confirm_concurrency_peak``)."""
        with lock:
            confirm_active[0] += 1
            if confirm_active[0] > st.get("confirm_concurrency_peak", 0):
                st["confirm_concurrency_peak"] = confirm_active[0]
        try:
            return fn(*args)
        finally:
            with lock:
                confirm_active[0] -= 1

    def confirm(cand: np.ndarray) -> np.ndarray:
        starts, ends = lines_mod.line_spans(cand, nl, n)
        return cand[confirming(eng.host_line_matcher, data, starts, ends)]

    def stitch(bounds: np.ndarray) -> np.ndarray:
        at = np.searchsorted(nl, bounds, side="right") + 1
        ls, le = lines_mod.line_spans(at, nl, n)
        keep = eng.host_line_matcher(data, np.maximum(ls, bounds - reach),
                                     np.minimum(le, bounds + reach))
        return np.unique(at[keep])

    def collect(kind: str, *job) -> None:
        t0 = time.perf_counter()
        try:
            if lit_set:
                _collect_set(kind, *job)
            elif nfa or dfa:
                _collect_nfa(kind, *job)
            elif approx:
                _collect_approx(*job)
            else:
                _collect(kind, *job)
        finally:
            with lock:
                st["collect_seconds"] += time.perf_counter() - t0

    def segment_bounds(seg_start: int, seg_len: int, lay) -> np.ndarray:
        """The segment's stripe starts, and its start after offset 0."""
        bounds = seg_start + lay.stripe_starts()
        bounds = bounds[bounds < seg_start + seg_len]
        if seg_start > 0:
            bounds = np.concatenate(([seg_start], bounds))
        return bounds

    def _collect(kind, seg_start: int, seg_len: int, lay, views,
                 words) -> None:
        idx, vals = sparse_nonzero(words)
        spans = (span_starts_from_packed_words(idx, vals, lay)
                 if kind == "span_words_packed"
                 else span_starts_from_sparse_words(idx, lay))
        new: list[np.ndarray] = []
        n_cand = 0
        dense = False
        t0 = time.perf_counter()
        if spans.size:
            g0 = spans + seg_start
            g1 = np.minimum(g0 + 32, n)
            cand = _expand_line_ranges(
                lines_mod.line_of_offsets(g0 + 1, nl),
                lines_mod.line_of_offsets(g1, nl),
            )
            n_cand = int(cand.size)
            if n_cand > engine_mod.SPAN_CONFIRM_LINE_LIMIT:
                # dense confirm: exact end bits of the FULL model, on device
                dense = True
                exact = on_views(views, lambda v: cuda_scan.shift_and_scan_words(
                    v[cuda_scan.LAYOUT], full, coarse=False))
                e_idx, e_vals = sparse_nonzero(exact)
                offs = offsets_from_sparse_words(e_idx, e_vals, lay)
                true_lines = lines_mod.unique_match_lines(offs + seg_start, nl)
                new.append(true_lines)
            else:
                new.append(confirm(cand))
        t1 = time.perf_counter()
        bounds = segment_bounds(seg_start, seg_len, lay)
        new.append(stitch(bounds))
        t2 = time.perf_counter()
        with lock:
            found.extend(new)
            st["candidates"] += n_cand
            st["confirm_seconds"] += t1 - t0
            st["stitch_seconds"] += t2 - t1
            st["stitch_windows"] += int(bounds.size)
            if dense:
                st["dense_confirms"] += 1
                if (scan_state["filtered"] is not None
                        and new[0].size * 4 < n_cand):
                    # mostly-false candidates: this corpus defeats the
                    # filter's byte prior -- the remaining segments of
                    # THIS scan run the full model
                    scan_state["filtered"] = None
                    st["filter_defeated"] = True

    def _collect_approx(seg_start: int, seg_len: int, lay, views,
                        words) -> None:
        idx, vals = sparse_nonzero(words)
        lines = lines_mod.unique_match_lines(
            offsets_from_sparse_words(idx, vals, lay) + seg_start, nl)
        t1 = time.perf_counter()
        bounds = segment_bounds(seg_start, seg_len, lay)
        added = stitch(bounds)
        t2 = time.perf_counter()
        with lock:
            found.append(lines)
            stitch_found.append(added)
            st["stitch_seconds"] += t2 - t1
            st["stitch_windows"] += int(bounds.size)

    def _collect_set(kind, seg_start: int, seg_len: int, lay, views,
                     words) -> None:
        idx, vals = sparse_nonzero(words)
        offs = offsets_from_sparse_words(idx, vals, lay) + seg_start
        n_cand = 0
        t0 = time.perf_counter()
        if kind == "cand_words":  # FDR: confirm every candidate end
            n_cand = int(offs.size)
            offs = offs[confirming(eng.confirm.confirm, data, offs)]
        lines = lines_mod.unique_match_lines(offs, nl)
        t1 = time.perf_counter()
        bounds = segment_bounds(seg_start, seg_len, lay)
        ends = np.unique((bounds[:, None] + np.arange(
            1, eng.stitch_window, dtype=np.int64)[None, :]).reshape(-1))
        ends = ends[ends <= n]
        added = lines_mod.unique_match_lines(
            ends[eng.confirm.confirm(data, ends)], nl)
        t2 = time.perf_counter()
        with lock:
            found.append(lines)
            stitch_found.append(added)
            st["candidates"] += n_cand
            st["confirm_seconds"] += t1 - t0
            st["stitch_seconds"] += t2 - t1
            st["stitch_offsets"] += int(ends.size)

    def _collect_nfa(kind, seg_start: int, seg_len: int, lay, views,
                     words) -> None:
        idx, vals = sparse_nonzero(words)
        offs = offsets_from_sparse_words(idx, vals, lay) + seg_start
        n_cand = 0
        dense = False
        t0 = time.perf_counter()
        if kind == "words" or not offs.size:  # exact words
            lines = lines_mod.unique_match_lines(offs, nl)
        else:  # a filter's words: candidate lines
            cand = lines_mod.unique_match_lines(offs, nl)
            n_cand = int(cand.size)
            exact = eng.glushkov_exact
            if n_cand > engine_mod.SPAN_CONFIRM_LINE_LIMIT and exact is not None:
                # dense confirm: exact end bits of the exact model, on device
                dense = True
                e_idx, e_vals = sparse_nonzero(on_views(
                    views, lambda v: nfa_scan.nfa_scan_words(
                        v[nfa_scan.LAYOUT], exact)))
                lines = lines_mod.unique_match_lines(
                    offsets_from_sparse_words(e_idx, e_vals, lay) + seg_start,
                    nl)
            else:
                lines = confirm(cand)
        t1 = time.perf_counter()
        sus = lines_mod.boundary_lines(segment_bounds(seg_start, seg_len, lay),
                                       nl, n)
        ls, le = lines_mod.line_spans(sus, nl, n)
        ver = eng.host_line_matcher(data, ls, le)
        t2 = time.perf_counter()
        with lock:
            found.append(lines)
            suspects.append(sus)
            verdicts.append(ver)
            st["candidates"] += n_cand
            st["confirm_seconds"] += t1 - t0
            st["stitch_seconds"] += t2 - t1
            st["stitch_lines"] += int(sus.size)
            if dense:
                st["dense_confirms"] += 1
                if scan_state["nfa"][1] and lines.size * 4 < n_cand:
                    # mostly-false candidates: this corpus defeats the
                    # relaxed filter -- the remaining segments of THIS
                    # scan run the exact model
                    scan_state["nfa"] = (eng.glushkov_exact, False)
                    st["nfa_filter_defeated"] = True

    # one prepare slot a card (one on a mesh: its segments go to every
    # entry), collect threads as the reference sizes them (two on a mesh,
    # the card count up to 4 otherwise; the port's two at the least), and
    # two segments a card in flight
    n_cards = len({str(d) for d in devs}) if mesh is None else 1
    n_collect = 2 if mesh is not None else min(4, max(2, n_cards))
    max_inflight = MAX_INFLIGHT * n_cards
    if mesh is not None and mesh.n_ranks > 1:
        # a mesh over processes: every rank issues its collectives in one
        # order, so a segment's collect (a dense confirm gathers too)
        # ends before the next segment dispatches
        max_inflight = 0
    with ThreadPoolExecutor(n_cards, thread_name_prefix="dgrep-feed") as feed, \
            ThreadPoolExecutor(n_collect,
                               thread_name_prefix="dgrep-collect") as pool:
        ahead = deque(feed.submit(prepare, j)
                      for j in range(min(n_cards, len(seg_starts))))
        pending: deque = deque()
        for i in range(len(seg_starts)):
            t0 = time.perf_counter()
            seg_start, seg_len, lay, views, ready, stripes = (
                ahead.popleft().result())
            st["feed_wait_seconds"] += time.perf_counter() - t0
            if i + n_cards < len(seg_starts):
                ahead.append(feed.submit(prepare, i + n_cards))
            if on_cuda:
                for dev, ev in ready:
                    torch.cuda.current_stream(dev).wait_event(ev)
                for t in [stripes] + [t for v in views if v is not None
                                      for t in v.values()]:
                    if t is not None:
                        t.record_stream(torch.cuda.current_stream(t.device))
            if resident is not None:
                st["resident_segments"] += 1
            elif corpus_put is not None:
                built.append((seg_start, lay, stripes))
            with lock:  # the model and its kind together
                model, is_filter = scan_state["nfa"]
                sa_model = scan_state["filtered"] or full
            if dfa:
                def fn(v):
                    words = None
                    for plan in eng.dfa_plans():
                        words = or_into(words, (
                            dfa_scan.dfa_stride_words(v[dfa_scan.LAYOUT],
                                                      plan)
                            if isinstance(plan, StrideTable)
                            else dfa_scan.dfa_scan_words(v[dfa_scan.LAYOUT],
                                                         plan)))
                    return words
                kind = "words"
            elif ep_axis is not None:
                fn = None
                kind = "cand_words"
            elif eng.mode == "fdr":
                def fn(v):
                    words = None
                    for bank in eng.fdr.banks:
                        words = fdr_scan.fdr_scan_words(
                            v[fdr_scan.LAYOUT], bank,
                            fold_case=eng.ignore_case, out=words)
                    if eng.fdr_pairset is not None:
                        words = pairset_scan.pairset_scan_words(
                            v[pairset_scan.LAYOUT], eng.fdr_pairset,
                            out=words)
                    return words
                kind = "cand_words"
            elif eng.mode == "pairset":
                def fn(v):
                    return pairset_scan.pairset_scan_words(
                        v[pairset_scan.LAYOUT], eng.pairset)
                kind = "words"
            elif nfa:
                def fn(v, model=model):
                    return nfa_scan.nfa_scan_words(v[nfa_scan.LAYOUT], model)
                kind = "cand_words" if is_filter else "words"
            elif approx:
                def fn(v):
                    return approx_scan.approx_scan_words(
                        v[approx_scan.LAYOUT], eng.approx)
                kind = "words"
            elif swar:
                def fn(v, sa_model=sa_model):
                    return swar_scan.swar_scan_words(v[swar_scan.LAYOUT],
                                                     sa_model)
                kind = "span_words_packed"
            else:
                def fn(v, sa_model=sa_model):
                    return cuda_scan.shift_and_scan_words(
                        v[cuda_scan.LAYOUT], sa_model, coarse=True)
                kind = "span_words"
            if fn is None:
                words = pattern_words(views)
            else:
                words = on_views(views, fn, count=True)
            st["segments"] += 1
            pending.append(pool.submit(collect, kind, seg_start, seg_len, lay,
                                       views, words))
            while len(pending) > max_inflight:
                pending.popleft().result()
            if progress is not None:
                progress()
        while pending:
            pending.popleft().result()
            if progress is not None:
                progress()

    if corpus_put is not None:  # the whole scan succeeded: publish
        cache, sig, budget = corpus_put
        cache.put_segments(corpus_key, sig, data, built, budget)
    if mesh is not None:
        # the candidate tally over every segment: the sum of each
        # entry's nonzero-word count (the reference's psum)
        st["psum_candidates"] = sum(int(t) for t in psum)
    lines_arr = (np.unique(np.concatenate(found)).astype(np.int64)
                 if found else np.zeros(0, dtype=np.int64))
    if (nfa or dfa) and suspects:
        sus, ver = np.concatenate(suspects), np.concatenate(verdicts)
        stitched = lines_mod.stitch_lines(lines_arr, sus, ver).astype(np.int64)
        # device verdicts the stitch overturned, in each direction
        st["stitch_removed"] = int(np.setdiff1d(lines_arr, stitched).size)
        st["stitch_added"] = int(np.setdiff1d(stitched, lines_arr).size)
        lines_arr = stitched
    elif stitch_found:  # sets and approx: the stitch only adds lines
        extra = np.unique(np.concatenate(stitch_found))
        st["stitch_added"] = int(np.setdiff1d(extra, lines_arr).size)
        lines_arr = np.union1d(lines_arr, extra).astype(np.int64)
    st["scan_wall_seconds"] = time.perf_counter() - t_wall0
    return engine_mod.ScanResult(lines_arr, int(lines_arr.size), n,
                                 nl_index=nl)
