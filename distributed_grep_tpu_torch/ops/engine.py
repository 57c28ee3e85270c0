"""GrepEngine: one compiled pattern or literal set, scanned on a device
or, where the reference routes it there, on the host.

A single pattern is routed by ``check_pattern`` as the reference engine
routes it with its native library present (``distributed_grep_tpu/ops/
engine.py`` GrepEngine.__init__ and _scan_impl), in order:

1. a literal or byte-class sequence of at most 32 symbols (optionally
   case-folded): a Shift-And model, scanned by csrc/shift_and.cu;
2. a regex that denotes a finite literal set of at least 2 members
   (``models/dfa.enumerate_literal_set``: ``(volcano|needle)``,
   ``x[01][01]``) that ``compile_fdr`` accepts: routed as that set
   (route "fdr_literal_set", below), keeping the regex as ``pattern``;
3. any other pattern with a DFA table and a Glushkov model of at most 128
   positions -- alternations, classes, ``? * + {m,n}``, a leading ``^``:
   the Glushkov NFA kernel (csrc/nfa.cu).  Where relaxing a bounded repeat
   saves state words the kernel runs the relaxed FILTER, the host confirms
   its candidate lines with the DFA, and the exact model stands by for
   dense segments;
4. a DFA table but no Glushkov model ('$' accepts, more than 128
   positions, mid-pattern anchors): the filter of
   ``compile_device_filter`` on the NFA kernel, every candidate line
   confirmed with the DFA (its ``accept_eol`` plane carries the '$');
   where no filter compiles (a pattern nullable at '$': '^$', '^ *$',
   'x?$'), the host scanner (mode and route "native": the DFA table in the
   host library, ``models/dfa.reference_scan``);
5. no DFA table (``\\b``/``\\B``, a repeat past the expansion cap, too many
   DFA states): the Glushkov filter of ``compile_scan_model`` or
   ``compile_device_filter``, confirmed with Python ``re``; where no filter
   compiles, and for syntax only ``re`` knows (a backreference, a
   possessive repeat, a lookaround, a '\\n' in the pattern), the host
   ``re`` loop (mode and route "re": ``re.search`` on every line);
6. a pattern that matches the empty string: every line, with no scan.

A pattern that matches the empty string at a line's end ('^$', 'x?$') is
fixed up after any scan, as in the reference: the scanners attribute the
empty match to the '\\n' before a line, so the empty lines are added
(``ops/lines.empty_line_numbers``) and a line past the last one dropped.
Each demotion to a host scanner is logged at WARNING, naming the pattern
and why.

A literal set (``GrepEngine(patterns=...)``, ``grep -F``/``-f``) is routed
by ``check_patterns`` (the reference's engine.py:644-796):

* every member of 1-2 bytes and the set's expected match density under
  the byte priors at most ``FP_CEILING_PER_BYTE``: the exact pairset
  kernel (csrc/pairset.cu, mode "pairset"), no confirm;
* otherwise the members of at least 2 bytes compile to FDR filter banks
  (csrc/fdr.cu, mode "fdr"); 1-byte members, past the same density gate,
  ride the pairset kernel as a sidecar whose exact words are OR'd into
  the candidate words; every candidate end offset is confirmed exactly on
  the host (ops/confirm_set.py) against all members;
* an empty member matches every line; a set neither kernel hosts (a
  dense 1-byte member, a dense short set, a set FDR refuses) runs on the
  host scanner over its Aho-Corasick banks (models/aho.py, mode "native").

A single pattern with ``max_errors=k`` (agrep, k = 1..3) is routed by
``check_approx``: a literal or class sequence of at most 32 symbols on the
Wu-Manber kernel (csrc/approx.cu, mode "approx"), whose words are exact;
a pattern of at most k symbols matches every line.  With SWAR enabled
(``DGREP_SWAR=1``, read at scan time) a Shift-And pattern whose full and
filter models both pass ``swar_values`` runs the packed kernel
(csrc/shift_and_swar.cu) in place of csrc/shift_and.cu
(ops/device_scan.py).

``backend="cpu"`` is the reference's host backend (its CLI's default):
every plan scans on the host, mode "native" (a set over its Aho-Corasick
banks, a regex that denotes a literal set over that set's banks, a plain
literal with the library's memmem, any other pattern over its DFA table,
an approx pattern with ``models/approx.scan_reference``), and a pattern
with no DFA table in mode "re".  Nothing on that backend touches CUDA.

A host scan (both backends) runs in pieces of HOST_CHUNK bytes when the
caller passes ``progress``, calling it once a piece, so a worker's
liveness window holds over a long file; ``stats`` carry its
``host_scan_seconds`` and, in mode "native", its ``end_offsets``.

The warm tiers (the reference's engine.py:332-497, 1217-1390 and
1525-2300):

* small inputs: on the card, an input below ``device_min_bytes``
  (DGREP_DEVICE_MIN_BYTES, 1 MiB) scans on the host (every line through
  ``host_line_matcher``, the exact oracle of the confirm and the stitch),
  since a dispatch of its own costs more; ``stats["small_host_scan"]``
  says so.  Never on ``device="cpu"``, and never for approx, whose host
  recurrence is slow at any size;
* ``scan_batch`` packs small inputs into windows of up to ``batch_bytes``
  (DGREP_BATCH_BYTES, 32 MiB; ops/layout.BatchPacker) and scans each
  window once;
* the corpus cache (ops/layout.CorpusCache, budget ``corpus_bytes``,
  DGREP_CORPUS_BYTES, 1 GiB on the card and 0 on the CPU): ``scan_file``
  of a file of one chunk and ``scan_batch``'s files and windows keep their
  uploaded segments on the card, and a repeat scan of unchanged files
  reads and uploads nothing;
* ``scan_file_suffix``, the live-append suffix scan of ``grep --follow``;
* ``cached_engine``, engines shared by their construction arguments;
* the shard index (index/, the reference's engine.py:1400-1470): a
  shard whose trigram summary proves that no line can match is answered
  with the exact empty result and never opened, uploaded or launched
  on; ``scan_file`` and ``scan_batch`` publish the summaries of the
  shards they read whole, where one can be read again (an attached
  store, or the corpus cache on).  DGREP_INDEX=0 turns it off.

Differences from the reference, none of which changes an output line:

* no kernel cost budget (the reference's ``pallas_nfa.MAX_COST`` exists
  because the TPU kernel unrolls its plan; csrc/nfa.cu reads its plan
  from memory);
* no native crossover: the reference's ``compile_fdr`` cedes a set to its
  host scanner when the plan's modelled rate falls below the scanner's;
  the port keeps every set FDR accepts on the card;
* no self-calibration or retune of FDR plans: the port's plans are the
  default-pricing plans (the reference's constants; re-pricing for the
  H100 is later work);
* no kernel-failure fallback: the reference flips a failed FDR kernel to
  its DFA banks; the port raises;
* the table DFA on the card only on a mesh engine: the reference runs its
  device DFA banks without its native library, on mesh engines and in its
  kernel_compare; the port's library always builds, so a single pattern
  outside the kernel subset takes the host scanner (route 4 above) except
  on a mesh engine, where it keeps mode and route "dfa" as in the
  reference: K1 (csrc/dfa.cu, ops/dfa_scan.py) scans each table on the
  mesh's first entry, K2 where ``choose_stride`` finds a stride
  (``dfa_plans``), and the scan logs and counts (``mesh_unsharded``) that
  no sharded kernel ran.

The cards (the reference's engine.py:414-475): ``devices`` None is
``device`` alone, "all" every local card (raising without one, never
falling back to the CPU), a list each entry (a card may repeat); a scan's
segments round-robin over them (ops/device_scan.py).  ``mesh``
(parallel/mesh.py) with ``mesh_axis`` shards each segment's lanes over
the mesh's entries instead (parallel/sharded_kernels.py, rows 1 and 3-6;
``stats["psum_candidates"]`` sums their nonzero-word counts).  With
``pattern_axis`` a literal set's same-plan FDR banks also shard over that
axis (``sharded_fdr_pattern_step``: entry (i, j) runs bank run j on lane
block i, the words OR'd across the axis; the runs' tables are built once,
``_fdr_ep_tables``); every other mode, and mixed-plan banks, shard lanes
over ``mesh_axis`` alone.  A mesh may span processes
(parallel/multihost.py): every rank builds the same engine and scans the
same input, each launching its own entries' kernels, and gets the lines
one process would.  ``mesh`` and ``devices`` exclude each other; a bad
axis name raises ValueError at construction.  A mesh engine does not use
the corpus cache.
"""

from __future__ import annotations

import logging
import os
import queue
import re
import stat
import sys
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from distributed_grep_tpu_torch.models import approx as approx_mod
from distributed_grep_tpu_torch.models.aho import (
    MAX_STATES_PER_BANK,
    compile_aho_corasick_banks,
)
from distributed_grep_tpu_torch.models.approx import MAX_ERRORS, ApproxModel
from distributed_grep_tpu_torch.models.dfa import (
    NL,
    DfaTable,
    RegexError,
    build_stride_table,
    choose_stride,
    compile_dfa,
    enumerate_literal_set,
    expand_posix_classes,
    reference_scan,
)
from distributed_grep_tpu_torch.models.fdr import (
    FP_CEILING_PER_BYTE,
    FdrError,
    FdrModel,
    compile_fdr,
)
from distributed_grep_tpu_torch.models.nfa import (
    GlushkovModel,
    compile_device_filter,
    compile_scan_model,
    try_compile_glushkov,
)
from distributed_grep_tpu_torch.models.pairset import (
    PairsetError,
    PairsetModel,
    compile_pairset,
    expected_match_density,
)
from distributed_grep_tpu_torch.models.shift_and import (
    ShiftAndModel,
    filtered_for_device,
    parse_pattern,
    try_compile_shift_and,
)
from distributed_grep_tpu_torch.ops import host_match
from distributed_grep_tpu_torch.ops.confirm_set import ConfirmSet
from distributed_grep_tpu_torch.ops.layout import (
    DEFAULT_CORPUS_BYTES_ACCEL,
    BatchPacker,
    batch_content_key,
    corpus_cache,
    corpus_cache_counters,
    env_batch_bytes,
    env_corpus_bytes,
    env_device_min_bytes,
    file_content_key,
    packed_size,
)
from distributed_grep_tpu_torch.ops.lines import (
    count_lines,
    empty_line_numbers,
    line_spans,
    newline_index,
    unique_match_lines,
)
from distributed_grep_tpu_torch.parallel.mesh import (
    Mesh,
    axes_tuple,
    home_device,
    lane_sharding,
    resolve_devices,
)
from distributed_grep_tpu_torch.parallel.multihost import process_index
from distributed_grep_tpu_torch.utils import lockdep, native
from distributed_grep_tpu_torch.utils import spans as spans_mod

log = logging.getLogger("distributed_grep_tpu_torch.engine")

# Span path: above this many candidate lines per segment, the per-line host
# confirm would crawl -- one exact-mode kernel pass over the segment on the
# device resolves every line instead.
SPAN_CONFIRM_LINE_LIMIT = 4096

# Lanes per 64 MB segment on the card: 65536 stripes of 1024 bytes give
# 256 blocks of 256 threads, about two blocks per SM of an H100.
DEFAULT_TARGET_LANES = 65536
DEFAULT_SEGMENT_BYTES = 64 * 1024 * 1024

# scan_file's chunk target when the caller names none: the larger of this
# and the engine's segment size.
FILE_CHUNK_BYTES = 1 << 26

# A host scan given a progress callback runs in newline-cut pieces of
# about this many bytes, one callback a piece (the reference's _HOST_CHUNK).
HOST_CHUNK = 1 << 26

BACKENDS = ("device", "cpu")


# ------------------------------------------------------------ model cache
# Engines shared by their construction arguments (the reference's
# engine.py:242-400): a repeated query reuses the compiled models and the
# card's uploaded tables, so a resubmit of a pattern skips its build.  An
# engine is safe to share between threads and jobs (thread-local stats, a
# read-ahead thread per scanning thread).  The key holds the device: an
# engine built for "cpu" is never served to a "cuda" job.
DEFAULT_MODEL_CACHE_ENTRIES = 32

# io_ok: the lock is held across an engine's build on purpose (two
# threads asking for one pattern build it once)
_model_cache_lock = lockdep.make_lock("model-cache", io_ok=True)
_model_cache: OrderedDict = OrderedDict()
# the counters have a lock of their own: every scan stamps them into its
# stats, and must not wait behind another thread's build
_model_cache_stats_lock = lockdep.make_lock("model-cache-stats")
_model_cache_stats = {"compile_cache_hits": 0, "compile_cache_misses": 0,
                      "compile_cache_evictions": 0}


def env_model_cache_entries(default: int = DEFAULT_MODEL_CACHE_ENTRIES) -> int:
    """DGREP_MODEL_CACHE, the cache's entry cap (0 disables; malformed
    keeps ``default``)."""
    raw = os.environ.get("DGREP_MODEL_CACHE")
    if not raw:
        return default
    try:
        return max(0, int(raw))
    except ValueError:
        return default


def _count_cache(key: str, n: int = 1) -> None:
    with _model_cache_stats_lock:
        _model_cache_stats[key] += n


def model_cache_counters() -> dict:
    """The cache's counters, or {} while they are all 0."""
    with _model_cache_stats_lock:
        if not any(_model_cache_stats.values()):
            return {}
        return dict(_model_cache_stats)


def model_cache_clear() -> None:
    """Drop every cached engine and zero the counters."""
    with _model_cache_lock:
        _model_cache.clear()
        with _model_cache_stats_lock:
            for k in _model_cache_stats:
                _model_cache_stats[k] = 0


def invalidate_cached_engine(eng: "GrepEngine") -> None:
    """Evict ``eng`` under every key it is cached by (an engine whose
    compiled state no longer answers its key); counted as evictions."""
    with _model_cache_lock:
        keys = [k for k, v in _model_cache.items() if v is eng]
        for k in keys:
            del _model_cache[k]
    if keys:
        _count_cache("compile_cache_evictions", len(keys))


def _hashable(v):
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, torch.device):
        return str(v)
    return v


def cached_engine(pattern=None, *, patterns=None, **kw):
    """``(engine, verdict)``: the engine of these construction arguments,
    shared with every earlier call that gave the same ones ("hit"), or
    built and cached ("miss"), or built uncached ("off": DGREP_MODEL_CACHE
    is 0, the arguments do not hash, or they name a mesh or a list of
    devices, whose engine is tied to those devices; ``devices="all"`` is
    keyed by the cards it resolves to).  The build runs
    under the cache's lock, so two threads asking for one pattern build
    it once.  The knobs an engine would read from the environment at
    construction (DGREP_DEVICE_MIN_BYTES, DGREP_BATCH_BYTES) are read here
    and passed on, so they are part of the key: a change of them between
    jobs builds a new engine rather than serving one built under the old
    values."""
    cap = env_model_cache_entries()
    if kw.get("device_min_bytes") is None:
        kw["device_min_bytes"] = env_device_min_bytes()
    if kw.get("batch_bytes") is None:
        kw["batch_bytes"] = env_batch_bytes()
    dev = kw.get("devices")
    key_kw = kw
    if dev == "all" and kw.get("backend", "device") == "device":
        # keyed by the cards "all" names now (by the name where it names
        # none: the engine's build then raises)
        try:
            key_kw = dict(kw, devices=tuple(
                str(d) for d in resolve_devices(dev, kw.get("device",
                                                            "cuda"))))
        except RuntimeError:
            pass
    key = (pattern, _hashable(patterns) if patterns is not None else None,
           _hashable(key_kw))
    if kw.get("mesh") is not None or not (dev is None or isinstance(dev, str)):
        key = None
    else:
        try:
            hash(key)
        except TypeError:
            key = None
    if cap <= 0 or key is None:
        return GrepEngine(pattern, patterns=patterns, **kw), "off"
    with _model_cache_lock:
        eng = _model_cache.get(key)
        if eng is not None:
            _model_cache.move_to_end(key)
            _count_cache("compile_cache_hits")
            return eng, "hit"
        eng = GrepEngine(pattern, patterns=patterns, **kw)
        _model_cache[key] = eng
        _count_cache("compile_cache_misses")
        evicted = 0
        while len(_model_cache) > cap:
            _model_cache.popitem(last=False)
            evicted += 1
        if evicted:
            _count_cache("compile_cache_evictions", evicted)
        return eng, "miss"


def _stamp_counters(stats: dict) -> None:
    """The process-wide counters of the model cache, the corpus cache, the
    follow tier and the shard index, into ``stats``, each only once it is
    nonzero (the last two only where their module was imported)."""
    stats.update(model_cache_counters())
    stats.update(corpus_cache_counters())
    follow = sys.modules.get("distributed_grep_tpu_torch.runtime.follow")
    if follow is not None:
        stats.update(follow.follow_counters())
        stats.update(follow.follow_fused_counters())
    index = sys.modules.get("distributed_grep_tpu_torch.index.summary")
    if index is not None:
        stats.update(index.index_counters())


@dataclass
class ScanResult:
    matched_lines: np.ndarray  # sorted 1-based line numbers (always exact)
    n_matches: int  # == matched_lines.size
    bytes_scanned: int
    nl_index: np.ndarray | None = None  # the document's '\n' offsets


@dataclass
class PatternPlan:
    """How one pattern or set is scanned: the outcome of ``check_pattern``
    or ``check_patterns``.

    mode            "shift_and", "nfa", "fdr", "pairset", "approx",
                    "all_lines", or on the host "native" or "re"; a mesh
                    engine turns a single pattern's "native" into "dfa"
    route           the routing step that chose it (module docstring):
                    "shift_and", "fdr_literal_set", "nfa", "dfa_filter",
                    "re_filter", "native", "re", "all_lines"; for a set
                    "fdr", "pairset", "native" or "all_lines"; with
                    max_errors "approx", "native" or "all_lines"
    table           the exact DFA (routes 3 and 4, and a native pattern):
                    host oracle of the confirm and the stitch
    tables          every DFA table the plan scans or confirms with: the
                    pattern's one table, or a native set's Aho-Corasick
                    banks
    glushkov        the model the NFA kernel runs first
    glushkov_exact  the exact model (the dense confirm, and the defeat
                    guard's swap), or None where none fits
    nfa_filter      True when ``glushkov`` is a candidate superset
    re_fallback     route 5's oracle and mode "re"'s matcher: ``re`` over
                    the POSIX-expanded pattern
    fdr             the FDR filter banks (mode "fdr")
    pairset         the exact short-set model (mode "pairset")
    fdr_pairset     mode "fdr": the sidecar model of the 1-byte members
    confirm         a set's exact host oracle (every member): the FDR
                    candidates' confirm and the stitch of both set modes
    approx          the k-error model (mode "approx")
    """

    mode: str
    route: str
    shift_and: ShiftAndModel | None = None
    sa_filtered: ShiftAndModel | None = None
    table: DfaTable | None = None
    tables: list[DfaTable] | None = None
    glushkov: GlushkovModel | None = None
    glushkov_exact: GlushkovModel | None = None
    nfa_filter: bool = False
    re_fallback: re.Pattern | None = None
    fdr: FdrModel | None = None
    pairset: PairsetModel | None = None
    fdr_pairset: PairsetModel | None = None
    confirm: ConfirmSet | None = None
    approx: ApproxModel | None = None


def _member_bytes(p: str | bytes) -> bytes:
    return p.encode("utf-8", "surrogateescape") if isinstance(p, str) else bytes(p)


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def _native_set(members: list[bytes], ignore_case: bool) -> PatternPlan:
    """Mode "native" over the set's Aho-Corasick banks, at the reference's
    bank budget."""
    tables = compile_aho_corasick_banks(
        members, ignore_case=ignore_case,
        max_states_per_bank=MAX_STATES_PER_BANK)
    return PatternPlan("native", "native", table=tables[0], tables=tables)


def check_patterns(patterns, ignore_case: bool = False,
                   fdr: FdrModel | None = None,
                   backend: str = "device") -> PatternPlan:
    """Route a literal set (members str, decoded utf-8/surrogateescape, or
    bytes; see the module docstring).  ``fdr`` is the set's FDR model when
    the caller compiled it already.  An empty set, or a member holding
    '\\n', raises ValueError."""
    _check_backend(backend)
    members = [_member_bytes(p) for p in patterns]
    if not members:
        raise ValueError("empty pattern set")
    if any(not m for m in members):
        # grep -F: an empty pattern matches every line
        return PatternPlan("all_lines", "all_lines")
    if any(NL in m for m in members):
        raise ValueError("a literal of the set contains '\\n'")
    if backend == "cpu":
        return _native_set(members, ignore_case)
    n = len(members)
    if max(len(m) for m in members) <= 2:
        dens = expected_match_density(members, ignore_case=ignore_case)
        if dens <= FP_CEILING_PER_BYTE:
            try:
                ps = compile_pairset(members, ignore_case=ignore_case)
            except PairsetError:
                pass
            else:
                return PatternPlan("pairset", "pairset", pairset=ps,
                                   confirm=ConfirmSet(ps.patterns,
                                                      ignore_case))
    long_pats = [m for m in members if len(m) >= 2]
    short_pats = [m for m in members if len(m) < 2]
    if not long_pats:
        log.warning("pattern set of %d members expects more matches per "
                    "byte than the device ceiling (dense 1-byte members) -> "
                    "native host scanner", n)
        return _native_set(members, ignore_case)
    try:
        if short_pats:
            short_dens = expected_match_density(short_pats,
                                                ignore_case=ignore_case)
            if short_dens > FP_CEILING_PER_BYTE:
                raise FdrError(f"its 1-byte members expect {short_dens:.3g} "
                               f"matches/byte, over the "
                               f"{FP_CEILING_PER_BYTE:.2g} device ceiling")
        if fdr is None:
            fdr = compile_fdr(long_pats, ignore_case=ignore_case)
    except FdrError as e:
        log.warning("pattern set of %d members is outside the FDR filter "
                    "(%s) -> native host scanner", n, e)
        return _native_set(members, ignore_case)
    sidecar = (compile_pairset(short_pats, ignore_case=ignore_case)
               if short_pats else None)
    confirm = [p for b in fdr.banks for p in b.patterns]
    if sidecar is not None:
        confirm += sidecar.patterns
    return PatternPlan("fdr", "fdr", fdr=fdr, fdr_pairset=sidecar,
                       confirm=ConfirmSet(confirm, ignore_case))


def _host_re(pattern: str, ignore_case: bool) -> re.Pattern:
    """The reference's host re matcher for ``pattern`` (POSIX classes
    expanded first: re has none); RegexError when re rejects it too."""
    try:
        return re.compile(
            expand_posix_classes(pattern.encode("utf-8", "surrogateescape")),
            re.IGNORECASE if ignore_case else 0,
        )
    except re.error as e:
        raise RegexError(str(e)) from e


def _re_rescue(pattern: str, ignore_case: bool, err: RegexError,
               backend: str) -> PatternPlan:
    """Route 5: no DFA table.  A Glushkov filter on the card, every
    candidate line confirmed with Python re (the reference's engine.py
    re-fallback branch and its device rescue); where no filter compiles,
    or on the host backend, the host re loop."""
    rx = _host_re(pattern, ignore_case)
    if backend == "cpu":
        return PatternPlan("re", "re", re_fallback=rx)
    try:
        filt, _ = compile_scan_model(pattern, ignore_case=ignore_case)
    except RegexError:
        filt = None
    if filt is None:
        filt = compile_device_filter(pattern, ignore_case=ignore_case)
    if filt is None:
        log.warning("pattern %r has no DFA table (%s) and no device filter "
                    "-> host re loop", pattern, err)
        return PatternPlan("re", "re", re_fallback=rx)
    # always confirm: with no DFA, even an exact Glushkov model's lines
    # are re-checked with re
    return PatternPlan("nfa", "re_filter", glushkov=filt, nfa_filter=True,
                       re_fallback=rx)


def _check_pattern_cpu(pattern: str, ignore_case: bool,
                       sa: ShiftAndModel | None) -> PatternPlan:
    """The host backend's routes (the reference's backend="cpu"): a regex
    that denotes a literal set scans that set's banks, any other pattern
    its DFA table, and one with no table the re loop."""
    if sa is None:
        lits = enumerate_literal_set(pattern, ignore_case=ignore_case)
        if lits is not None and len(lits) >= 2:
            return _native_set([_member_bytes(x) for x in lits], ignore_case)
    try:
        table = compile_dfa(pattern, ignore_case=ignore_case)
    except RegexError as e:
        return _re_rescue(pattern, ignore_case, e, "cpu")
    if table.accept[table.start]:
        return PatternPlan("all_lines", "all_lines", table=table)
    return PatternPlan("native", "native", shift_and=sa, table=table,
                       tables=[table])


def check_pattern(pattern: str, ignore_case: bool = False,
                  backend: str = "device") -> PatternPlan:
    """Route ``pattern`` (see the module docstring) for ``backend``
    ("device", or "cpu": the host scanners alone).  A pattern that neither
    the parser nor Python re accepts raises RegexError."""
    _check_backend(backend)
    try:
        parse_pattern(pattern, ignore_case)
    except RegexError as e:
        # outside the automaton syntax but valid for re (a backreference,
        # a possessive repeat, a lookaround, a '\n'): the reference's re
        # fallback, with its device rescue where a filter compiles
        try:
            _host_re(pattern, ignore_case)
        except RegexError:
            raise e from None
        return _re_rescue(pattern, ignore_case, e, backend)
    sa = try_compile_shift_and(pattern, ignore_case=ignore_case)
    if backend == "cpu":
        return _check_pattern_cpu(pattern, ignore_case, sa)
    if sa is not None:
        return PatternPlan("shift_and", "shift_and", shift_and=sa,
                           sa_filtered=filtered_for_device(sa))
    lits = enumerate_literal_set(pattern, ignore_case=ignore_case)
    if lits is not None and len(lits) >= 2:
        try:
            model = compile_fdr(lits, ignore_case=ignore_case)
        except FdrError:
            pass  # the regex routes below keep it
        else:
            plan = check_patterns(lits, ignore_case, fdr=model)
            plan.route = "fdr_literal_set"
            return plan
    try:
        table = compile_dfa(pattern, ignore_case=ignore_case)
        glushkov, is_filter = compile_scan_model(pattern,
                                                 ignore_case=ignore_case)
    except RegexError as e:
        return _re_rescue(pattern, ignore_case, e, backend)
    if table.accept[table.start]:
        # the empty string matches: every line does (grep semantics)
        return PatternPlan("all_lines", "all_lines", table=table)
    if glushkov is not None:
        exact = (try_compile_glushkov(pattern, ignore_case=ignore_case)
                 if is_filter else glushkov)
        return PatternPlan("nfa", "nfa", table=table, tables=[table],
                           glushkov=glushkov, glushkov_exact=exact,
                           nfa_filter=is_filter)
    filt = compile_device_filter(pattern, ignore_case=ignore_case)
    if filt is None:
        why = ("matches the empty string at a line's end (nullable at '$')"
               if table.accept_eol[table.start] else
               "has no Glushkov model and no device filter")
        log.warning("pattern %r %s -> native host scanner", pattern, why)
        return PatternPlan("native", "native", table=table, tables=[table])
    return PatternPlan("nfa", "dfa_filter", table=table, tables=[table],
                       glushkov=filt, nfa_filter=True)


def check_approx(pattern: str, k: int, ignore_case: bool = False,
                 backend: str = "device") -> PatternPlan:
    """Route ``pattern`` with at most ``k`` edit errors (the reference's
    engine.py:621-643): a literal / class sequence of at most 32 symbols on
    the approx kernel (csrc/approx.cu), or on the host backend its host
    recurrence (mode "native"), or every line when the pattern is no longer
    than k (deleting it all costs at most k edits).  No literal
    decomposition: approximate matching keeps the pattern's own form.
    Raises ValueError for k outside 1..MAX_ERRORS or another pattern."""
    _check_backend(backend)
    if not 1 <= k <= MAX_ERRORS:
        raise ValueError(f"max_errors must be 1..{MAX_ERRORS}")
    base = try_compile_shift_and(pattern, ignore_case=ignore_case)
    if base is None:
        raise ValueError(
            "approximate matching needs a literal/class-sequence "
            "pattern of <= 32 symbols (no anchors/alternation/repeats)"
        )
    if base.length <= k:
        return PatternPlan("all_lines", "all_lines")
    mode = "native" if backend == "cpu" else "approx"
    return PatternPlan(mode, mode, approx=ApproxModel(base=base, k=k))


class _Reader:
    """A one-slot read-ahead thread: ``submit(fn, *args)`` runs fn on a
    daemon thread and returns a Future.  One per scanning thread, kept for
    the thread's life (``_thread_reader``), so a worker streaming many
    files pays no thread start per file.  The scanning thread's local
    holds the only reference: when that thread ends, this object goes and
    its finalizer ends the read thread."""

    def __init__(self):
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        threading.Thread(target=_serve_reads, args=(self._q,), daemon=True,
                         name="dgrep-read").start()
        weakref.finalize(self, self._q.put, None)

    def submit(self, fn, *args) -> Future:
        fut: Future = Future()
        self._q.put((fut, fn, args))
        return fut


def _serve_reads(q: queue.SimpleQueue) -> None:
    """The read thread's loop, until the None its _Reader's finalizer
    sends."""
    while (item := q.get()) is not None:
        fut, fn, args = item
        if not fut.set_running_or_notify_cancel():
            continue
        try:
            fut.set_result(fn(*args))
        except BaseException as e:  # noqa: BLE001 -- the future holds it
            fut.set_exception(e)


_readers = threading.local()


def _thread_reader() -> _Reader:
    r = getattr(_readers, "r", None)
    if r is None:
        r = _readers.r = _Reader()
    return r


def lines_match(
    model: ShiftAndModel, data, starts: np.ndarray, ends: np.ndarray
) -> np.ndarray:
    """Host Shift-And over many lines at once: True where [starts[i],
    ends[i]) of ``data`` contains a match of ``model`` (which must be exact,
    i.e. no wildcard positions).  The lines are gathered into one buffer
    with a '\\n' after each; a match of m symbols starts at p iff bit j of
    B[buf[p + j]] is set for every j, and never crosses a '\\n' (no symbol
    class contains it), so it is one vectorized AND of m shifted table
    lookups."""
    n = len(starts)
    out = np.zeros(n, dtype=bool)
    if n == 0:
        return out
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(ends, dtype=np.int64) - starts
    m = model.length
    total = int(lens.sum())
    if total < m:
        return out
    arr = np.frombuffer(data, dtype=np.uint8)
    csum = np.concatenate(([0], np.cumsum(lens)))
    owner = np.repeat(np.arange(n, dtype=np.int64), lens)
    k = np.arange(total, dtype=np.int64)
    buf = np.full(total + n, NL, dtype=np.uint8)
    buf[k + owner] = arr[k - csum[owner] + starts[owner]]
    b = model.b_table[buf]
    span = buf.size - m + 1
    acc = (b[:span] & np.uint32(1)) != 0
    for j in range(1, m):
        acc &= ((b[j : j + span] >> np.uint32(j)) & np.uint32(1)) != 0
    hits = np.flatnonzero(acc)
    if hits.size:
        line_start = csum[:-1] + np.arange(n, dtype=np.int64)
        out[np.searchsorted(line_start, hits, side="right") - 1] = True
    return out


class GrepEngine:
    """Scan documents for one compiled pattern, or one literal set, on one
    device, its ``devices`` or its ``mesh`` (module docstring), or on the
    host where its plan says so (``backend="cpu"``: every plan).  Exactly
    one of ``pattern`` and ``patterns`` is given."""

    def __init__(
        self,
        pattern: str | bytes | None = None,
        *,
        patterns: list[str | bytes] | None = None,
        ignore_case: bool = False,
        max_errors: int = 0,
        device: str | torch.device = "cuda",
        backend: str = "device",
        target_lanes: int = DEFAULT_TARGET_LANES,
        segment_bytes: int = DEFAULT_SEGMENT_BYTES,
        min_chunk: int = 256,
        device_min_bytes: int | None = None,
        batch_bytes: int | None = None,
        corpus_bytes: int | None = None,
        devices: object = None,
        mesh: Mesh | None = None,
        mesh_axis: object = "data",
        pattern_axis: object = None,
    ):
        if (pattern is None) == (patterns is None):
            raise ValueError("exactly one of pattern / patterns is required")
        if max_errors and patterns is not None:
            raise ValueError("max_errors applies to a single pattern, not a set")
        _check_backend(backend)
        self.backend = backend
        if mesh is not None and devices is not None:
            raise ValueError("mesh and devices are mutually exclusive")
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        if mesh is not None:
            # fail at construction, with the reference's words
            known = set(mesh.axis_names)
            lane_axes = axes_tuple(mesh_axis)
            if not lane_axes or not set(lane_axes) <= known:
                raise ValueError(f"mesh_axis {mesh_axis!r} not in mesh axes "
                                 f"{sorted(known)}")
            if pattern_axis is not None and (pattern_axis not in known
                                             or pattern_axis in lane_axes):
                raise ValueError(
                    f"pattern_axis {pattern_axis!r} must name a mesh axis "
                    f"outside mesh_axis {lane_axes}")
        self.pattern_axis = pattern_axis
        # the cards the scans run on: the host backend runs no kernel and
        # asks for none; a mesh's lane entries (``device``: this rank's
        # first); else ``devices`` (None: ``device`` alone; "all": every
        # local card) -- segments round-robin over them.  ``device`` is
        # the first.
        if backend == "cpu":
            self.devices = [torch.device("cpu")]
            self.device = self.devices[0]
        elif mesh is not None:
            lanes = lane_sharding(mesh, mesh_axis)
            self.devices = list(lanes.devices)
            self.device = home_device(mesh, lanes, process_index())
        else:
            self.devices = resolve_devices(devices, device)
            self.device = self.devices[0]
        if isinstance(pattern, bytes):
            pattern = pattern.decode("utf-8", "surrogateescape")
        if segment_bytes <= 0 or target_lanes < 32 or target_lanes % 32:
            raise ValueError(
                "segment_bytes must be positive and target_lanes a positive "
                "multiple of 32"
            )
        self.ignore_case = ignore_case
        # the warm tiers' knobs (module docstring); None reads the
        # environment, parsed as the map-split planner parses it
        self.device_min_bytes = (env_device_min_bytes()
                                 if device_min_bytes is None
                                 else int(device_min_bytes))
        self.batch_bytes = (env_batch_bytes() if batch_bytes is None
                            else int(batch_bytes))
        self.corpus_bytes = None if corpus_bytes is None else int(corpus_bytes)
        self.target_lanes = target_lanes
        self.segment_bytes = segment_bytes
        self.min_chunk = min_chunk
        # the shard index's view of the query (index/plan.py derives its
        # required literals on first use: False until then, None when it
        # is not eligible)
        self._index_query = (pattern,
                             tuple(patterns) if patterns is not None else None,
                             bool(ignore_case), int(max_errors))
        self._index_req: object = False
        if patterns is not None:
            self.pattern = f"<set of {len(patterns)}>"
            plan = check_patterns(patterns, ignore_case, backend=backend)
        elif max_errors:
            self.pattern = pattern
            plan = check_approx(pattern, int(max_errors), ignore_case,
                                backend=backend)
        else:
            self.pattern = pattern
            plan = check_pattern(pattern, ignore_case, backend=backend)
        if (mesh is not None and plan.route == "native"
                and patterns is None and not max_errors):
            # the reference keeps a single pattern outside the kernel
            # subset on its device DFA path on a mesh engine ("mesh/
            # interpret engines ... exist to run the device path"):
            # mode and route "dfa", K1 (or K2) on the mesh's first entry
            plan.mode = plan.route = "dfa"
        self.mode = plan.mode
        self.route = plan.route
        self.shift_and = plan.shift_and
        # Rare-class device filter: the kernel checks only the pattern's
        # rarest byte-classes; the span confirm restores exact lines, and
        # the scan drops the filter if a corpus defeats the byte prior.
        self._sa_filtered = plan.sa_filtered
        self.table = plan.table
        self.tables = plan.tables or []
        # '^$', 'x?$': the scan's result gets the empty lines (scan())
        self._nullable_eol = any(bool(t.accept_eol[t.start])
                                 for t in self.tables)
        self.glushkov = plan.glushkov
        self.glushkov_exact = plan.glushkov_exact
        self._nfa_filter = plan.nfa_filter
        self._re_fallback = plan.re_fallback
        self.fdr = plan.fdr
        self.pairset = plan.pairset
        self.fdr_pairset = plan.fdr_pairset
        self.confirm = plan.confirm
        self.approx = plan.approx
        self._stats_local = threading.local()
        self._copy_streams: dict = {}
        self._dfa_plans: list | None = None
        self._fdr_ep_dev_tables = None  # the banks' runs, pattern axis
        self._copy_lock = threading.Lock()
        # numeric stats summed over every scan of this engine (all threads)
        self.totals: dict = {}

    @property
    def stats(self) -> dict:
        """Counters of the last scan run by the calling thread."""
        d = getattr(self._stats_local, "d", None)
        if d is None:
            d = {}
            self._stats_local.d = d
        return d

    @stats.setter
    def stats(self, value: dict) -> None:
        self._stats_local.d = value

    def layout_kwargs(self) -> dict:
        """choose_layout parameters: the kernel needs lanes % 32 == 0 and
        chunk % 32 == 0."""
        return dict(
            target_lanes=self.target_lanes, min_chunk=self.min_chunk,
            lane_multiple=32, chunk_multiple=32,
        )

    def dfa_plans(self) -> list:
        """Mode "dfa"'s scan plan, a table at a time (the reference's
        ``_device_tables`` choice): a ``StrideTable`` (K2) where
        ``choose_stride`` finds k > 1, else the ``DfaTable`` (K1).  Built
        once; each kernel uploads its table once a device."""
        plans = self._dfa_plans
        if plans is None:
            plans = []
            for t in self.tables:
                k = choose_stride(t)
                plans.append(build_stride_table(t, k) if k > 1 else t)
            self._dfa_plans = plans
        return plans

    def _fdr_ep_tables(self, pattern_axis):
        """The FDR banks' runs over ``pattern_axis``, built and uploaded
        once (the reference's ``_fdr_ep_tables``)."""
        if self._fdr_ep_dev_tables is None:
            from distributed_grep_tpu_torch.parallel import (
                sharded_kernels as shk,
            )

            self._fdr_ep_dev_tables = shk.fdr_pattern_tables(
                self.fdr, self.mesh, pattern_axis)
        return self._fdr_ep_dev_tables

    def copy_stream(self, device: torch.device | None = None):
        """This engine's side stream for host-to-device copies to
        ``device`` (default the engine's first), one a card."""
        dev = self.device if device is None else device
        with self._copy_lock:
            stream = self._copy_streams.get(str(dev))
            if stream is None:
                stream = self._copy_streams[str(dev)] = torch.cuda.Stream(
                    device=dev)
            return stream

    @property
    def stitch_window(self) -> int:
        """Set modes: a kernel misses a match only where it ends within
        ``stitch_window - 1`` bytes after a stripe or segment start (FDR
        seeds prev = 0 and so hashes a wrong pair there, up to its m
        slots deep; pairset seeds prev = '\\n' and misses only at the
        first byte)."""
        if self.mode == "pairset":
            return self.pairset.window
        return self.fdr.window

    def literal(self) -> bytes | None:
        """The pattern as one byte string, when it is one: a Shift-And
        pattern whose every symbol is a single byte."""
        if self.shift_and is None:
            return None
        out = []
        for ranges in self.shift_and.sym_ranges:
            if len(ranges) != 1 or ranges[0][0] != ranges[0][1]:
                return None
            out.append(ranges[0][0])
        return bytes(out)

    def host_line_matcher(self, data, starts, ends) -> np.ndarray:
        """Exact host verdicts for the [starts, ends) line spans of
        ``data``: the vectorized Shift-And, the approx recurrence (the
        stitch's short windows on the card's route, whole lines in mode
        "native"), the confirm set, the DFA walk over every table (a
        native set's banks OR'd), or Python re."""
        if self.mode == "shift_and":
            return lines_match(self.shift_and, data, starts, ends)
        if self.approx is not None:
            if self.mode == "native":
                view = memoryview(data)
                return np.fromiter(
                    (approx_mod.line_matches(self.approx, bytes(view[a:b]))
                     for a, b in zip(np.asarray(starts).tolist(),
                                     np.asarray(ends).tolist())),
                    dtype=bool, count=len(starts))
            return host_match.approx_windows_match(self.approx, data, starts,
                                                   ends)
        if self.confirm is not None:
            return self.confirm.lines_match(data, starts, ends)
        if self.tables:
            out = host_match.dfa_lines_match(self.tables[0], data, starts,
                                             ends)
            for t in self.tables[1:]:
                out |= host_match.dfa_lines_match(t, data, starts, ends)
            return out
        return host_match.re_lines_match(self._re_fallback, data, starts, ends)

    def scan(self, data: bytes, progress=None,
             corpus_key=None) -> ScanResult:
        """Scan one in-memory document.  ``progress`` (optional callable) is
        called once per segment so a failure detector sees liveness.
        ``corpus_key`` (ops/layout.CorpusKey of ``data``) lets a scan on
        the card take its segments from the corpus cache, or publish them
        there.  The stats end with the process's cache counters."""
        res = self._scan(data, progress, corpus_key)
        _stamp_counters(self.stats)
        return res

    def _scan(self, data: bytes, progress=None,
              corpus_key=None) -> ScanResult:
        """``scan`` without the process counters: the scan of one piece of
        scan_file, scan_batch and scan_file_suffix.  Inside a span
        pipeline task context (utils/spans.py) each is one
        ``scan:<mode>`` record of its bytes, seconds, matches and stats
        (``device_fallback`` always False: no scan falls back)."""
        t0 = time.perf_counter() if spans_mod.active() else None
        res = self._scan_impl(data, progress, corpus_key)
        if t0 is not None:
            spans_mod.scan_record(
                mode=self.mode, n_bytes=len(data),
                seconds=time.perf_counter() - t0, stats=self.stats,
                matches=res.n_matches)
        return res

    def _scan_impl(self, data: bytes, progress=None,
                   corpus_key=None) -> ScanResult:
        from distributed_grep_tpu_torch.ops.device_scan import scan_device

        if not data:
            self.stats = {"segments": 0}
            return ScanResult(np.zeros(0, dtype=np.int64), 0, 0)
        if self.mode == "all_lines":
            self.stats = {"segments": 0}
            n_lines = count_lines(data)
            return ScanResult(np.arange(1, n_lines + 1, dtype=np.int64),
                              n_lines, len(data))
        if self.mode in ("native", "re"):
            res = self._host_scan(data, progress)
        elif self._small_for_device(len(data)):
            res = self._host_scan(data, progress, self._scan_small)
            self.stats["small_host_scan"] = True
        else:
            res = scan_device(self, data, progress=progress,
                              corpus_key=corpus_key)
        if self._nullable_eol:
            res = self._with_empty_lines(data, res)
        self._add_totals(self.stats)
        return res

    def _small_for_device(self, n_bytes: int) -> bool:
        """Whether a scan of ``n_bytes`` takes the host in place of a
        dispatch of its own (the reference's _small_for_device and
        _small_route_cached, engine.py:1239-1269): on the card only, below
        ``device_min_bytes``, and never in mode "approx".  scan_batch packs
        by the size alone, on every device."""
        return (n_bytes < self.device_min_bytes
                and self.backend == "device"
                and self.device.type == "cuda"
                and self.mode != "approx")

    def _scan_small(self, data: bytes) -> tuple[ScanResult, int]:
        """The small-input host scan: every line through
        ``host_line_matcher``."""
        nl = newline_index(data)
        n_lines = nl.size + (0 if data.endswith(b"\n") else 1)
        starts, ends = line_spans(np.arange(1, n_lines + 1, dtype=np.int64),
                                  nl, len(data))
        lns = np.flatnonzero(self.host_line_matcher(data, starts, ends))
        lns = lns.astype(np.int64) + 1
        return ScanResult(lns, int(lns.size), len(data), nl), 0

    def _corpus_budget(self) -> int:
        """The corpus cache's byte budget for this engine's scans (0: off):
        ``corpus_bytes``, else DGREP_CORPUS_BYTES, else
        DEFAULT_CORPUS_BYTES_ACCEL on the card and 0 on the CPU."""
        if self.corpus_bytes is not None:
            return max(0, self.corpus_bytes)
        env = env_corpus_bytes()
        if env is not None:
            return env
        return DEFAULT_CORPUS_BYTES_ACCEL if self.device.type == "cuda" else 0

    def _corpus_opt_in(self) -> bool:
        return self._corpus_budget() > 0

    # ------------------------------------------------------ shard index
    def _index_requirements(self):
        """The query's index.plan.QueryRequirements, or None: the index
        off (DGREP_INDEX, read each call) or the query not eligible.  The
        derivation runs once an engine; one that raises counts as not
        eligible (scan everything)."""
        from distributed_grep_tpu_torch.index import summary as index_summary

        if not index_summary.env_index_enabled():
            return None
        if self._index_req is False:
            from distributed_grep_tpu_torch.index import plan as index_plan

            pat, pats, ic, me = self._index_query
            try:
                self._index_req = index_plan.requirements_for_query(
                    pattern=pat,
                    patterns=list(pats) if pats is not None else None,
                    ignore_case=ic, max_errors=me)
            except Exception:  # noqa: BLE001 -- not eligible
                self._index_req = None
        return self._index_req

    def _index_publish_enabled(self) -> bool:
        """Whether scans build summaries: only where one can be read again
        (a store attached, or the corpus cache on).  A one-shot job builds
        none; lookups and prunes need no such gate."""
        from distributed_grep_tpu_torch.index import summary as index_summary

        return (index_summary.attached_store() is not None
                or self._corpus_opt_in())

    def _index_pruned(self, key) -> ScanResult:
        """Count one prune (counters, an ``index:prune`` instant, this
        thread's stats) and return the exact empty result: the summary
        proved that no line of the shard can match."""
        from distributed_grep_tpu_torch.index import summary as index_summary

        index_summary.record_prune(key.n_bytes)
        spans_mod.instant("index:prune", cat="engine", bytes=key.n_bytes)
        st = {"file_reads": 0, "read_wait_seconds": 0.0}
        _stamp_counters(st)
        self.stats = st
        return ScanResult(np.zeros(0, dtype=np.int64), 0, 0)

    def _index_publish(self, key, data: bytes) -> None:
        """Publish ``data``'s summary under ``key`` and attach it to the
        corpus-cache entry when one is resident; called after the scan of
        ``data`` succeeded, from the bytes in hand."""
        from distributed_grep_tpu_torch.index import summary as index_summary

        s = index_summary.publish_summary(key, data)
        if s is not None:
            corpus_cache().attach_summary(key, s)

    def _with_empty_lines(self, data: bytes, res: ScanResult) -> ScanResult:
        """The fix-up of a pattern nullable at '$' (the reference's
        engine.py scan()): its empty match holds at every line's end,
        empty lines included, which have no byte for a scanner to report,
        and a trailing '\\n' can make a scanner report a line past the
        last one.  So: drop lines past the last, add the empty lines."""
        nl = res.nl_index if res.nl_index is not None else newline_index(data)
        n_lines = nl.size + (0 if data.endswith(b"\n") else 1)
        ml = res.matched_lines[res.matched_lines <= n_lines]
        ml = np.union1d(ml, empty_line_numbers(data, nl)).astype(np.int64)
        return ScanResult(ml, int(ml.size), res.bytes_scanned, nl)

    def _host_scan(self, data: bytes, progress=None,
                   scanner=None) -> ScanResult:
        """Mode "native" or "re" (or ``scanner``) over ``data``: whole, or
        with ``progress`` in newline-cut pieces of about HOST_CHUNK bytes,
        one callback a piece (a line longer than a piece stays whole)."""
        if scanner is None:
            scanner = (self._scan_native if self.mode == "native"
                       else self._scan_re)
        t0 = time.perf_counter()
        if progress is None or len(data) <= int(1.5 * HOST_CHUNK):
            res, n_offsets = scanner(data)
            if progress is not None:
                progress()
        else:
            matched, nls = [], []
            n_matches = n_offsets = lines_before = pos = 0
            while pos < len(data):
                end = min(pos + HOST_CHUNK, len(data))
                if end < len(data):
                    cut = data.rfind(b"\n", pos, end)
                    if cut >= pos:
                        end = cut + 1
                    else:  # one line longer than the piece: to its end
                        nxt = data.find(b"\n", end)
                        end = len(data) if nxt < 0 else nxt + 1
                piece = data[pos:end]
                pres, n = scanner(piece)
                matched.append(pres.matched_lines + lines_before)
                n_matches += pres.n_matches
                n_offsets += n
                nl = (pres.nl_index if pres.nl_index is not None
                      else newline_index(piece))
                nls.append(nl + pos)
                lines_before += nl.size + (0 if piece.endswith(b"\n") else 1)
                pos = end
                progress()
            res = ScanResult(np.concatenate(matched), n_matches, len(data),
                             np.concatenate(nls))
        st = {"host_scan_seconds": time.perf_counter() - t0}
        if self.mode == "native":
            st["end_offsets"] = n_offsets
        self.stats = st
        return res

    def _scan_re(self, data: bytes) -> tuple[ScanResult, int]:
        """The host re loop: ``re.search`` on every line (a trailing '\\n'
        closes the last line rather than opening one)."""
        lines = data.split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()
        search = self._re_fallback.search
        matched = [i for i, line in enumerate(lines, start=1) if search(line)]
        return ScanResult(np.asarray(matched, dtype=np.int64), len(matched),
                          len(data)), 0

    def _scan_native(self, data: bytes) -> tuple[ScanResult, int]:
        """The host scanner: the approx recurrence, the library's memmem
        for a plain literal, or ``reference_scan`` over every table; the
        sorted end offsets map to lines by one linear merge."""
        lit = self.literal()
        if self.approx is not None:
            offsets = approx_mod.scan_reference(self.approx, data)
        elif lit is not None:
            offsets = native.literal_scan(data, lit)
        elif len(self.tables) == 1:
            offsets = reference_scan(self.tables[0], data)
        else:
            offsets = np.unique(np.concatenate(
                [reference_scan(t, data) for t in self.tables]))
        nl = newline_index(data)
        lns = unique_match_lines(offsets, nl)
        return ScanResult(lns, int(lns.size), len(data), nl), int(offsets.size)

    def _add_totals(self, stats: dict) -> None:
        with self._copy_lock:
            for k, v in stats.items():
                self.totals[k] = self.totals.get(k, 0) + v

    def scan_file(self, path, chunk_bytes: int | None = None, emit=None,
                  progress=None, stop_after_match: bool = False, stop=None,
                  emit_chunk=None) -> ScanResult:
        """Stream a file of any size through ``scan``: chunks of about
        ``chunk_bytes`` (default the larger of the segment size and
        FILE_CHUNK_BYTES) are cut after their last newline and the partial
        tail line carries into the next chunk, so no line spans two scans
        and host memory stays bounded by two chunks.  A line longer than a
        chunk is accumulated whole.  Line numbers in the result are
        file-global.  A regular file is read to the size it had when
        opened; its last chunk is scanned whole, tail line included.

        A one-slot reader thread reads chunk i+1 while chunk i scans; the
        stall left is ``stats["read_wait_seconds"]`` (also summed into
        ``totals``), and ``stats["file_reads"]`` is 1 when the file was
        opened.

        With the corpus cache on (``_corpus_opt_in``), a file of one
        chunk is keyed by a fresh stat: a warm file's bytes and segments
        come from the cache and the file is not opened; a cold one is
        scanned whole with its key, once a second stat after the read
        agrees, so the scan publishes it.  Files of several chunks stream
        uncached (their chunk cuts depend on the content).

        The shard index: where the query is eligible and a summary of the
        file exists, one that rules the query out returns the empty
        result without opening the file (``index_shards_pruned`` in the
        stats); a file of one chunk read whole publishes its summary
        where one can be read again (``_index_publish_enabled``).

        ``emit(line_no, line_bytes)`` is called per matched line while its
        chunk is in memory.  ``emit_chunk(lines_before, buf,
        matched_lines, nl_index)`` is the columnar alternative, once per
        chunk with matches: chunk-local 1-based line numbers and the
        chunk's newline index (the scan's own, ``ScanResult.nl_index``,
        where it has one).

        ``stop_after_match`` ends the stream after the first chunk with a
        matched line (grep -q/-l: presence, not a count; the result then
        holds only the lines seen).  ``stop()``, checked after each
        chunk's emits, ends it when it returns True (callers whose emit
        filters further decide presence themselves)."""
        chunk_target = chunk_bytes or max(self.segment_bytes,
                                          FILE_CHUNK_BYTES)
        matched: list[np.ndarray] = []
        n_matches = total = lines_before = 0
        read_wait = 0.0
        totals: dict = {}

        def scan_piece(buf: bytes, key=None) -> None:
            nonlocal n_matches, total, lines_before
            res = self._scan(buf, progress=progress, corpus_key=key)
            for k, v in self.stats.items():
                totals[k] = totals.get(k, 0) + v
            total += len(buf)
            n_matches += res.n_matches
            nl = res.nl_index
            if res.matched_lines.size:
                if (emit is not None or emit_chunk is not None) and nl is None:
                    nl = newline_index(buf)
                if emit is not None:
                    starts, ends = line_spans(res.matched_lines, nl, len(buf))
                    for ln, s_, e_ in zip(res.matched_lines.tolist(),
                                          starts.tolist(), ends.tolist()):
                        emit(lines_before + ln, buf[s_:e_])
                elif emit_chunk is not None:
                    emit_chunk(lines_before, buf, res.matched_lines, nl)
                matched.append(res.matched_lines + lines_before)
            lines_before += (count_lines(buf) if nl is None else
                             nl.size + (0 if buf.endswith(b"\n") else 1))
            if progress is not None:
                progress()

        def finish(reads: int) -> ScanResult:
            totals["read_wait_seconds"] = read_wait
            totals["file_reads"] = reads
            self._add_totals({"read_wait_seconds": read_wait,
                              "file_reads": reads})
            _stamp_counters(totals)
            self.stats = totals
            ml = (np.concatenate(matched) if matched
                  else np.zeros(0, dtype=np.int64))
            return ScanResult(ml, n_matches, total)

        # the shard index: a summary that rules the query out returns the
        # exact empty result before the file is opened; a maybe, or no
        # summary yet, scans, and a scan of the whole file (one chunk)
        # publishes its summary where one can be read again
        idx_req = self._index_requirements()
        idx_key = None
        idx_pub = False
        if idx_req is not None:
            from distributed_grep_tpu_torch.index import summary as index_summary

            # the stat only where a lookup could answer or a publish land
            if index_summary.may_route() or self._index_publish_enabled():
                idx_key = file_content_key(path)
            if idx_key is not None:
                summ = index_summary.lookup_summary(idx_key)
                if summ is not None:
                    if not idx_req.may_match(summ):
                        return self._index_pruned(idx_key)
                    index_summary.record_maybe()
                    spans_mod.instant("index:maybe", cat="engine")
                else:
                    idx_pub = (0 < idx_key.n_bytes <= chunk_target
                               and self._index_publish_enabled())

        corpus_k = None
        if self._corpus_opt_in():
            # one stat serves both tiers: the key the index took
            k = idx_key if idx_key is not None else file_content_key(path)
            if (k is not None and 0 < k.n_bytes <= chunk_target
                    and not self._small_for_device(k.n_bytes)):
                corpus_k = k
                ent = corpus_cache().lookup(k)
                if ent is not None and len(ent.data) == k.n_bytes:
                    # warm: the entry's bytes stand in for the read
                    corpus_cache().count_host_hit()
                    scan_piece(ent.data, k)
                    if idx_pub:
                        self._index_publish(k, ent.data)
                    return finish(0)
        whole_k = corpus_k if corpus_k is not None else (
            idx_key if idx_pub else None)

        pending: Future | None = None
        carry = b""
        with open(path, "rb") as f:
            st = os.fstat(f.fileno())
            size = st.st_size if stat.S_ISREG(st.st_mode) else None
            pos = 0
            try:
                t0 = time.perf_counter()
                block = f.read(chunk_target)
                read_wait += time.perf_counter() - t0
                while True:
                    # a regular file ends at its size at open: its last
                    # block takes the carried line and its own tail whole
                    first = pos == 0
                    pos += len(block)
                    more = len(block) == chunk_target and (
                        size is None or pos < size)
                    if more:
                        pending = _thread_reader().submit(f.read,
                                                          chunk_target)
                    buf = carry + block
                    if more:
                        cut = buf.rfind(b"\n")  # -1: the line grows on
                        carry, buf = buf[cut + 1:], buf[: cut + 1]
                    key = whole = None
                    if (whole_k is not None and first and not more
                            and len(buf) == whole_k.n_bytes
                            and file_content_key(path) == whole_k):
                        # the whole keyed file, unchanged
                        key = corpus_k
                        whole = buf if idx_pub else None
                    if buf:
                        scan_piece(buf, key)
                        if whole is not None:  # the scan succeeded
                            self._index_publish(idx_key, whole)
                        if (stop_after_match and n_matches) or (
                                stop is not None and stop()):
                            break
                    if not more:
                        break
                    t0 = time.perf_counter()
                    block = pending.result() if pending is not None else b""
                    pending = None
                    read_wait += time.perf_counter() - t0
            finally:
                # the read in flight must not outlive the file handle
                if pending is not None and not pending.cancel():
                    try:
                        pending.result()
                    except Exception:  # noqa: BLE001 -- the handle closes next
                        pass
        return finish(1)

    def scan_file_suffix(self, path, offset: int = 0, *, final: bool = False,
                         max_bytes: int | None = None, progress=None):
        """Scan the live-append suffix of ``path`` from ``offset`` (a line
        start) to its last complete line (the reference's engine.py:1819).
        Returns ``(result, consumed, data)``: the result over the suffix
        (1-based lines local to it), the bytes consumed (the caller's
        cursor advance) and the bytes scanned.

        The partial tail past the last newline is not consumed: the next
        call reads it again from the same offset, grown by what arrived, so
        the lines match a one-shot scan of the final file.  ``final``
        takes an unterminated tail too.  ``max_bytes`` (default the larger
        of the segment size and FILE_CHUNK_BYTES) caps one call's read;
        a capped read is cut at its last newline even when ``final``,
        except that a read holding no newline grows until one (or the
        file's end) arrives, so one line longer than the cap cannot stall
        the cursor.  The suffix is never keyed into the corpus cache: a
        growing file has no stable stat."""
        cap = max_bytes or max(self.segment_bytes, FILE_CHUNK_BYTES)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(cap)
            # the read filled its request: the file may go on past it
            window_full = len(data) == cap
            if window_full and data.rfind(b"\n") < 0:
                while True:
                    more = f.read(cap)
                    if not more:
                        window_full = False
                        break
                    data += more
                    window_full = len(more) == cap
                    if not window_full or more.rfind(b"\n") >= 0:
                        break
        if not final or window_full:
            cut = data.rfind(b"\n")
            data = data[: cut + 1] if cut >= 0 else b""
        if not data:
            return ScanResult(np.zeros(0, dtype=np.int64), 0, 0), 0, b""
        res = self._scan(data, progress=progress)
        self.stats["suffix_bytes_scanned"] = len(data)
        _stamp_counters(self.stats)
        return res, len(data), data

    def scan_batch(self, items, progress=None, emit=None,
                   index_prune: bool = False):
        """Scan many inputs, small ones packed together (the reference's
        engine.py:1887).

        ``items`` are ``(name, data)`` pairs, ``data`` bytes or a path
        (read whole: callers stream large files through scan_file).  An
        input below ``device_min_bytes`` joins a BatchPacker; the packed
        window is scanned once whenever the next input would take it past
        ``batch_bytes``.  A larger input (or any, with ``batch_bytes`` 0)
        first flushes the pending window, keeping the order, and scans
        alone.  Returns ``[(name, ScanResult)]`` in input order, each with
        the member's own 1-based lines and its original length as
        ``bytes_scanned``; ``emit(name, data, result)`` is called per input
        while its bytes are in hand.

        With the corpus cache on, path items are keyed: solo files and
        packed windows publish their segments, and a repeat call over
        unchanged files takes bytes and segments from the cache.  A warm
        window is recognized from its first member's path before any
        member is read (fresh stats of every member must match).

        The shard index (path items): a member whose summary rules the
        query out is, with ``index_prune``, never opened and emitted as
        ``(name, b"", empty result)`` -- the caller's word that an empty
        emit means what the real one would (true for printed lines and
        counts, false for -v, whose app passes False and keeps every
        read); a warm window whose summary rules the query out emits its
        cached members with empty results and launches nothing.  Members
        read cold publish their summaries after their scan succeeded
        (where a summary can be read again: ``_index_publish_enabled``),
        and a packed window its own in the corpus cache's regime.

        ``stats`` then hold the scans' summed counters and
        ``batched_files``, ``batch_dispatches``, ``solo_dispatches``,
        ``dispatches_saved`` (batched_files - batch_dispatches),
        ``batch_fill_ratio`` (the mean window fill against batch_bytes),
        ``file_reads`` and ``read_wait_seconds``; ``totals`` get the
        counts and ``batch_fill_sum``."""
        cap = max(0, int(self.batch_bytes))
        packer = BatchPacker(cap) if cap > 0 else None
        cache = corpus_cache() if self._corpus_opt_in() else None
        idx_req = self._index_requirements()
        idx_on = idx_req is not None
        idx_pub_ok = idx_on and self._index_publish_enabled()
        if idx_on:
            from distributed_grep_tpu_torch.index import summary as index_summary

            # no lookup could answer and no publish land: no stats taken
            idx_on = index_summary.may_route() or idx_pub_ok
        pk_keys: list = []  # member keys, parallel to the packer
        pk_pub: list = []  # (key, bytes) to publish after the scan, ditto
        out: list = []
        scanned: dict = {}
        bst = {"batched_files": 0, "batch_dispatches": 0,
               "solo_dispatches": 0, "batch_fill_sum": 0.0,
               "file_reads": 0, "read_wait_seconds": 0.0}

        def run_scan(data: bytes, key) -> ScanResult:
            res = self._scan(data, progress=progress, corpus_key=key)
            for k, v in self.stats.items():
                scanned[k] = scanned.get(k, 0) + v
            return res

        def handle(name, data, res) -> None:
            if emit is not None:
                emit(name, data, res)
            out.append((name, res))

        def scan_packed(batch, names, win_key) -> None:
            """One packed window: scan, demux, a result a member (and a
            ``scan:batch`` span inside a span pipeline task context)."""
            t0_wall, t0 = time.time(), time.perf_counter()
            res = run_scan(batch.data, win_key)
            if cache is not None and win_key is not None:
                cache.attach_batch(win_key, batch)
                if idx_on and index_summary.lookup_summary(win_key) is None:
                    # the window's own summary, for the warm window's
                    # prune; trigrams across member edges only add bits
                    self._index_publish(win_key, batch.data)
            bst["batched_files"] += len(batch)
            bst["batch_dispatches"] += 1
            bst["batch_fill_sum"] += len(batch.data) / cap
            if spans_mod.active():
                spans_mod.complete(
                    "scan:batch", t0_wall, time.perf_counter() - t0,
                    cat="engine", mode=self.mode, files=len(batch),
                    bytes=len(batch.data), matches=res.n_matches,
                    fill_ratio=round(len(batch.data) / cap, 6))
            for name, blob, lines in zip(names, batch.member_blobs(),
                                         batch.demux(res.matched_lines)):
                handle(name, blob, ScanResult(lines.astype(np.int64),
                                              int(lines.size), len(blob)))

        def flush() -> None:
            nonlocal pk_keys, pk_pub
            if packer is None:
                return
            keys, pk_keys = pk_keys, []
            pubs, pk_pub = pk_pub, []
            batch = packer.pack()
            if batch is None:
                return
            if len(batch) == 1:  # nothing to share: the blob alone
                bst["solo_dispatches"] += 1
                handle(batch.names[0], batch.blobs[0],
                       run_scan(batch.blobs[0], keys[0]))
            else:
                scan_packed(batch, batch.names,
                            batch_content_key(keys) if cache else None)
            for ent in pubs:  # the members' scan succeeded
                if ent is not None:
                    self._index_publish(*ent)

        def match_window(i: int, stored) -> list | None:
            """Fresh keys of items[i:...] when they are the paths of the
            stored window's members, in order; else None."""
            ids = stored.identity[1]
            if i + len(ids) > len(items):
                return None
            keys = []
            for (_name, d), ident in zip(items[i:i + len(ids)], ids):
                if isinstance(d, (bytes, bytearray, memoryview)):
                    return None
                k = file_content_key(d)
                if k is None or k.identity != ident:
                    return None
                keys.append(k)
            return keys

        items = list(items)  # the warm-window probe looks ahead
        i = 0
        while i < len(items):
            name, data = items[i]
            is_blob = isinstance(data, (bytes, bytearray, memoryview))
            fk = (file_content_key(data)
                  if (cache is not None or idx_on) and not is_blob else None)
            if cache is not None and fk is not None and packer is not None:
                stored = cache.window_for(fk)
                keys = match_window(i, stored) if stored is not None else None
                if keys is not None:
                    wk = batch_content_key(keys)
                    ent = cache.lookup(wk)
                    # a window packed under a larger cap is not served
                    # once batch_bytes shrinks: it is packed anew
                    if (ent is not None and ent.batch is not None
                            and len(ent.batch.data) <= cap):
                        names = [nm for nm, _ in items[i:i + len(keys)]]
                        wsum = None
                        if idx_on:
                            wsum = (ent.summary if ent.summary is not None
                                    else index_summary.lookup_summary(wk))
                        if wsum is not None and not idx_req.may_match(wsum):
                            # the whole warm window cannot match: its
                            # members' cached bytes with empty results
                            # (exact for every caller, -v included)
                            flush()
                            index_summary.record_prune(wk.n_bytes)
                            spans_mod.instant("index:prune", cat="engine",
                                              bytes=wk.n_bytes)
                            for nm, blob in zip(names,
                                                ent.batch.member_blobs()):
                                handle(nm, blob, ScanResult(
                                    np.zeros(0, dtype=np.int64), 0,
                                    len(blob)))
                            i += len(keys)
                            continue
                        if wsum is not None:
                            index_summary.record_maybe()
                        flush()
                        cache.count_host_hit()
                        scan_packed(ent.batch, names, wk)
                        if idx_pub_ok:
                            # the members' own summaries, from the cached
                            # bytes: the planner prunes by member
                            for mk, blob in zip(keys,
                                                ent.batch.member_blobs()):
                                if index_summary.lookup_summary(mk) is None:
                                    self._index_publish(mk, blob)
                        i += len(keys)
                        continue
            i += 1
            idx_missing = False  # publish this member after its scan
            if idx_on and fk is not None:
                summ = index_summary.lookup_summary(fk)
                if summ is None:
                    idx_missing = idx_pub_ok
                elif not idx_req.may_match(summ):
                    if index_prune:
                        # never opened: the caller takes the empty emit
                        flush()  # the pending window first: order kept
                        index_summary.record_prune(fk.n_bytes)
                        spans_mod.instant("index:prune", cat="engine",
                                          bytes=fk.n_bytes)
                        handle(name, b"", ScanResult(
                            np.zeros(0, dtype=np.int64), 0, 0))
                        continue
                    # the caller needs the bytes (-v): scanned as usual
                else:
                    index_summary.record_maybe()
            if not is_blob:
                ent = (cache.lookup(fk)
                       if cache is not None and fk is not None else None)
                if ent is not None and len(ent.data) == fk.n_bytes:
                    data = ent.data  # warm bytes: no read
                    cache.count_host_hit()
                else:
                    t0 = time.perf_counter()
                    with open(os.fspath(data), "rb") as f:
                        data = f.read()
                    bst["read_wait_seconds"] += time.perf_counter() - t0
                    bst["file_reads"] += 1
                    if fk is not None and (
                            len(data) != fk.n_bytes
                            or file_content_key(items[i - 1][1]) != fk):
                        fk = None  # changed between stat and read: uncached
            data = bytes(data)
            if (packer is None or len(data) >= self.device_min_bytes
                    or packed_size(data) > cap):
                flush()  # the pending window first: order kept
                bst["solo_dispatches"] += 1
                handle(name, data,
                       run_scan(data, fk if cache is not None else None))
                if idx_missing and fk is not None:
                    self._index_publish(fk, data)
                continue
            if not packer.fits(data):
                flush()
            packer.add(name, data)
            pk_keys.append(fk if cache is not None else None)
            pk_pub.append((fk, data) if idx_missing and fk is not None
                          else None)
        flush()
        counts = {k: bst[k] for k in ("batched_files", "batch_dispatches",
                                      "solo_dispatches")}
        counts["dispatches_saved"] = (bst["batched_files"]
                                      - bst["batch_dispatches"])
        self._add_totals({**counts, "batch_fill_sum": bst["batch_fill_sum"],
                          "file_reads": bst["file_reads"],
                          "read_wait_seconds": bst["read_wait_seconds"]})
        scanned.update(counts)
        scanned["batch_fill_ratio"] = (
            round(bst["batch_fill_sum"] / bst["batch_dispatches"], 6)
            if bst["batch_dispatches"] else 0.0)
        scanned["file_reads"] = bst["file_reads"]
        scanned["read_wait_seconds"] = bst["read_wait_seconds"]
        _stamp_counters(scanned)
        self.stats = scanned
        return out


__all__ = [
    "DEFAULT_MODEL_CACHE_ENTRIES",
    "DEFAULT_SEGMENT_BYTES",
    "DEFAULT_TARGET_LANES",
    "GrepEngine",
    "PatternPlan",
    "RegexError",
    "SPAN_CONFIRM_LINE_LIMIT",
    "ScanResult",
    "cached_engine",
    "check_approx",
    "check_pattern",
    "check_patterns",
    "FILE_CHUNK_BYTES",
    "HOST_CHUNK",
    "invalidate_cached_engine",
    "lines_match",
    "model_cache_clear",
    "model_cache_counters",
]
