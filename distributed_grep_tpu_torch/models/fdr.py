"""FDR bucketed literal-set filter model (Hyperscan's large-set idea).

Large literal sets (BASELINE configs 3 and 5: ``grep -F -f`` lists and
Snort-style rulesets) have no small automaton.  FDR superimposes the set
into 32 *buckets* (one uint32 per lane), filters the stream with
per-position reach tables of byte-pair hashes, and leaves the rare
candidates to an exact confirm (ops/confirm_set.py).

* One *suffix window* per bank: every member is represented by its last
  ``m+1`` bytes, so candidates stay a superset of the matches.
* Reach tables are indexed by the pair hash ``h = ((b0*a) ^ (b1*b)) &
  (D-1)`` of two consecutive bytes; each check picks its own domain D from
  ``DOMAINS``.  Domains nest (``h_D == h_D' & (D-1)``), so a kernel hashes
  once per family and masks per check.
* Cell-snapped clustered buckets: members sorted by their final-pair hash
  at D=128, buckets are runs of whole hash cells, so the clustered check's
  bucket densities sum to exactly 1 at the smallest domain.
* A check plan of ``(slot, family, domain)`` lookups: slot k covers the
  pair at depth m-1-k from the window end; checks sharing a slot AND
  together before entering the m-stage pipeline.  The tuner enumerates
  filler domains, lookup counts and bank counts, and minimizes a cost
  model of scan plus expected confirm, with candidate rates computed
  exactly from the built tables (``_fp_of_tables``).

This is the port's own copy of the reference model
(``distributed_grep_tpu/models/fdr.py``), plan for plan: the same tables
for the same set and pricing.  Its tuner constants are the reference's
(priced for the reference's TPU kernel and its native confirm), kept so
that plans stay equal; pricing them for the H100 is later work (ROADMAP
section A).  Two parts of the reference stay out: the native-scanner
crossover (the port routes no scan to a host scanner, so ``compile_fdr``
never cedes a set to one) and the confirm probe used by its
self-calibration.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

NL = 0x0A
N_BUCKETS = 32
MAX_DEPTHS = 6  # pipeline slots; window = depths + 1 <= 7 bytes
DOMAINS = (128, 256, 512, 1024)  # one "gather" per 128 entries of a check
CLUSTER_DOMAIN = 128  # the clustered check's domain: sum-density 1
# Two independent pair hash families; ANDing lookups of both at one slot
# squares that slot's density, which beats more banks for dense sets.
HASHES = ((37, 101), (171, 59))
# A set whose best expected candidate rate (analytic x bias) is above
# this is not worth filtering: compile_fdr raises.
FP_CEILING_PER_BYTE = 1e-1

# The tuner's cost model, per scanned byte, in the reference's units: a
# 128-entry table gather of its TPU kernel, and one candidate of its
# native confirm.  They rank plans; they are not times of this port.
COST_PS_PER_GATHER = 4.7
CONFIRM_PS_PER_CANDIDATE = 8_600.0


def _confirm_threads() -> int:
    """Confirm threads the tuner prices against: DGREP_CONFIRM_THREADS,
    default 8 (the reference's rule, so both pick the same plans)."""
    try:
        return max(1, int(os.environ.get("DGREP_CONFIRM_THREADS", "8")))
    except ValueError:
        return 8


CONFIRM_THREADS = _confirm_threads()
# Measured candidate rates run above the analytic model (checks of one
# pair are correlated through the shared set); the tuner prices confirm
# with this bias and ranks plans by the analytic value.
EMPIRICAL_FP_BIAS = 2.5
OVERLAP_RESIDUE = 0.2  # fraction of the smaller leg that fails to overlap
# Ceiling on 128-entry gathers per byte of one bank's plan.
MAX_GATHERS = 64


@dataclass(frozen=True)
class Pricing:
    """The tuner's cost constants as one value."""

    confirm_ps_per_candidate: float  # single-thread wall, ps
    confirm_threads: int
    fp_bias: float  # measured / analytic candidate-rate ratio
    overlap_residue: float
    n_chips: int = 1  # chips sharing one host's confirm threads

    def confirm_wall_ps(self, fp_per_byte: float) -> float:
        """Expected per-byte confirm wall given an analytic fp rate."""
        return (
            fp_per_byte * self.fp_bias
            * self.confirm_ps_per_candidate
            * self.n_chips / self.confirm_threads
        )

    def total_ps(self, scan_ps: float, fp_per_byte: float) -> float:
        confirm = self.confirm_wall_ps(fp_per_byte)
        return max(scan_ps, confirm) + self.overlap_residue * min(scan_ps, confirm)


def default_pricing() -> Pricing:
    """The module constants (read at call time)."""
    return Pricing(
        confirm_ps_per_candidate=CONFIRM_PS_PER_CANDIDATE,
        confirm_threads=CONFIRM_THREADS,
        fp_bias=EMPIRICAL_FP_BIAS,
        overlap_residue=OVERLAP_RESIDUE,
    )


def pair_hash(b0: np.ndarray | int, b1: np.ndarray | int, domain: int, which: int = 0):
    """The pair-domain hash shared by the tables and the kernels.
    Domains nest: ``pair_hash(.., D) == pair_hash(.., D') & (D-1)`` for
    D <= D'."""
    a, b = HASHES[which]
    return ((b0 * a) ^ (b1 * b)) & (domain - 1)


class FdrError(ValueError):
    pass


@dataclass(frozen=True)
class FdrBank:
    """One filter pass: a check plan over an m-slot pipeline.

    ``checks[i] = (slot, family, domain)``: lookup i probes ``tables[i]``
    (a (domain,) uint32 bucket-mask array) with hash family ``family`` of
    the byte pair at slot ``slot``; slot k is applied k steps after the
    oldest check, so it covers the pair at depth m-1-k from the window
    end.  Checks sharing a slot AND together before entering the
    pipeline."""

    m: int  # pipeline slots (window = m+1 bytes)
    checks: tuple[tuple[int, int, int], ...]  # (slot, family, domain)
    tables: tuple[np.ndarray, ...]  # per check: (domain,) uint32 bucket masks
    patterns: list[bytes]  # normalized members of this bank
    fp_per_byte: float  # expected candidate rate on uniform bytes

    @property
    def n_checks(self) -> int:
        return len(self.checks)

    @property
    def domain(self) -> int:
        """Largest check domain."""
        return max(d for _, _, d in self.checks)

    @property
    def families(self) -> tuple[int, ...]:
        return tuple(sorted({f for _, f, _ in self.checks}))

    @property
    def total_gathers(self) -> int:
        return sum(d // 128 for _, _, d in self.checks)

    def scan_cost_ps(self) -> float:
        """The tuner's per-byte scan cost."""
        return COST_PS_PER_GATHER * self.total_gathers


@dataclass(frozen=True)
class FdrModel:
    banks: list[FdrBank]
    ignore_case: bool
    n_patterns: int

    @property
    def fp_per_byte(self) -> float:
        return float(sum(b.fp_per_byte for b in self.banks))

    def scan_cost_ps(self) -> float:
        return sum(b.scan_cost_ps() for b in self.banks)

    @property
    def window(self) -> int:
        """Largest filter window: a kernel can miss a match only when it
        ends within window-1 bytes after a stripe start (the stitch)."""
        return max(b.m for b in self.banks) + 1


def fdr_bank_from_arrays(
    m: int, checks, tables, patterns, fp_per_byte: float
) -> FdrBank:
    """Build a bank from plain arrays and lists -- the state a compiled
    set carries (a grep system has no weights; its compiled tables are
    what two implementations must share).  Copies every table to a fresh
    contiguous uint32 array and checks the plan against it."""
    checks = tuple((int(s), int(f), int(d)) for s, f, d in checks)
    tabs = tuple(np.ascontiguousarray(np.asarray(t, dtype=np.uint32)).copy()
                 for t in tables)
    if not 1 <= int(m) <= MAX_DEPTHS or not checks or len(tabs) != len(checks):
        raise ValueError(f"bank needs 1..{MAX_DEPTHS} slots and one table "
                         f"per check, got m={m}, {len(checks)} checks, "
                         f"{len(tabs)} tables")
    for (slot, fam, dom), t in zip(checks, tabs):
        if (not 0 <= slot < int(m) or fam not in (0, 1) or dom not in DOMAINS
                or t.shape != (dom,)):
            raise ValueError(f"bad check ({slot}, {fam}, {dom}) with table "
                             f"of shape {t.shape}")
    return FdrBank(m=int(m), checks=checks, tables=tabs,
                   patterns=[bytes(p) for p in patterns],
                   fp_per_byte=float(fp_per_byte))


def _normalize(patterns: list[str | bytes], ignore_case: bool) -> list[bytes]:
    out: list[bytes] = []
    for p in patterns:
        b = p.encode("utf-8", "surrogateescape") if isinstance(p, str) else bytes(p)
        if not b:
            raise FdrError("empty literal in pattern set")
        if NL in b:
            raise FdrError("literal contains '\\n' -- not representable per-line")
        out.append(b.lower() if ignore_case else b)
    return out


def _bucket_of(group: list[bytes]) -> np.ndarray:
    """Cell-snapped clustered bucket assignment: sort members by their
    final-pair hash at CLUSTER_DOMAIN and pack whole hash cells into
    buckets of about equal member counts.  No cell is split, so bucket b's
    density at the clustered check is cells(b) / CLUSTER_DOMAIN and the
    densities sum to 1."""
    n = len(group)
    cells = [int(pair_hash(p[-2], p[-1], CLUSTER_DOMAIN)) for p in group]
    order = sorted(range(n), key=lambda i: (cells[i], group[i]))
    bucket = np.zeros(n, dtype=np.int64)
    b = 0
    for rank, i in enumerate(order):
        want = min(N_BUCKETS - 1, rank * N_BUCKETS // n)
        if want > b and cells[i] != cells[order[rank - 1]]:
            b = want
        bucket[i] = b
    return bucket


def _pair_arrays(group: list[bytes], m: int) -> tuple[np.ndarray, np.ndarray]:
    """(m, n) arrays of the byte pair at each depth d from the suffix end."""
    b0 = np.empty((m, len(group)), dtype=np.int64)
    b1 = np.empty((m, len(group)), dtype=np.int64)
    for d in range(m):
        for i, p in enumerate(group):
            b0[d, i] = p[len(p) - 2 - d]
            b1[d, i] = p[len(p) - 1 - d]
    return b0, b1


def _build_tables(
    group: list[bytes],
    bucket: np.ndarray,
    m: int,
    checks: tuple[tuple[int, int, int], ...],
    pair_cache: dict | None = None,
) -> tuple[np.ndarray, ...]:
    """Reach tables for one check plan (vectorized over members)."""
    if pair_cache is None or "pairs" not in pair_cache:
        pairs = _pair_arrays(group, m)
        if pair_cache is not None:
            pair_cache["pairs"] = pairs
    else:
        pairs = pair_cache["pairs"]
    b0, b1 = pairs
    bits = (np.uint32(1) << bucket.astype(np.uint32)).astype(np.uint32)
    out = []
    for slot, fam, domain in checks:
        key = (slot, fam, domain)
        if pair_cache is not None and key in pair_cache:
            out.append(pair_cache[key])
            continue
        d = m - 1 - slot
        idx = pair_hash(b0[d], b1[d], domain, which=fam)
        t = np.zeros(domain, dtype=np.uint32)
        np.bitwise_or.at(t, idx, bits)
        if pair_cache is not None:
            pair_cache[key] = t
        out.append(t)
    return tuple(out)


def _fp_of_tables(tables: tuple[np.ndarray, ...]) -> float:
    """Expected candidate probability per byte on uniform random pairs:
    the sum over buckets of the product over checks of that bucket's
    density (checks treated as independent)."""
    prod = np.ones(N_BUCKETS, dtype=np.float64)
    for t in tables:
        bits = (t[:, None] >> np.arange(N_BUCKETS, dtype=np.uint32)) & 1
        prod *= bits.sum(axis=0) / t.shape[0]
    return float(prod.sum())


def _filler_slots(m: int) -> list[tuple[int, int]]:
    """Filler priority: family 0 from the deepest unused slot down, then
    family 1 (slot m-1 first: it shares the clustered pair)."""
    return [(k, 0) for k in range(m - 2, -1, -1)] + [
        (k, 1) for k in range(m - 1, -1, -1)
    ]


def _plans(m: int):
    """Every candidate check plan: the clustered check (slot m-1, family
    0) at CLUSTER_DOMAIN plus every multiset of filler domains, the largest
    domains on the highest-priority fillers."""
    from itertools import combinations_with_replacement

    slots = _filler_slots(m)
    for n_fill in range(1, len(slots) + 1):
        for doms in combinations_with_replacement(DOMAINS, n_fill):
            ds = sorted(doms, reverse=True)
            yield ((m - 1, 0, CLUSTER_DOMAIN),) + tuple(
                (k, f, d) for (k, f), d in zip(slots, ds)
            )


def _compress_banks(banks: list[FdrBank]) -> list[FdrBank]:
    """Drop pipeline slots no check probes: remapping every check to slot
    m'-1-depth with m' = max depth + 1 gives the same candidates except
    fewer at stripe heads (the all-ones seed covers m' positions), and a
    shorter stitch window."""
    out = []
    for b in banks:
        depths = [b.m - 1 - slot for slot, _, _ in b.checks]
        m_eff = max(depths) + 1
        if m_eff == b.m:
            out.append(b)
            continue
        checks = tuple(
            (m_eff - 1 - d, fam, dom)
            for d, (_, fam, dom) in zip(depths, b.checks)
        )
        out.append(FdrBank(
            m=m_eff, checks=checks, tables=b.tables,
            patterns=b.patterns, fp_per_byte=b.fp_per_byte,
        ))
    return out


def _compile_group(
    group: list[bytes], m: int, fp_budget: float, max_banks: int = 4,
    pricing: Pricing | None = None,
) -> list[FdrBank]:
    """Pick (filler domains, lookup count, bank count) for one window
    group by minimizing the cost model (scan + expected confirm,
    overlapped), preferring configurations within the budget."""
    pricing = pricing or default_pricing()
    total_ps = pricing.total_ps

    best: tuple[tuple, list[FdrBank]] | None = None
    for n_banks in (1, 2, 4):
        if n_banks > max_banks or (n_banks > 1 and len(group) < n_banks * N_BUCKETS):
            continue
        shards = [group[i::n_banks] for i in range(n_banks)]
        buckets = [_bucket_of(s) for s in shards]
        caches = [{} for _ in shards]
        for plan in _plans(m):
            gathers = sum(d // 128 for _, _, d in plan)
            if gathers > MAX_GATHERS:
                continue
            # the scan leg alone bounds the total from below: once a
            # within-budget best exists, a costlier scan cannot win
            if (
                best is not None
                and best[0][0] == 0
                and COST_PS_PER_GATHER * gathers * len(shards) > best[0][1]
            ):
                continue
            banks = []
            for shard, bucket, cache in zip(shards, buckets, caches):
                tabs = _build_tables(shard, bucket, m, plan, cache)
                banks.append(
                    FdrBank(
                        m=m,
                        checks=plan,
                        tables=tabs,
                        patterns=shard,
                        fp_per_byte=_fp_of_tables(tabs),
                    )
                )
            fp = sum(b.fp_per_byte for b in banks)
            cost = sum(b.scan_cost_ps() for b in banks)
            within = fp * pricing.fp_bias <= fp_budget
            key = (0, total_ps(cost, fp)) if within else (1, fp, cost)
            if best is None or key < best[0]:
                best = (key, banks)
    assert best is not None
    return _compress_banks(best[1])


def compile_fdr(
    patterns: list[str | bytes],
    *,
    ignore_case: bool = False,
    fp_budget_per_byte: float = FP_CEILING_PER_BYTE,
    max_banks: int = 4,
    pricing: Pricing | None = None,
) -> FdrModel:
    """Compile a literal set (every member >= 2 bytes) into filter banks.

    The window is set by the shortest member.  Where the set's lengths are
    mixed enough that splitting pays, the tuner compares every two-group
    split against the single group by total cost.  Raises FdrError for
    sets this filter cannot host."""
    pricing = pricing or default_pricing()
    norm = _normalize(patterns, ignore_case)
    if not norm:
        raise FdrError("empty pattern set")
    if any(len(p) < 2 for p in norm):
        raise FdrError("FDR needs literals >= 2 bytes")

    def window_of(subset: list[bytes]) -> int:
        return min(MAX_DEPTHS + 1, min(len(p) for p in subset))

    def group_cost(banks: list[FdrBank]) -> float:
        scan = sum(b.scan_cost_ps() for b in banks)
        return pricing.total_ps(scan, sum(b.fp_per_byte for b in banks))

    candidates: list[list[FdrBank]] = []
    single = _compile_group(
        norm, window_of(norm) - 1, fp_budget_per_byte, max_banks, pricing
    )
    candidates.append(single)
    lengths = sorted({min(len(p), MAX_DEPTHS + 1) for p in norm})
    for t in lengths[1:]:
        short = [p for p in norm if min(len(p), MAX_DEPTHS + 1) < t]
        long_ = [p for p in norm if min(len(p), MAX_DEPTHS + 1) >= t]
        if len(short) < N_BUCKETS or len(long_) < N_BUCKETS:
            continue
        candidates.append(
            _compile_group(short, window_of(short) - 1, fp_budget_per_byte / 2,
                           max_banks, pricing)
            + _compile_group(long_, window_of(long_) - 1, fp_budget_per_byte / 2,
                             max_banks, pricing)
        )
    banks = min(candidates, key=group_cost)
    model = FdrModel(banks=banks, ignore_case=ignore_case, n_patterns=len(norm))
    # gate on the EXPECTED rate (analytic x bias), like the cost model
    if model.fp_per_byte * pricing.fp_bias > FP_CEILING_PER_BYTE:
        raise FdrError(
            f"set too dense to filter: expected candidate rate "
            f"{model.fp_per_byte * pricing.fp_bias:.3g}/byte "
            f"(analytic x{pricing.fp_bias:g} bias) > {FP_CEILING_PER_BYTE:g}"
        )
    return model


# ------------------------------------------------------------------ oracles

def reference_candidates(bank: FdrBank, data: bytes) -> np.ndarray:
    """NumPy oracle of one bank's filter over a single stripe: candidate
    end offsets (i+1).  Mirrors the kernels, including ``prev = 0`` and the
    all-ones pipeline seed at the stripe start."""
    arr = np.frombuffer(data, dtype=np.uint8).astype(np.int64)
    n = arr.size
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    prev = np.concatenate([[0], arr[:-1]])
    ones = np.uint32(0xFFFFFFFF)
    slot_masks = np.full((bank.m, n), ones, dtype=np.uint32)
    for i, (slot, fam, domain) in enumerate(bank.checks):
        h = pair_hash(prev, arr, domain, which=fam)
        slot_masks[slot] &= bank.tables[i][h]
    # pipeline: V_0(t) = masks[0, t]; V_k(t) = V_{k-1}(t-1) & masks[k, t]
    Vs = np.empty((bank.m, n), dtype=np.uint32)
    Vs[0] = slot_masks[0]
    for k in range(1, bank.m):
        shifted = np.concatenate([[ones], Vs[k - 1][:-1]])
        Vs[k] = shifted & slot_masks[k]
    return np.nonzero(Vs[bank.m - 1] != 0)[0].astype(np.int64) + 1


def reference_candidates_model(model: FdrModel, data: bytes) -> np.ndarray:
    """Union of the banks' candidate end offsets."""
    if model.ignore_case:
        data = bytes(data).lower()
    outs = [reference_candidates(b, data) for b in model.banks]
    return np.unique(np.concatenate(outs)) if outs else np.zeros(0, dtype=np.int64)
