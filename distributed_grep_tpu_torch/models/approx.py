"""Approximate (edit distance <= k) matching: the agrep model family.

Wu and Manber's bit-parallel formulation ("Fast text searching allowing
errors", CACM 1992) over the Shift-And symbol model: the automaton state
is k+1 uint32 rows per lane, one per error budget, and a byte step is
shift/and/or arithmetic on those rows.

Recurrence (per byte c, rows R_0..R_k, B from the Shift-And model):

    R_0' = ((R_0 << 1) | 1) & B[c]
    R_j' = (((R_j << 1) | 1) & B[c])      exact extension
         | R_{j-1}                        insertion  (text char inserted)
         | (R_{j-1} << 1)                 substitution
         | (R'_{j-1} << 1)                deletion   (pattern char skipped)
         | ((1 << j) - 1)                 seed: bits < j are always live
                                          (prefix p[0..i] reaches any text
                                          position within i+1 <= j edits)

Bit i of R_j = "pattern prefix p[0..i] matches a suffix of the text read
so far with <= j errors"; a match ends wherever bit m-1 of R_k is set.

Line semantics: grep matches within lines, so every '\\n' resets the rows
to their line-start seeds R_j = (1<<j)-1 *before* the match check -- an
errorful match never spans or consumes a newline.  A pattern of length
<= k matches every line (delete the whole pattern); the engine routes it
as "all_lines".

Eligibility: any Shift-And-eligible pattern (literal / class sequence,
<= 32 symbols) with 1 <= k < length, k <= MAX_ERRORS.  On the card the
recurrence runs in csrc/approx.cu (ops/approx_scan.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from distributed_grep_tpu_torch.models.shift_and import (
    ShiftAndModel,
    model_from_arrays,
    try_compile_shift_and,
)

NL = 0x0A
MAX_ERRORS = 3  # k+1 state rows per lane


@dataclass
class ApproxModel:
    """Shift-And B-masks plus an error budget."""

    base: ShiftAndModel
    k: int

    @property
    def length(self) -> int:
        return self.base.length

    @property
    def match_bit(self) -> np.uint32:
        return self.base.match_bit

    @property
    def seeds(self) -> list[int]:
        """Line-start row seeds: R_j starts with j leading deletions."""
        return [(1 << j) - 1 for j in range(self.k + 1)]


def try_compile_approx(
    pattern: str, k: int, ignore_case: bool = False
) -> ApproxModel | None:
    """Compile if ``pattern`` is Shift-And-eligible and 1 <= k < length."""
    if not 1 <= k <= MAX_ERRORS:
        return None
    base = try_compile_shift_and(pattern, ignore_case=ignore_case)
    if base is None or base.length <= k:
        return None
    return ApproxModel(base=base, k=k)


def approx_from_arrays(b_table, sym_ranges, k: int) -> ApproxModel:
    """Build a model from plain arrays (see
    ``models/shift_and.model_from_arrays``) and an error budget; raises
    ValueError unless 1 <= k <= MAX_ERRORS and k < length."""
    base = model_from_arrays(b_table, sym_ranges, len(sym_ranges), "")
    if not 1 <= int(k) <= MAX_ERRORS or int(k) >= base.length:
        raise ValueError(
            f"k={k} must be 1..{MAX_ERRORS} and below the pattern length "
            f"{base.length}"
        )
    return ApproxModel(base=base, k=int(k))


def scan_reference(model: ApproxModel, data: bytes) -> np.ndarray:
    """Host oracle: match end offsets (i+1 convention) over one stripe, a
    Python-int loop over the exact kernel recurrence (tests only: about
    1 MB/s)."""
    b_table = model.base.b_table
    mb = int(model.match_bit)
    k = model.k
    seeds = model.seeds
    R = list(seeds)
    out = []
    for i, c in enumerate(data):
        if c == NL:
            R = list(seeds)
        else:
            b = int(b_table[c])
            prev = R
            new = [((prev[0] << 1) | 1) & b]
            for j in range(1, k + 1):
                new.append(
                    ((((prev[j] << 1) | 1) & b)
                     | prev[j - 1]
                     | (prev[j - 1] << 1)
                     | (new[j - 1] << 1)
                     | seeds[j]) & 0xFFFFFFFF
                )
            R = new
        if R[k] & mb:
            out.append(i + 1)
    return np.asarray(out, dtype=np.int64)


def line_matches(model: ApproxModel, line: bytes) -> bool:
    """Does this (newline-free) line contain a <= k-error match?"""
    return scan_reference(model, line).size > 0


def dp_oracle_line(pattern_syms: list[list[tuple[int, int]]], line: bytes,
                   k: int) -> bool:
    """Independent O(n*m) edit-distance-substring oracle (Sellers): does
    some substring of ``line`` match the symbol sequence within k edits?
    Symbols are the Shift-And (lo, hi) range lists."""
    m = len(pattern_syms)
    prev = list(range(m + 1))  # D[0][j] = j (deletions); free start in text
    best = prev[m]
    for c in line:
        cur = [0] * (m + 1)  # free start: D[i][0] = 0
        for j in range(1, m + 1):
            hit = any(lo <= c <= hi for lo, hi in pattern_syms[j - 1])
            cur[j] = min(
                prev[j - 1] + (0 if hit else 1),  # match / substitution
                prev[j] + 1,  # insertion (extra text char)
                cur[j - 1] + 1,  # deletion (skip pattern char)
            )
        best = min(best, cur[m])
        prev = cur
    return best <= k
