"""Shift-And bit-parallel model for literals and short class sequences.

The automaton state is one uint32 per lane, and a byte step is
``s = ((s << 1) | 1) & B[byte]``.  Bit j of ``s`` means "the first j+1
symbols of the pattern match ending at this byte"; a match ends where bit
m-1 is set.  On the card ``B[byte]`` is a lookup in a 256-entry table held
in shared memory (csrc/shift_and.cu).

Eligible patterns: a plain concatenation of single-byte chars / classes
(after case folding), length <= 32, no anchors/alternation/repeats, no
class that contains '\\n' -- what a literal grep or a character-class
literal like 'h[ae]llo' compiles to.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from distributed_grep_tpu_torch.models.dfa import (
    NL,
    Char,
    Concat,
    RegexError,
    _Parser,
)

MAX_SYMBOLS = 32  # state fits a uint32 lane


@dataclass
class ShiftAndModel:
    """B-masks for the Shift-And scan.

    b_table    [256] uint32 -- B[byte]: bit j set iff byte matches symbol j
    sym_ranges per symbol, the byte set as sorted disjoint (lo, hi) ranges;
               an empty list marks a wildcard position (rare-class filter)
    length     number of symbols (match bit = length - 1)
    """

    b_table: np.ndarray
    sym_ranges: list[list[tuple[int, int]]]
    length: int
    pattern: str

    @property
    def match_bit(self) -> np.uint32:
        return np.uint32(1 << (self.length - 1))


def model_from_arrays(
    b_table, sym_ranges, length: int, pattern: str
) -> ShiftAndModel:
    """Build a model from plain arrays and lists -- the state a compiled
    pattern carries (a grep system has no weights; its compiled model is
    what two implementations must share).  Copies ``b_table`` to a fresh
    contiguous uint32 array and normalizes the ranges to tuples."""
    b = np.ascontiguousarray(np.asarray(b_table, dtype=np.uint32)).copy()
    if b.shape != (256,):
        raise ValueError(f"b_table must have shape (256,), got {b.shape}")
    if not 1 <= int(length) <= MAX_SYMBOLS or len(sym_ranges) != int(length):
        raise ValueError(
            f"length {length} must be 1..{MAX_SYMBOLS} and match "
            f"{len(sym_ranges)} symbol range lists"
        )
    ranges = [[(int(lo), int(hi)) for lo, hi in r] for r in sym_ranges]
    return ShiftAndModel(b_table=b, sym_ranges=ranges, length=int(length),
                         pattern=pattern)


def parse_pattern(pattern: str, ignore_case: bool = False):
    """The pattern's AST; raises ``RegexError`` on a malformed pattern."""
    return _Parser(pattern, ignore_case).parse()


def try_compile_shift_and(
    pattern: str, ignore_case: bool = False
) -> ShiftAndModel | None:
    """Compile if the pattern is a Shift-And-eligible symbol sequence, else
    None (malformed patterns included: ``parse_pattern`` reports those)."""
    try:
        ast = parse_pattern(pattern, ignore_case)
    except RegexError:
        return None
    parts = ast.parts if isinstance(ast, Concat) else [ast]
    if not parts:
        return None
    sym_masks: list[int] = []
    for p in parts:
        if not isinstance(p, Char):
            return None  # repeats/alternation/anchors
        if p.mask >> NL & 1:
            return None  # newline-consuming
        sym_masks.append(p.mask)
    if len(sym_masks) > MAX_SYMBOLS:
        return None

    b = np.zeros(256, dtype=np.uint32)
    for j, mask in enumerate(sym_masks):
        bit = np.uint32(1 << j)
        for byte in range(256):
            if mask >> byte & 1:
                b[byte] |= bit
    return ShiftAndModel(
        b_table=b,
        sym_ranges=[_mask_to_ranges(m) for m in sym_masks],
        length=len(sym_masks),
        pattern=pattern,
    )


# ------------------------------------------------------------------ SWAR

# The SWAR Shift-And kernel (csrc/shift_and_swar.cu) packs FOUR stripes'
# automata into each uint32, one byte per stripe, so the whole automaton --
# state bits and match bit -- must fit a byte.  The reference's packed TPU
# kernel also needs every checked class to be a small set of exact byte
# values (its zero-byte detect tests equality), and the port routes by the
# same rule so that both take the packed path for the same patterns;
# wildcard positions (the rare-class filter) cost nothing.
SWAR_MAX_SYMBOLS = 8  # state + match bit within each stripe's byte
SWAR_MAX_VALUES = 16  # total equality tests per byte step (the reference's budget)


def swar_values(model: ShiftAndModel) -> list[tuple[int, ...]] | None:
    """Per-symbol byte values for the SWAR packed kernel, or None when the
    model is ineligible (too long, non-singleton ranges, value budget).
    An empty tuple marks a wildcard position (checked nowhere)."""
    if model.length > SWAR_MAX_SYMBOLS:
        return None
    out: list[tuple[int, ...]] = []
    total = 0
    for ranges in model.sym_ranges:
        vals = []
        for lo, hi in ranges:
            if lo != hi:
                return None  # a real range: no packed equality form
            vals.append(lo)
        total += len(vals)
        out.append(tuple(vals))
    if total > SWAR_MAX_VALUES:
        return None
    return out


# ------------------------------------------------------- rare-class filter

# Byte-frequency prior for choosing which classes the device filter checks.
# English letter frequencies (upper+lower folded), whitespace/digits, and a
# uniform floor for everything else.  Exactness never depends on this
# prior: it only trades device work against host confirm (the span confirm
# in ops/device_scan.py restores exact lines either way), and the scan drops
# the filter for its remaining segments when a segment's candidates show
# the prior was badly wrong for the corpus.
_LETTER_FREQ = {
    "e": 0.127, "t": 0.091, "a": 0.082, "o": 0.075, "i": 0.070, "n": 0.067,
    "s": 0.063, "h": 0.061, "r": 0.060, "d": 0.043, "l": 0.040, "c": 0.028,
    "u": 0.028, "m": 0.024, "w": 0.024, "f": 0.022, "g": 0.020, "y": 0.020,
    "p": 0.019, "b": 0.015, "v": 0.0098, "k": 0.0077, "x": 0.0015,
    "q": 0.00095, "j": 0.00015, "z": 0.00007,
}


def _byte_prior() -> np.ndarray:
    prior = np.full(256, 1.0 / 256, dtype=np.float64)
    for ch, f in _LETTER_FREQ.items():
        prior[ord(ch)] = f
        prior[ord(ch.upper())] = f / 4  # uppercase much rarer in prose
    prior[ord(" ")] = 0.15
    for d in b"0123456789":
        prior[d] = 0.01
    return prior / prior.sum()


_PRIOR = _byte_prior()


def _text_prior() -> np.ndarray:
    """Prose-conditional byte prior: ``_LETTER_FREQ`` rescaled by the
    letter share of prose (~70% lowercase, 1/15 of that uppercase) around
    space at ~17%, over printable ASCII and whitespace only.

    ``_byte_prior``'s uniform floor over all 256 values puts ' ' at 6.7%,
    right for ranking classes by rarity but an underestimate where a
    density gate needs matches per byte of TEXT
    (models/pairset.expected_match_density takes the max of both)."""
    w = np.zeros(256, dtype=np.float64)
    w[9] = 0.002  # tab
    w[10] = 0.02  # newline (members never contain it; mass only)
    w[33:127] = 0.0015  # punctuation floor
    for ch, f in _LETTER_FREQ.items():
        w[ord(ch)] = f * 0.70
        w[ord(ch.upper())] = f * 0.70 / 15
    w[ord(" ")] = 0.17
    for d in b"0123456789":
        w[d] = 0.006
    return w / w.sum()


# Keep adding checked classes until the modeled false-candidate rate drops
# below this (candidates per byte).
FILTER_FP_TARGET = 2e-6


def filtered_for_device(
    model: ShiftAndModel, fp_target: float = FILTER_FP_TARGET
) -> ShiftAndModel | None:
    """A device-filter variant of ``model`` that checks only its rarest
    byte-classes (remaining positions become wildcards, their bits ORed
    into every ``b_table`` entry), or None when no class can be dropped.

    Candidates stay a superset of the full model's matches; the engine's
    span line confirm restores exactness.  Classes are added rarest-first
    (every position of a chosen class is checked: repeated classes square
    their frequency for free) until the modeled false-candidate rate on
    the byte prior clears ``fp_target``."""
    classes: dict[tuple, list[int]] = {}
    for j, ranges in enumerate(model.sym_ranges):
        classes.setdefault(tuple(ranges), []).append(j)

    def freq(ranges: tuple) -> float:
        return float(sum(_PRIOR[lo : hi + 1].sum() for lo, hi in ranges))

    order = sorted(classes.items(), key=lambda kv: freq(kv[0]))
    fp = 1.0
    kept: set[int] = set()
    for ranges, positions in order:
        kept.update(positions)
        fp *= freq(ranges) ** len(positions)
        if fp <= fp_target:
            break
    if len(kept) == model.length:
        return None  # nothing dropped: use the full model
    b = model.b_table.copy()
    sym_ranges: list[list[tuple[int, int]]] = []
    for j in range(model.length):
        if j in kept:
            sym_ranges.append(model.sym_ranges[j])
        else:
            sym_ranges.append([])  # wildcard: every byte matches position j
            b |= np.uint32(1 << j)
    return ShiftAndModel(
        b_table=b, sym_ranges=sym_ranges, length=model.length,
        pattern=model.pattern,
    )


def _mask_to_ranges(mask: int) -> list[tuple[int, int]]:
    """256-bit membership mask -> sorted disjoint inclusive (lo, hi) ranges."""
    ranges: list[tuple[int, int]] = []
    b = 0
    while b < 256:
        if mask >> b & 1:
            lo = b
            while b < 256 and mask >> b & 1:
                b += 1
            ranges.append((lo, b - 1))
        else:
            b += 1
    return ranges


def scan_reference(model: ShiftAndModel, data: bytes) -> np.ndarray:
    """Host-side oracle: end offsets (index+1) of every match."""
    s = 0
    hits = []
    b = model.b_table
    mb = int(model.match_bit)
    for i, byte in enumerate(data):
        s = ((s << 1) | 1) & int(b[byte])
        if s & mb:
            hits.append(i + 1)
    return np.asarray(hits, dtype=np.uint64)
