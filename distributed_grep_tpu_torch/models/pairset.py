"""Exact short-literal-set scan model: the row-partition pair factorization.

Sets whose members are all 1-2 bytes have no pair window for the FDR
filter to hash ahead of (models/fdr.py needs members >= 2 bytes).  This
model scans them EXACTLY, with no confirm:

* The members form a 256x256 boolean matrix ``M[b0, b1]``, True where the
  pair (b0, b1) is a 2-byte member; a 1-byte member {c} matches whatever
  the previous byte was, so it folds in as the all-True column
  ``M[:, c]``.
* Partition the 256 ``b0`` rows by identical row pattern: ``rowcls[b0]``
  in [0, R).  Then ``M[b0, b1] == W[b1] >> rowcls[b0] & 1``, where
  ``W[b1]`` packs column b1's per-class bits into one uint32 -- exact
  whenever R <= 32.  Past 32 row classes the transposed orientation
  (partition columns, index words by b0) is tried before giving up.

Per byte a kernel does two 256-entry lookups (rowcls of one byte, W of
the other) and a shift.  The previous byte is seeded '\\n' at stripe
starts: no member holds a newline, so a stripe head can only miss a
2-byte match that spans it (the engine's stitch restores it), never
report a false one.

The port's own copy of ``distributed_grep_tpu/models/pairset.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NL = 0x0A


class PairsetError(ValueError):
    pass


@dataclass(frozen=True)
class PairsetModel:
    """Exact scan tables for a 1-2-byte literal set.

    ``transposed`` False: hit(t) = words[data[t]] >> rowcls[data[t-1]] & 1.
    ``transposed`` True:  hit(t) = words[data[t-1]] >> rowcls[data[t]] & 1.
    Either orientation reports the END offset (i+1 convention) of each
    match.
    """

    rowcls: np.ndarray  # (256,) uint32, values < 32
    words: np.ndarray  # (256,) uint32, bit per row/column class
    transposed: bool
    n_classes: int
    patterns: list[bytes]
    ignore_case: bool

    @property
    def window(self) -> int:
        return 2  # matches span <= 2 bytes: a stripe head misses only at
        # its first byte (the engine's stitch)


def pairset_from_arrays(
    rowcls, words, transposed: bool, n_classes: int, patterns,
    ignore_case: bool,
) -> PairsetModel:
    """Build a model from plain arrays and lists -- the compiled state two
    implementations must share.  Copies both tables to fresh contiguous
    uint32 arrays and checks their shapes and class range."""
    rc = np.ascontiguousarray(np.asarray(rowcls, dtype=np.uint32)).copy()
    w = np.ascontiguousarray(np.asarray(words, dtype=np.uint32)).copy()
    if rc.shape != (256,) or w.shape != (256,):
        raise ValueError(f"rowcls and words must have shape (256,), got "
                         f"{rc.shape} and {w.shape}")
    if not 1 <= int(n_classes) <= 32 or int(rc.max()) >= 32:
        raise ValueError(f"a pairset model has 1..32 classes, got "
                         f"{n_classes} (largest class id {int(rc.max())})")
    return PairsetModel(rowcls=rc, words=w, transposed=bool(transposed),
                        n_classes=int(n_classes),
                        patterns=[bytes(p) for p in patterns],
                        ignore_case=bool(ignore_case))


def _normalize(patterns, ignore_case: bool) -> list[bytes]:
    out = []
    for p in patterns:
        b = p.encode("utf-8", "surrogateescape") if isinstance(p, str) else bytes(p)
        if not b:
            raise PairsetError("empty literal in pattern set")
        if NL in b:
            raise PairsetError("literal contains '\\n'")
        if len(b) > 2:
            raise PairsetError("pairset hosts only 1-2 byte literals")
        out.append(b.lower() if ignore_case else b)
    return out


def expected_match_density(patterns, *, ignore_case: bool = False) -> float:
    """Expected matches per scanned byte under the static byte priors.

    The pairset kernel is exact, but the host still pays O(matches) for
    the sparse fetch and the per-line records, so the engine gates both
    pairset routes (a pure short set and a mixed set's 1-byte sidecar) on
    this estimate against models/fdr.FP_CEILING_PER_BYTE.  The estimate is
    the MAX over two corpus models -- the uniform-floored prior (binary
    corpora) and the prose prior (text, where ' ' is ~15% of bytes).  A
    corpus can still defeat it; that affects speed, never exactness."""
    from distributed_grep_tpu_torch.models.shift_and import (
        _byte_prior,
        _text_prior,
    )

    norm = _normalize(patterns, ignore_case)
    M = np.zeros((256, 256), dtype=np.float64)
    for p in norm:
        if len(p) == 2:
            M[p[0], p[1]] = 1.0
        else:  # 1-byte member: any previous byte
            M[:, p[0]] = 1.0
    dens = 0.0
    for q in (_byte_prior(), _text_prior()):
        q = np.asarray(q, dtype=np.float64).copy()
        if ignore_case:
            # members are stored folded and the kernel folds corpus bytes:
            # a lowercase byte's frequency absorbs its uppercase
            for c in range(ord("a"), ord("z") + 1):
                q[c] += q[c - 32]
                q[c - 32] = 0.0
        dens = max(dens, float(q @ M @ q))
    return dens


def _factorize(M: np.ndarray) -> tuple[np.ndarray, np.ndarray, int] | None:
    """Partition the 256 rows of a (256, 256) bool matrix by identical
    pattern; return (rowcls, words, n_classes) or None past 32 classes."""
    view = np.ascontiguousarray(M).view(
        np.dtype((np.void, M.shape[1] * M.dtype.itemsize))
    ).ravel()
    _, first_idx, inverse = np.unique(view, return_index=True, return_inverse=True)
    n_cls = len(first_idx)
    if n_cls > 32:
        return None
    # stable class ids: order classes by their first-occurring row
    sorted_first = np.sort(first_idx)
    remap = np.zeros(n_cls, dtype=np.uint32)
    for new_r, i in enumerate(sorted_first):
        remap[inverse[i]] = new_r
    rowcls = remap[inverse].astype(np.uint32)
    words = np.zeros(256, dtype=np.uint32)
    for new_r, i in enumerate(sorted_first):
        cols = np.nonzero(M[i])[0]
        words[cols] |= np.uint32(1) << np.uint32(new_r)
    return rowcls, words, n_cls


def compile_pairset(patterns, *, ignore_case: bool = False) -> PairsetModel:
    """Compile a 1-2-byte literal set; raises PairsetError when it is not
    exactly representable (row AND column partitions both past 32
    classes)."""
    norm = _normalize(patterns, ignore_case)
    if not norm:
        raise PairsetError("empty pattern set")
    M = np.zeros((256, 256), dtype=bool)
    for p in norm:
        if len(p) == 2:
            M[p[0], p[1]] = True
        else:  # 1-byte member: matches whatever the previous byte was
            M[:, p[0]] = True

    fact = _factorize(M)
    if fact is not None:
        rowcls, words, n_cls = fact
        return PairsetModel(
            rowcls=rowcls, words=words, transposed=False,
            n_classes=max(n_cls, 1), patterns=norm, ignore_case=ignore_case,
        )
    fact_t = _factorize(np.ascontiguousarray(M.T))
    if fact_t is not None:
        colcls, words_t, n_cls = fact_t
        return PairsetModel(
            rowcls=colcls, words=words_t, transposed=True,
            n_classes=max(n_cls, 1), patterns=norm, ignore_case=ignore_case,
        )
    raise PairsetError(
        "pair matrix needs > 32 row and column classes -- not exactly "
        "representable"
    )


# ------------------------------------------------------------------ oracle

def reference_ends(model: PairsetModel, data: bytes) -> np.ndarray:
    """NumPy oracle: EXACT end offsets (i+1) of all matches in one stripe,
    mirroring the kernels including the prev='\\n' seed at the stripe
    start."""
    arr = np.frombuffer(data, dtype=np.uint8).astype(np.int64)
    if model.ignore_case:
        arr = np.where((arr >= 65) & (arr <= 90), arr + 32, arr)
    if arr.size == 0:
        return np.zeros(0, dtype=np.int64)
    prev = np.concatenate([[NL], arr[:-1]])
    if model.transposed:
        hit = (model.words[prev] >> model.rowcls[arr]) & 1
    else:
        hit = (model.words[arr] >> model.rowcls[prev]) & 1
    return np.nonzero(hit)[0].astype(np.int64) + 1
