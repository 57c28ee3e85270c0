"""Glushkov position automaton -> bit-parallel NFA model for the CUDA kernel.

The port's own copy of the reference package's models/nfa.py.  The DFA
table (models/dfa.py) is exact for the whole grep -E subset but costs one
dependent table lookup per byte and state; the Shift-And model covers only
plain symbol sequences of <= 32 symbols.  This model closes the gap for
general regex: the Glushkov (position) automaton of the pattern, simulated
bit-parallel.  One bit per *position* (= char edge of the Thompson NFA,
models/dfa._Nfa); a byte step is

    D' = (follow(D) | init) & B[byte]

where follow(D) = OR of follow[p] over set bits p, init re-activates the
pattern starts (the unanchored Sigma* restart, plus '^' starts only after a
newline), and B[byte] has bit p set iff the byte is in position p's class.
csrc/nfa.cu runs it with B[byte] looked up in a table in shared memory.

The kernel plan exploits that most positions in real patterns sit in plain
concatenation runs where follow[p] == {p+1}: all such "chain" bits advance
with ONE masked shift per state word, exactly like Shift-And.  Only branch
points (alternation heads/tails, repeat back-edges, edges that cross a
32-bit word) are "specials" with a follow mask of their own.

Eligibility (try_compile_glushkov returns None otherwise): <= MAX_POSITIONS
positions after bounded-repeat expansion, no '$' accepts (they need
next-byte lookahead; the DFA table's accept_eol plane handles them), no
mid-pattern anchors, pattern not nullable (empty-match patterns match
every line; the engine short-circuits those before any scan).

compile_dfa on the same pattern is the oracle: the two compilers share the
parser and the Thompson construction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from distributed_grep_tpu_torch.models import dfa as _dfa
from distributed_grep_tpu_torch.models.dfa import NL, RegexError

# State spans MAX_POSITIONS/32 uint32 words per lane (csrc/nfa.cu is
# templated on 1..4 words).  Every model within the cap runs on the card:
# the kernel reads its plan from memory, so there is no cost budget.
MAX_POSITIONS = 128
WORD_BITS = 32


@dataclass
class GlushkovModel:
    """Bit-parallel position-automaton tables + the kernel plan.

    n_pos       number of Glushkov positions (char edges)
    sym_masks   per position, 256-bit byte-membership mask
    follow      per position, n_pos-bit mask of successor positions
    init_float  positions active at every byte (unanchored restart)
    init_anchor positions active only at line starts ('^' branches),
                *minus* init_float
    final       positions whose activation means "a match ends here"
    """

    n_pos: int
    sym_masks: list[int]
    follow: list[int]
    init_float: int
    init_anchor: int
    final: int
    pattern: str

    # ---- kernel plan (derived in __post_init__) --------------------------
    # classes: positions grouped by identical byte set; per class the byte
    # set as (lo, hi) ranges and the per-word position masks it contributes
    # to B.  chain_src: per word, bits p with follow[p] == {p+1} in-word.
    # specials: (word, bit, ((word, mask), ...)) per remaining position.
    def __post_init__(self) -> None:
        self.n_words = (self.n_pos + WORD_BITS - 1) // WORD_BITS
        cls_of: dict[int, list[int]] = {}
        for p, m in enumerate(self.sym_masks):
            cls_of.setdefault(m, []).append(p)
        self.cls_ranges: list[tuple[tuple[int, int], ...]] = []
        self.cls_pos_words: list[tuple[tuple[int, int], ...]] = []
        for mask, ps in cls_of.items():
            self.cls_ranges.append(tuple(_mask_to_ranges(mask)))
            self.cls_pos_words.append(tuple(_bits_to_words(ps, self.n_words)))
        chain = [0] * self.n_words
        specials: list[tuple[int, int, tuple[tuple[int, int], ...]]] = []
        for p, f in enumerate(self.follow):
            if f == 0:
                continue
            if f == (1 << (p + 1)) and (p % WORD_BITS) != WORD_BITS - 1:
                chain[p // WORD_BITS] |= 1 << (p % WORD_BITS)
            else:
                words = _int_to_words(f, self.n_words)
                specials.append(
                    (p // WORD_BITS, p % WORD_BITS,
                     tuple((w, m) for w, m in enumerate(words) if m))
                )
        self.chain_src = tuple(chain)
        self.specials = tuple(specials)
        self.init_float_words = tuple(_int_to_words(self.init_float, self.n_words))
        self.init_anchor_words = tuple(_int_to_words(self.init_anchor, self.n_words))
        self.final_words = tuple(_int_to_words(self.final, self.n_words))

    @property
    def total_ranges(self) -> int:
        return sum(len(r) for r in self.cls_ranges)

    @property
    def n_classes(self) -> int:
        return len(self.cls_ranges)

    @property
    def n_specials(self) -> int:
        return len(self.specials)

    def kernel_plan(self) -> tuple:
        """The plan as one hashable tuple: equal plans mean equal kernel
        runs (ops/nfa_scan.pack_plan packs the same fields)."""
        return (
            self.n_words,
            tuple(zip(self.cls_ranges, self.cls_pos_words)),
            self.chain_src,
            self.specials,
            self.init_float_words,
            self.init_anchor_words,
            self.final_words,
            bool(self.init_anchor),
        )


def _mask_to_ranges(mask: int) -> list[tuple[int, int]]:
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


def _int_to_words(v: int, n_words: int) -> list[int]:
    return [(v >> (WORD_BITS * w)) & 0xFFFFFFFF for w in range(n_words)]


def _bits_to_words(bits: list[int], n_words: int) -> list[tuple[int, int]]:
    words = [0] * n_words
    for p in bits:
        words[p // WORD_BITS] |= 1 << (p % WORD_BITS)
    return [(w, m) for w, m in enumerate(words) if m]


def _relax_bounded(node) -> tuple[object, bool]:
    """Copy of the AST with every bounded repeat {m,n} (finite n > m)
    widened to {m,} — a language SUPERSET whose Glushkov automaton spends
    min+1 copies of the body instead of n.  The relaxed automaton is only
    usable as a candidate FILTER: every exact match is also a relaxed
    match at the same end offset, so candidate lines are a superset and a
    host confirm of each candidate line restores exactness (the same
    filter+confirm architecture the shift-and rare-class and FDR paths
    use).  Returns (node, changed)."""
    if isinstance(node, _dfa.Repeat):
        inner, ch = _relax_bounded(node.node)
        if node.max is not None and node.max > node.min:
            return _dfa.Repeat(inner, node.min, None), True
        return (_dfa.Repeat(inner, node.min, node.max), True) if ch else (node, False)
    if isinstance(node, _dfa.Concat):
        parts = [_relax_bounded(p) for p in node.parts]
        if any(c for _, c in parts):
            return _dfa.Concat([p for p, _ in parts]), True
        return node, False
    if isinstance(node, _dfa.Alt):
        opts = [_relax_bounded(o) for o in node.options]
        if any(c for _, c in opts):
            return _dfa.Alt([o for o, _ in opts]), True
        return node, False
    return node, False


def try_compile_glushkov(
    pattern: str, ignore_case: bool = False, max_positions: int = MAX_POSITIONS
) -> GlushkovModel | None:
    """Compile to a bit-parallel position automaton, or None if ineligible.

    Reuses dfa.py's parser, anchor splitting, and Thompson construction so
    the supported syntax and line semantics are identical to compile_dfa;
    RegexError propagates (the caller's compile_dfa will surface it)."""
    ast = _dfa._Parser(pattern, ignore_case).parse()
    return _compile_from_ast(ast, pattern, max_positions)


def compile_scan_model(
    pattern: str, ignore_case: bool = False, max_positions: int = MAX_POSITIONS
) -> tuple[GlushkovModel | None, bool]:
    """(model, is_filter) — the automaton the device scan should run.

    Exact when that is also the cheapest; when relaxing bounded repeats
    saves state WORDS (the kernel's per-byte cost is linear in words —
    config 4's `{4,24}` is 33 positions = 2 words exact, 14 = 1 word
    relaxed), or when only the relaxed form fits the position cap at all,
    returns the filter model with is_filter=True: its match offsets are a
    candidate superset and the engine must confirm candidate lines on
    host (ops/engine.py `cand_words`)."""
    ast = _dfa._Parser(pattern, ignore_case).parse()
    exact = _compile_from_ast(ast, pattern, max_positions)
    relaxed_ast, changed = _relax_bounded(ast)
    if not changed:
        return exact, False
    filt = _compile_from_ast(relaxed_ast, pattern, max_positions)
    if filt is None or (exact is not None and filt.n_words >= exact.n_words):
        return exact, False
    return filt, True


def _count_positions(node) -> int:
    """Char positions the Glushkov/Thompson construction will spend on
    `node` (char edges, counting repeat expansion the way _Nfa._build_repeat
    does: min copies plus one loop copy for unbounded, max copies bounded)."""
    if isinstance(node, _dfa.Char):
        return 1
    if isinstance(node, _dfa.Concat):
        return sum(_count_positions(p) for p in node.parts)
    if isinstance(node, _dfa.Alt):
        return sum(_count_positions(o) for o in node.options)
    if isinstance(node, _dfa.Repeat):
        inner = _count_positions(node.node)
        copies = node.min + (1 if node.max is None else node.max - node.min)
        return inner * max(copies, 1)
    return 0  # Anchor: no char positions


def _truncate_prefix(node, budget: int):
    """Longest REQUIRED prefix of `node` fitting `budget` positions, or
    None if no usable prefix exists.  Only prefixes every match must
    contain are kept — optional parts (min-0 repeats) and alternations
    never get partially included — so any string matching `node` has a
    substring matching the truncation: a candidate FILTER at line
    granularity (see compile_device_filter)."""
    if _count_positions(node) <= budget:
        return node
    if isinstance(node, _dfa.Concat):
        kept, used = [], 0
        for part in node.parts:
            c = _count_positions(part)
            if used + c <= budget:
                kept.append(part)
                used += c
                continue
            t = _truncate_prefix(part, budget - used)
            if t is not None:
                kept.append(t)
            break  # everything after the cut is dropped
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else _dfa.Concat(kept)
    if isinstance(node, _dfa.Repeat) and node.min >= 1:
        # the first min copies are required: keep k <= min whole copies
        inner = _count_positions(node.node)
        k = min(budget // inner, node.min) if inner else 0
        if k < 1:
            return None
        return _dfa.Repeat(node.node, k, k)
    return None  # Alt / optional repeat / single big leaf: no required prefix


def compile_device_filter(
    pattern: str, ignore_case: bool = False, max_positions: int = MAX_POSITIONS
) -> GlushkovModel | None:
    """A Glushkov FILTER for single patterns outside the exact device
    kernel subset: '$' end-anchors dropped, bounded repeats relaxed, and
    over-cap bodies truncated to a required prefix.

    Every transform yields a language superset at LINE granularity -- a
    line containing an exact match always contains a filter match ('$'
    removal keeps the same end offsets; prefix truncation keeps a
    required substring) -- so the engine's cand_words host confirm
    (ops/host_match.py, per-line DFA or re verdicts) restores exactness,
    the same architecture as the relaxed-repeat filter above.  This is
    what puts patterns like ``error$``, ``\\berror\\b`` and literals
    longer than MAX_POSITIONS on the card.

    Returns None when no non-nullable filter compiles."""
    try:
        ast = _dfa._Parser(pattern, ignore_case).parse()
    except RegexError:
        return None
    relaxed, _ = _relax_bounded(ast)
    # Mid-pattern anchors strip to epsilon (language superset, same end
    # offsets — see _strip_anchors): '(^a|b)c' filters as '(a|b)c', and
    # the per-line host confirm re-applies the real assertions.  Without
    # this the Glushkov builder rejects anchored bodies outright
    # (_has_anchor) and such patterns would stay off the device.
    branches = [
        (a_start, _strip_anchors(body))
        for a_start, body, _ in _dfa._split_anchors(relaxed)
    ]
    total = sum(_count_positions(b) for _, b in branches)
    # Fits untruncated: keep the whole body (max selectivity — the filter
    # then differs from the pattern only by the dropped '$').  Over cap:
    # prefer a 32-position truncation (1 state word — the fastest kernel
    # shape; a 32-symbol required prefix is already astronomically
    # selective) and widen to the full cap only if 32 yields no usable
    # prefix (e.g. leading optional parts making short prefixes nullable).
    if total <= max_positions:
        whole = [(a_start, body, False) for a_start, body in branches]
        try:
            return _compile_from_branches(whole, pattern, max_positions)
        except RegexError:
            return None
    for budget in (32, max_positions):
        per = max(1, budget // max(len(branches), 1))
        trunc = []
        for a_start, body in branches:
            t = _truncate_prefix(body, per)
            if t is None:
                trunc = None
                break
            trunc.append((a_start, t, False))
        if trunc is None:
            continue
        try:
            m = _compile_from_branches(trunc, pattern, max_positions)
        except RegexError:
            return None
        if m is not None:
            return m
    return None


def _compile_from_ast(
    ast, pattern: str, max_positions: int
) -> GlushkovModel | None:
    branches = _dfa._split_anchors(ast)
    if any(a_end for _, _, a_end in branches):
        return None  # '$' needs next-byte lookahead — DFA path handles it
    return _compile_from_branches(branches, pattern, max_positions)


def _has_anchor(node) -> bool:
    """True when `node` contains an Anchor anywhere (mid-pattern '^'/'$'
    — _split_anchors only pops top-level ones).  The DFA's subset
    construction represents these exactly via ls_eps/eol_eps edges
    (models/dfa.py, round 5), but this bit-parallel position automaton
    has no position-gated epsilon: its closure would silently treat the
    anchored continuation as dead — an UNDER-approximation that is wrong
    for the exact automaton and fatal for a filter (filters must only
    over-approximate).  Such bodies are rejected here; the device filter
    path strips the anchors instead (_strip_anchors — a superset)."""
    if isinstance(node, _dfa.Anchor):
        return True
    if isinstance(node, _dfa.Concat):
        return any(_has_anchor(p) for p in node.parts)
    if isinstance(node, _dfa.Alt):
        return any(_has_anchor(o) for o in node.options)
    if isinstance(node, _dfa.Repeat):
        return _has_anchor(node.node)
    return False


def _strip_anchors(node):
    """Copy of the AST with every Anchor replaced by epsilon (an empty
    Concat).  Anchors consume nothing, so removal keeps every exact
    match's end offset while enlarging the language — a candidate FILTER
    transform with the same contract as dropping a trailing '$'."""
    if isinstance(node, _dfa.Anchor):
        return _dfa.Concat([])
    if isinstance(node, _dfa.Concat):
        parts = [_strip_anchors(p) for p in node.parts]
        parts = [p for p in parts if not (isinstance(p, _dfa.Concat) and not p.parts)]
        return _dfa.Concat(parts)
    if isinstance(node, _dfa.Alt):
        return _dfa.Alt([_strip_anchors(o) for o in node.options])
    if isinstance(node, _dfa.Repeat):
        return _dfa.Repeat(_strip_anchors(node.node), node.min, node.max)
    return node


def _compile_from_branches(
    branches, pattern: str, max_positions: int
) -> GlushkovModel | None:
    if any(_has_anchor(body) for _, body, *_ in branches):
        return None  # mid-pattern anchors: only the DFA table is exact
    nfa = _dfa._Nfa()
    root = nfa.new_state()  # line-start entry
    floating = nfa.new_state()  # unanchored restart entry (no self-loop edge:
    nfa.states[root].eps.append(floating)  # the kernel re-injects init_float
    accepts: set[int] = set()  # at every byte instead)
    try:
        for a_start, body, _ in branches:
            s, a = nfa.build(body)
            (nfa.states[root] if a_start else nfa.states[floating]).eps.append(s)
            accepts.add(a)
    except _dfa.TooManyStates:
        return None  # bounded-repeat expansion blew the cap

    # positions = char edges, in (state, edge) order
    positions: list[tuple[int, int, int]] = []  # (source, mask, target)
    for sid, st in enumerate(nfa.states):
        for mask, tgt in st.chars:
            positions.append((sid, mask, tgt))
    n_pos = len(positions)
    if n_pos == 0 or n_pos > max_positions:
        return None

    def closure(seed: frozenset[int]) -> frozenset[int]:
        stack, seen = list(seed), set(seed)
        while stack:
            s = stack.pop()
            for t in nfa.states[s].eps:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    pos_of_source: dict[int, int] = {}
    for i, (src, _, _) in enumerate(positions):
        pos_of_source.setdefault(src, 0)
        pos_of_source[src] |= 1 << i

    def pos_from(states: frozenset[int]) -> int:
        m = 0
        for s in states:
            m |= pos_of_source.get(s, 0)
        return m

    root_cl = closure(frozenset({root}))
    if root_cl & accepts:
        return None  # nullable: empty match — engine short-circuits pre-scan
    float_cl = closure(frozenset({floating}))
    init_line = pos_from(root_cl)
    init_float = pos_from(float_cl)

    follow: list[int] = []
    final = 0
    for i, (_, _, tgt) in enumerate(positions):
        tcl = closure(frozenset({tgt}))
        follow.append(pos_from(tcl))
        if tcl & accepts:
            final |= 1 << i

    return GlushkovModel(
        n_pos=n_pos,
        sym_masks=[m for _, m, _ in positions],
        follow=follow,
        init_float=init_float,
        init_anchor=init_line & ~init_float,
        final=final,
        pattern=pattern,
    )


def glushkov_from_arrays(
    n_pos: int, sym_masks, follow, init_float: int, init_anchor: int,
    final: int, pattern: str,
) -> GlushkovModel:
    """Build a model from plain integers and lists -- the state a compiled
    pattern carries (a grep system has no weights; its compiled automaton
    is what two implementations must share).  The kernel plan is derived
    anew; masks must fit ``n_pos`` bits."""
    n_pos = int(n_pos)
    if not 1 <= n_pos <= MAX_POSITIONS:
        raise ValueError(f"n_pos {n_pos} must be 1..{MAX_POSITIONS}")
    sym = [int(m) for m in sym_masks]
    fol = [int(f) for f in follow]
    if len(sym) != n_pos or len(fol) != n_pos:
        raise ValueError(
            f"sym_masks and follow need {n_pos} entries, got {len(sym)} and "
            f"{len(fol)}"
        )
    limit = 1 << n_pos
    if any(not 0 < m < (1 << 256) for m in sym):
        raise ValueError("every sym_mask must be a non-empty 256-bit mask")
    if any(not 0 <= v < limit for v in (*fol, init_float, init_anchor, final)):
        raise ValueError(f"position masks must fit {n_pos} bits")
    return GlushkovModel(
        n_pos=n_pos, sym_masks=sym, follow=fol, init_float=int(init_float),
        init_anchor=int(init_anchor), final=int(final), pattern=pattern,
    )


def scan_reference(model: GlushkovModel, data: bytes) -> np.ndarray:
    """Host-side oracle: end offsets (index+1) of every match (line-start
    state at offset 0, newline resets — the device scan's exact semantics)."""
    b_table = [0] * 256
    for cls_ranges, pos_words in zip(model.cls_ranges, model.cls_pos_words):
        mask = 0
        for w, m in pos_words:
            mask |= m << (WORD_BITS * w)
        for lo, hi in cls_ranges:
            for byte in range(lo, hi + 1):
                b_table[byte] |= mask
    d = 0
    prev_nl = True
    hits = []
    for i, byte in enumerate(data):
        reached = model.init_float | (model.init_anchor if prev_nl else 0)
        dd = d
        while dd:
            p = (dd & -dd).bit_length() - 1
            reached |= model.follow[p]
            dd &= dd - 1
        d = reached & b_table[byte]
        if d & model.final:
            hits.append(i + 1)
        prev_nl = byte == NL
    return np.asarray(hits, dtype=np.uint64)
