"""Aho-Corasick automata of literal sets, as DFA scan tables.

The port's own copy of ``distributed_grep_tpu/models/aho.py``.  A literal
set compiles to a trie with failure links, resolved into the same dense
``DfaTable`` a single pattern compiles to (models/dfa.py): the host
scanner (``models/dfa.reference_scan``) and the table-DFA kernel
(csrc/dfa.cu, ops/dfa_scan.py) scan it as they scan any table.  An accept
state means "some member ends at this byte", which is grep's per-line
match.

The construction is the textbook one: the trie, failure links by BFS,
goto and failure densified into full transitions, byte columns merged
into classes, and the '\\n' column forced to the start state (the newline
reset every table has).  ``compile_aho_corasick_banks`` cuts a set too
large for one table's state budget into banks; the union of the banks'
matched lines is the set's.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from distributed_grep_tpu_torch.models.dfa import (
    NL,
    DfaTable,
    RegexError,
    TooManyStates,
)

# The reference's bank budget (its GrepEngine max_states_per_bank): the
# uint16 state space of one table.
MAX_STATES_PER_BANK = 1 << 16


def _member_bytes(p: str | bytes) -> bytes:
    return p.encode("utf-8", "surrogateescape") if isinstance(p, str) else bytes(p)


def compile_aho_corasick(
    patterns: list[str | bytes],
    ignore_case: bool = False,
    max_states: int = MAX_STATES_PER_BANK,
) -> DfaTable:
    """One newline-reset DfaTable for the literal set ``patterns``.
    Raises RegexError for an empty set, an empty member or a member that
    holds '\\n', and TooManyStates past ``max_states`` trie states."""
    if not patterns:
        raise RegexError("empty pattern set")
    needles: list[bytes] = []
    for p in patterns:
        b = _member_bytes(p)
        if not b:
            raise RegexError("empty literal in pattern set")
        if NL in b:
            raise RegexError("literal contains '\\n' -- not representable "
                             "per-line")
        needles.append(b.lower() if ignore_case else b)

    # the trie
    goto: list[dict[int, int]] = [{}]
    accepts: list[bool] = [False]
    for word in needles:
        s = 0
        for byte in word:
            if byte not in goto[s]:
                if len(goto) >= max_states:
                    raise TooManyStates(
                        f"pattern set needs >{max_states} trie states")
                goto[s][byte] = len(goto)
                goto.append({})
                accepts.append(False)
            s = goto[s][byte]
        accepts[s] = True
    n = len(goto)

    # failure links, breadth first
    fail = [0] * n
    q: deque[int] = deque(goto[0].values())
    while q:
        u = q.popleft()
        accepts[u] = accepts[u] or accepts[fail[u]]
        for byte, v in goto[u].items():
            q.append(v)
            f = fail[u]
            while f and byte not in goto[f]:
                f = fail[f]
            nxt = goto[f].get(byte, 0)
            fail[v] = nxt if nxt != v else 0

    # full transitions in BFS order (a state's failure target first); the
    # '\n' column goes to the start state
    full = np.zeros((n, 256), dtype=np.uint16)
    bfs = [0]
    q = deque(goto[0].values())
    while q:
        u = q.popleft()
        bfs.append(u)
        q.extend(goto[u].values())
    for s in bfs:
        for b in range(256):
            if b == NL:
                full[s, b] = 0
                continue
            lookup = b + 32 if ignore_case and ord("A") <= b <= ord("Z") else b
            if lookup in goto[s]:
                full[s, b] = goto[s][lookup]
            else:
                full[s, b] = 0 if s == 0 else full[fail[s], b]

    # byte classes; '\n' keeps a class of its own
    cols, byte_to_cls = np.unique(full, axis=1, return_inverse=True)
    byte_to_cls = byte_to_cls.reshape(-1)
    nl_cls = int(byte_to_cls[NL])
    if int(np.sum(byte_to_cls == nl_cls)) > 1:
        byte_to_cls = byte_to_cls.copy()
        byte_to_cls[NL] = cols.shape[1]
        cols = np.concatenate([cols, np.zeros((n, 1), dtype=cols.dtype)],
                              axis=1)
    return DfaTable(
        trans=np.ascontiguousarray(cols, dtype=np.uint16),
        byte_to_cls=byte_to_cls.astype(np.uint16),
        accept=np.asarray(accepts, dtype=bool),
        accept_eol=np.zeros(n, dtype=bool),
        start=0,
        pattern=f"<aho-corasick {len(needles)} literals>",
    )


def compile_aho_corasick_banks(
    patterns: list[str | bytes],
    ignore_case: bool = False,
    max_states_per_bank: int = MAX_STATES_PER_BANK,
) -> list[DfaTable]:
    """A literal set of any size as one or more tables: members are packed
    greedily, in order, by their worst-case trie size (one state a byte),
    so each bank stays within ``max_states_per_bank`` states."""
    norm = [_member_bytes(p) for p in patterns]
    if not norm:
        raise RegexError("empty pattern set")
    banks: list[list[bytes]] = []
    cur: list[bytes] = []
    cur_states = 1  # the root
    for p in norm:
        if cur and cur_states + len(p) > max_states_per_bank - 1:
            banks.append(cur)
            cur, cur_states = [], 1
        cur.append(p)
        cur_states += len(p)
    if cur:
        banks.append(cur)
    return [compile_aho_corasick(b, ignore_case=ignore_case,
                                 max_states=max_states_per_bank)
            for b in banks]
