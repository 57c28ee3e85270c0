"""The index's query side: required-literal alternatives and split
pruning (the reference's index/plan.py).

If every match of a query must contain at least one member of a literal
set (its required-literal alternatives), a shard whose summary lacks some
trigram of every member cannot match.  The derivation is conservative:
whatever the walk cannot prove required gives None (the query is not
eligible and scans everything), never a weaker requirement than the
truth.  Not eligible: patterns that match the empty string, approximate
matching (edits can destroy any literal), and any alternative under 3
bytes.

The engine and the planner derive from the same inputs (the app options,
the engine's construction arguments), so they agree on eligibility.
Parsing is the port's own models/dfa parser.
"""

from __future__ import annotations

from distributed_grep_tpu_torch.index import summary as summary_mod
from distributed_grep_tpu_torch.models import dfa as _dfa

# A query needing more alternatives than this checks too many grams a
# shard to be worth the lookup.
MAX_ALTERNATIVES = 64


def _singleton(node) -> int | None:
    """The one byte of a one-member Char class, or None."""
    mask = node.mask
    if mask == 0 or mask & (mask - 1):
        return None
    return mask.bit_length() - 1


def _node_alts(node) -> list[bytes] | None:
    """Literals of which every match of ``node`` contains at least one, or
    None.  A weaker answer (a shorter run, more alternatives) stays
    sound; None only gives up pruning."""
    if isinstance(node, _dfa.Char):
        b = _singleton(node)
        return [bytes([b])] if b is not None else None
    if isinstance(node, _dfa.Anchor):
        return None
    if isinstance(node, _dfa.Repeat):
        if node.min < 1:
            return None
        sub = _node_alts(node.node)
        if sub is not None and len(sub) == 1 and len(sub[0]) == 1:
            return [sub[0] * min(node.min, 8)]  # a{3,} requires "aaa"
        return sub
    if isinstance(node, _dfa.Alt):
        out: list[bytes] = []
        for opt in node.options:
            sub = _node_alts(opt)
            if sub is None or len(out) + len(sub) > MAX_ALTERNATIVES:
                return None  # one free branch frees the alternation
            out.extend(sub)
        return out or None
    if isinstance(node, _dfa.Concat):
        # every part is required: take the best one; runs of one-byte
        # classes join into longer literals, anchors and other parts
        # break a run
        candidates: list[list[bytes]] = []
        run = b""
        for part in node.parts:
            b = _singleton(part) if isinstance(part, _dfa.Char) else None
            if b is not None:
                run += bytes([b])
                continue
            if run:
                candidates.append([run])
                run = b""
            if isinstance(part, _dfa.Anchor):
                continue
            sub = _node_alts(part)
            if sub is not None:
                candidates.append(sub)
        if run:
            candidates.append([run])
        best: list[bytes] | None = None
        best_len = 0
        for c in candidates:
            mn = min(len(x) for x in c)
            if mn > best_len:
                best, best_len = c, mn
        return best
    return None


class QueryRequirements:
    """The folded trigram codes of each required alternative;
    ``may_match(summary)`` is False only when every alternative misses a
    trigram ("cannot match")."""

    __slots__ = ("alternatives", "literals")

    def __init__(self, literals: list[bytes]):
        self.literals = literals
        self.alternatives = [summary_mod.trigram_codes(x) for x in literals]

    def may_match(self, summary: bytes) -> bool:
        return any(summary_mod.has_all_trigrams(summary, codes)
                   for codes in self.alternatives)


def _as_bytes(p) -> bytes:
    return (p.encode("utf-8", "surrogateescape") if isinstance(p, str)
            else bytes(p))


def requirements_for_query(pattern: str | bytes | None = None,
                           patterns: list | None = None,
                           ignore_case: bool = False,
                           max_errors: int = 0) -> QueryRequirements | None:
    """The query's required alternatives, or None (scan everything).  A
    literal set's members are its alternatives; a pattern is parsed
    case-sensitively (the summary's fold makes ``ignore_case`` a no-op
    here).  Every alternative must hold a trigram."""
    if max_errors:
        return None
    if patterns is not None:
        lits = [_as_bytes(p) for p in patterns]
        if not lits or len(lits) > MAX_ALTERNATIVES:
            return None
    else:
        if pattern is None:
            return None
        if isinstance(pattern, bytes):
            pattern = pattern.decode("utf-8", "surrogateescape")
        try:
            ast = _dfa._Parser(pattern, ignore_case=False).parse()
        except _dfa.RegexError:
            return None
        lits = _node_alts(ast)
        if not lits:
            return None
    if any(len(x) < 3 for x in lits):
        return None
    req = QueryRequirements(lits)
    if any(c.size == 0 for c in req.alternatives):
        return None
    return req


# ------------------------------------------------------------ split pruning

class SplitPruner:
    """What ``runtime/job.plan_map_splits`` asks of each input: a file
    whose summary rules the query out is dropped from the plan (no map
    task, no open, no launch).  Its tallies are the caller's to report;
    it does not touch the module counters, which are the engine's."""

    def __init__(self, requirements: QueryRequirements, store):
        self.requirements = requirements
        self.store = store
        self.shards_pruned = 0
        self.bytes_skipped = 0
        self.maybe_scans = 0

    def prune(self, path) -> bool:
        key = summary_mod.file_key(path)
        if key is None:
            return False
        s = summary_mod.summary_cache().lookup(key)
        if s is None and self.store is not None:
            s = self.store.load(key)
            if s is not None:
                summary_mod.summary_cache().put(key, s)
        if s is None:
            return False
        if self.requirements.may_match(s):
            self.maybe_scans += 1
            return False
        self.shards_pruned += 1
        self.bytes_skipped += key.n_bytes
        return True


# Options whose output for a shard with no match is not empty (-v gives
# every line, -c/-l/-L a record a file): the planner keeps their tasks.
# The engine's own pruning stays exact for them.
_UNPRUNABLE_OPTIONS = ("invert", "count_only", "presence_only")

GREP_APPLICATION = "distributed_grep_tpu_torch.apps.grep_cuda"


def pruner_for_job(config, index_root) -> SplitPruner | None:
    """A SplitPruner for this JobConfig, or None where pruning its plan is
    not sound or not possible: the index off, an application other than
    grep_cuda, an option of _UNPRUNABLE_OPTIONS, a query that is not
    eligible (or whose derivation raised), or nothing to consult."""
    if not summary_mod.env_index_enabled():
        return None
    if getattr(config, "application", None) != GREP_APPLICATION:
        return None
    opts = config.effective_app_options()
    if any(opts.get(k) for k in _UNPRUNABLE_OPTIONS):
        return None
    try:
        req = requirements_for_query(
            pattern=opts.get("pattern"), patterns=opts.get("patterns"),
            ignore_case=bool(opts.get("ignore_case")),
            max_errors=int(opts.get("max_errors") or 0))
    except Exception:  # noqa: BLE001 -- not eligible: scan everything
        req = None
    if req is None:
        return None
    from distributed_grep_tpu_torch.index.store import IndexStore

    store = IndexStore(index_root)
    if not (summary_mod.summary_cache().nonempty or store.root.is_dir()):
        return None  # no summary anywhere: spare every file its stat
    return SplitPruner(req, store)
