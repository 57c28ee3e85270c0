"""Scan-fusion planning (the reference's runtime/fusion.py): which print-
mode grep jobs may share one scan a map split.  ops/fuse.py is the
engine half.

* ``fusion_key(config)``: a grouping key over everything but the query
  (pattern, patterns, ignore_case): two jobs fuse only when their
  application, every other app option and their split-planning window
  agree, so one engine configuration serves the fused attempt and each
  participant keeps its own job's semantics;
* ``query_spec(options)``: the (pattern, patterns, ignore_case) tuple
  ops/fuse.QuerySpec takes, or None for a query that must scan alone
  (an empty pattern or member, a backreference, approximate matching);
* ``split_identity(split)``: the content identity of a map split, a
  (realpath, size, mtime_ns, inode) a member from a fresh stat (the
  corpus cache's validators).

The service daemon's planner (runtime/service.py) groups jobs by
``fusion_key`` and ``query_family`` (a set with sets, a pattern with
patterns; the reference's planner has no family), and reads the knobs:
``env_service_fuse`` (DGREP_SERVICE_FUSE, on by default; off, no job gets
a key and no assignment carries participants) and ``env_fuse_max_queries``
(DGREP_FUSE_MAX_QUERIES, the queries one fused attempt may serve).

``follow_fusion_key(config)`` groups standing queries (runtime/follow.py
FollowGroupRegistry): one suffix read and one union scan a grown file
serve every member of a group.

Imports nothing of the scan stack: planning runs on the control plane.
"""

from __future__ import annotations

import os

DEFAULT_FUSE_MAX_QUERIES = 8

# The one application whose map_fused_fn a fused attempt runs
FUSABLE_APPLICATION = "distributed_grep_tpu_torch.apps.grep_cuda"

# A fused attempt reads its split whole (GrepEngine.scan_batch): a larger
# split keeps the streaming solo path.
MAX_FUSED_SPLIT_BYTES = 256 << 20

# The query keys a fused group may differ on; every other app option must
# be equal across it.
_QUERY_KEYS = ("pattern", "patterns", "ignore_case")


def env_service_fuse(default: bool = True) -> bool:
    """DGREP_SERVICE_FUSE, the service's fusion switch: on by default;
    "0", "false" or "no" turns the planning off (assignments, their wire
    bytes and the outputs are then the unfused daemon's)."""
    raw = os.environ.get("DGREP_SERVICE_FUSE")
    if raw is None or raw == "":
        return default
    return raw.strip().lower() not in ("0", "false", "no")


def env_fuse_max_queries(default: int = DEFAULT_FUSE_MAX_QUERIES) -> int:
    """DGREP_FUSE_MAX_QUERIES, the queries one fused attempt may serve
    (malformed keeps ``default``; below 2 is 2: turning fusion off is
    DGREP_SERVICE_FUSE's job)."""
    raw = os.environ.get("DGREP_FUSE_MAX_QUERIES")
    if raw is None or raw == "":
        return default
    try:
        return max(2, int(raw))
    except ValueError:
        return default


def has_backref(rx: str) -> bool:
    """Whether the regex uses a group-number construct (a numbered or
    named backreference, a conditional group): joined into an alternation
    its groups would point elsewhere.  A pattern ``re`` cannot parse
    counts as True."""
    import re._parser as parser

    def walk(node) -> bool:
        if isinstance(node, parser.SubPattern):
            return any(walk(item) for item in node)
        if isinstance(node, tuple):
            if node[0] in (parser.GROUPREF, parser.GROUPREF_EXISTS):
                return True
            return any(walk(x) for x in node[1:])
        if isinstance(node, list):
            return any(walk(x) for x in node)
        return False

    try:
        return walk(parser.parse(rx))
    except Exception:  # noqa: BLE001 -- unparseable: not fusable
        return True


def query_spec(options: dict) -> tuple | None:
    """(pattern, patterns, ignore_case) when the job's query can join a
    union, else None."""
    if options.get("max_errors"):
        return None
    pats = options.get("patterns")
    ic = bool(options.get("ignore_case"))
    if pats:
        norm = tuple(p.decode("utf-8", "surrogateescape")
                     if isinstance(p, bytes) else str(p) for p in pats)
        if any(p == "" for p in norm):
            return None
        return (None, norm, ic)
    pat = options.get("pattern")
    if isinstance(pat, bytes):
        pat = pat.decode("utf-8", "surrogateescape")
    if not pat:
        return None  # the empty pattern matches every line: solo is free
    if has_backref(pat):
        return None
    return (pat, None, ic)


def _freeze(v):
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


def fusion_key(config) -> tuple | None:
    """The JobConfig's fusion group, or None when it can never fuse: an
    application other than grep_cuda, a count or presence job (their
    streaming paths stop early), a mesh, or a query no union hosts."""
    if getattr(config, "application", None) != FUSABLE_APPLICATION:
        return None
    opts = config.effective_app_options()
    if opts.get("count_only") or opts.get("presence_only"):
        return None
    if opts.get("mesh_shape"):
        return None
    if query_spec(opts) is None:
        return None
    rest = {k: v for k, v in opts.items() if k not in _QUERY_KEYS}
    try:
        frozen = tuple(sorted((k, _freeze(v)) for k, v in rest.items()))
    except TypeError:
        return None  # an option that does not sort or hash: solo
    return (config.application, frozen, int(config.effective_batch_bytes()))


def follow_fusion_key(config) -> tuple | None:
    """The fused group of a standing query, or None when it runs its own
    solo wake loop: ``fusion_key``'s grouping, the query's family (a set
    with sets, a pattern with patterns, as the batch planner groups them)
    and the watched files' realpaths (a follow cursor tracks a file's
    content as it grows, so the corpus cache's size and mtime, which
    change with every append, are not part of the key).  Stats the
    inputs: call it with no service lock held."""
    if not getattr(config, "follow", False):
        return None
    base = fusion_key(config)
    if base is None:
        return None
    try:
        watched = tuple(sorted(os.path.realpath(os.fspath(f))
                               for f in config.input_files))
    except (OSError, TypeError):
        return None
    if not watched:
        return None
    return (base, query_family(config.effective_app_options()), watched)


def query_family(options: dict) -> str:
    """"set" for a literal-set query (``patterns``), else "pattern".  The
    service's planner fuses a query only with its own family: a union of a
    set with a pattern is one alternation of every member, which past a
    few dozen members no kernel hosts (its engine routes to a host
    scanner, so FusedScanner raises FuseError on the card, after building
    it); two sets merge into one set, and patterns into one alternation,
    each on a kernel."""
    return "set" if options.get("patterns") else "pattern"


def split_identity(split) -> tuple | None:
    """A (realpath, size, mtime_ns, inode) a member of a map split (a path
    or a list of paths), or None when a member cannot be statted or the
    split is past MAX_FUSED_SPLIT_BYTES."""
    members = split if isinstance(split, (list, tuple)) else [split]
    out = []
    total = 0
    for m in members:
        try:
            real = os.path.realpath(os.fspath(m))
            st = os.stat(real)
        except OSError:
            return None
        total += int(st.st_size)
        out.append((real, int(st.st_size), int(st.st_mtime_ns),
                    int(st.st_ino)))
    if total > MAX_FUSED_SPLIT_BYTES:
        return None
    return tuple(out)


def plan_identities(map_splits: list) -> tuple[list, dict]:
    """(identities, index) of a job's map splits: identities[i] is
    split_identity(map_splits[i]) and index maps an identity to the
    first task id holding it (task ids are split indices)."""
    identities = [split_identity(s) for s in map_splits]
    index = {}
    for tid, ident in enumerate(identities):
        if ident is not None and ident not in index:
            index[ident] = tid
    return identities, index


def split_n_bytes(identity) -> int:
    """The content bytes of a split identity."""
    return sum(v[1] for v in identity) if identity else 0
