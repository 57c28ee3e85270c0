"""The invariant rules: each encodes one correctness contract of the
package.

The first eleven are the reference's (distributed_grep_tpu's
analysis/rules.py), translated where this package differs:
``locked-blocking`` knows the blocking calls of torch, CUDA and the
kernel builds, and ``env-knobs`` and ``event-registry`` see through a
helper whose parameter reaches the environment read or the event's name
(``ops/layout._env_int``, ``runtime/follow._wake_event``).  The
reference's two Pallas rules (``mosaic-ceilings``, ``shard-map-rep``)
have no source to check here; their place goes to this package's own
rules: ``own-copy`` (no jax, nothing of the reference), ``no-fallback``
(no plain leg that hides a failed card or kernel) and ``cuda-abi`` (the
ctypes bindings against the ``extern "C"`` signatures of ``csrc/``, the
build's source lists, the shared-memory budget).

Every rule walks real ASTs (no regex-over-source false positives from
strings or comments; ``cuda-abi`` reads the C sources with comments
stripped) and reports ``Violation(rule, path, line, message)`` records.
Rules are registered in ``RULES``; the checker (checker.py) runs them
over a project root — the installed package by default, a fixture
mini-tree in tests/test_torch_analysis.py, which pins each rule against
both false negatives (fires on a known-bad snippet) and false positives
(stays silent on this package).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Iterator


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str  # project-root-relative, posix separators
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Project:
    """Parsed view of a source tree; trees are parsed once and shared."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self._cache: dict[str, ast.Module | None] = {}
        self._files: list[str] | None = None
        # scratch space rules share within one run (e.g. the R9/R10 lock
        # declarations, derived once per file instead of once per rule)
        self.cache: dict = {}

    def files(self) -> list[str]:
        if self._files is None:
            self._files = sorted(
                p.relative_to(self.root).as_posix()
                for p in self.root.rglob("*.py")
                if "__pycache__" not in p.parts
            )
        return self._files

    def tree(self, rel: str) -> ast.Module | None:
        if rel not in self._cache:
            try:
                src = (self.root / rel).read_text(encoding="utf-8",
                                                  errors="surrogateescape")
                self._cache[rel] = ast.parse(src)
            except (OSError, SyntaxError, ValueError):
                # ValueError: ast.parse raises UnicodeEncodeError on
                # surrogateescape-decoded non-UTF-8 source — skip the
                # file like a SyntaxError, don't abort the whole run
                self._cache[rel] = None
        return self._cache[rel]


# --------------------------------------------------------------- AST helpers

def _last_name(node: ast.AST) -> str:
    """Trailing identifier of a Name/Attribute chain ('' otherwise)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted form of a Name/Attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _str_consts(node: ast.AST) -> Iterator[str]:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            yield n.value
        elif isinstance(n, ast.Constant) and isinstance(n.value, bytes):
            yield n.value.decode("latin-1")


def _scope_assignments(scope: ast.AST) -> dict[str, list[ast.expr]]:
    """name -> assigned value expressions, within one function/module scope
    (nested function bodies are NOT descended — they are their own scope)."""
    out: dict[str, list[ast.expr]] = {}

    def visit(body: Iterable[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.Assign) and stmt.value is not None:
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        out.setdefault(tgt.id, []).append(stmt.value)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                if isinstance(stmt.target, ast.Name):
                    out.setdefault(stmt.target.id, []).append(stmt.value)
            elif isinstance(stmt, ast.AugAssign):
                if isinstance(stmt.target, ast.Name):
                    out.setdefault(stmt.target.id, []).append(stmt.value)
            # descend statement bodies that stay in this scope
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list):
                    visit(sub)
            for h in getattr(stmt, "handlers", []) or []:
                visit(h.body)

    visit(scope.body)  # type: ignore[attr-defined]
    return out


def _enclosing_scopes(tree: ast.Module) -> list[tuple[ast.AST, list[ast.AST]]]:
    """[(scope_node, [calls and other nodes directly in that scope])] for
    the module and every (possibly nested) function."""
    scopes: list[tuple[ast.AST, list[ast.AST]]] = []

    def collect(scope: ast.AST) -> None:
        nodes: list[ast.AST] = []
        stack = list(getattr(scope, "body", []))
        funcs: list[ast.AST] = []
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs.append(n)
                continue
            nodes.append(n)
            stack.extend(ast.iter_child_nodes(n))
        scopes.append((scope, nodes))
        for f in funcs:
            collect(f)

    collect(tree)
    return scopes


def _call_arg(call: ast.Call, index: int, param: str) -> ast.expr | None:
    """The argument a call passes to positional ``index`` / keyword
    ``param`` (None when it passes none, or through a ``*args``)."""
    if any(isinstance(a, ast.Starred) for a in call.args[:index + 1]):
        return None
    if index < len(call.args):
        return call.args[index]
    for k in call.keywords:
        if k.arg == param:
            return k.value
    return None


def _helpers(project: Project, key: str,
             sink: Callable[[ast.AST], tuple[str, object] | None]
             ) -> dict[str, tuple[int, str, object]]:
    """Pass-through helpers of the project: function name -> (positional
    index at its call sites, parameter name, what ``sink`` said) for each
    function one of whose parameters reaches a sink inside its body
    (``sink(node)`` gives (the name the sink reads, data) or None).  A
    leading ``self``/``cls`` is not counted in the index.  Call sites
    match by the callee's trailing name, project-wide; memoized per run."""
    memo = project.cache.get(("helpers", key))
    if memo is not None:
        return memo
    functions = project.cache.get("functions")
    if functions is None:  # one walk per run, shared by every sink
        functions = project.cache["functions"] = []
        for rel in project.files():
            tree = project.tree(rel)
            if tree is None:
                continue
            for fn, nodes in _enclosing_scopes(tree)[1:]:
                params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
                shift = 1 if params[:1] in (["self"], ["cls"]) else 0
                functions.append((fn.name, params, shift, nodes))
    out: dict[str, tuple[int, str, object]] = {}
    for name, params, shift, nodes in functions:
        for node in nodes:
            hit = sink(node)
            if hit is not None and hit[0] in params:
                out[name] = (params.index(hit[0]) - shift, hit[0], hit[1])
                break
    project.cache[("helpers", key)] = out
    return out


def _const_strs(expr: ast.expr | None,
                consts: dict[str, set[str]]) -> set[str]:
    """String constants an argument can be: a constant, each arm of a
    conditional expression, or a name assigned string constants."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return {expr.value}
    if isinstance(expr, ast.IfExp):
        return _const_strs(expr.body, consts) | _const_strs(expr.orelse,
                                                           consts)
    if isinstance(expr, ast.Name):
        return consts.get(expr.id, set())
    return set()


# ------------------------------------------------------------------- rule R1

_RE_PATTERN_FUNCS = {"compile", "search", "match", "fullmatch", "finditer",
                     "findall", "sub", "subn", "split"}
_SANITIZERS = {"expand_posix_classes", "escape"}


def _re_aliases(tree: ast.Module) -> set[str]:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "re":
                    names.add(a.asname or "re")
    return names


def _expr_sanitized(expr: ast.expr, env: dict[str, list[ast.expr]],
                    visited: set[str]) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call) and _last_name(node.func) in _SANITIZERS:
            return True
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id not in visited:
            visited.add(node.id)
            for v in env.get(node.id, ()):
                if _expr_sanitized(v, env, visited):
                    return True
    return False


def _resolves_to_literal(expr: ast.expr, env: dict[str, list[ast.expr]],
                         visited: set[str] | None = None) -> bool:
    """True when the pattern is built from constants alone — an
    app-internal literal the author wrote, not a user pattern.  Names
    resolve through the scope's assignments, so a hoisted module constant
    (``_WORD = rb"[A-Za-z]+"`` ... ``re.findall(_WORD, ...)``) stays
    exempt; any Call/Attribute, or a name with no all-literal assignment,
    makes it computed."""
    if visited is None:
        visited = set()
    if any(isinstance(n, (ast.Call, ast.Attribute)) for n in ast.walk(expr)):
        return False
    for node in ast.walk(expr):
        if isinstance(node, ast.Name):
            if node.id in visited:
                continue
            visited.add(node.id)
            vals = env.get(node.id)
            if not vals or not all(
                    _resolves_to_literal(v, env, visited) for v in vals):
                return False
    return True


def rule_posix_expand(project: Project) -> Iterator[Violation]:
    """R1: every ``re`` handoff of a non-literal pattern must route through
    ``models/dfa.expand_posix_classes`` (or ``re.escape`` for literals).
    Python's re misparses POSIX bracket classes ('[[:digit:]]' matches
    ':digit' members), so an unexpanded handoff silently changes the
    language the confirm/fallback matcher accepts."""
    for rel in project.files():
        tree = project.tree(rel)
        if tree is None:
            continue
        aliases = _re_aliases(tree)
        if not aliases:
            continue
        module_env = _scope_assignments(tree)
        for scope, nodes in _enclosing_scopes(tree):
            env = dict(module_env)
            if scope is not tree:
                env.update(_scope_assignments(scope))
            for node in nodes:
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in _RE_PATTERN_FUNCS
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id in aliases
                        and node.args):
                    continue
                pat = node.args[0]
                if _resolves_to_literal(pat, env):
                    continue
                if _expr_sanitized(pat, env, set()):
                    continue
                yield Violation(
                    "posix-expand", rel, node.lineno,
                    f"re.{node.func.attr} on a computed pattern with no "
                    f"expand_posix_classes/re.escape on any path to it — "
                    f"POSIX bracket classes would be misparsed by re",
                )


# ------------------------------------------------------------------- rule R2

_RAW_READERS = {"glob", "iglob", "rglob", "listdir", "scandir", "iterdir"}


def rule_store_resolve(project: Project) -> Iterator[Violation]:
    """R2: no raw ``glob``/``listdir``/``open`` over work-dir ``mr-*``
    artifacts outside runtime/store.py.  On non-atomic stores, commit
    RECORDS are the unit of truth — a raw directory scan sees torn
    ``.part.*`` files and duplicate attempts; readers must resolve through
    ``WorkDir.list_outputs`` / ``store.get``."""
    for rel in project.files():
        if rel == "runtime/store.py":
            continue
        tree = project.tree(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            is_reader = (
                (isinstance(fn, ast.Name) and fn.id == "open")
                or (isinstance(fn, ast.Attribute) and fn.attr in _RAW_READERS)
            )
            if not is_reader:
                continue
            hit = next(
                (s for a in list(node.args)
                 + [k.value for k in node.keywords]
                 for s in _str_consts(a) if "mr-" in s),
                None,
            )
            if hit is not None:
                name = _last_name(fn) or "open"
                yield Violation(
                    "store-resolve", rel, node.lineno,
                    f"raw {name}() over {hit!r}: mr-* artifacts must "
                    f"resolve through the work dir's Store "
                    f"(WorkDir.list_outputs / store.get) — commit records, "
                    f"not file existence, are the unit of truth",
                )


# ------------------------------------------------------------------- rule R3

_R3_SCOPE = ("runtime/", "apps/")
_R3_FILES = ("__main__.py",)
_UTF8 = {None, "utf-8", "utf8", "UTF-8", "UTF8"}


def rule_surrogateescape(project: Project) -> Iterator[Violation]:
    """R3: str<->bytes conversions on the data plane (runtime/, apps/, the
    CLI) must state an ``errors=`` policy.  Pattern and path bytes
    round-trip via surrogateescape everywhere (display decodes use
    'replace' deliberately); a bare .encode()/.decode() is a latent
    UnicodeError on the first non-UTF-8 filename or pattern byte.
    json.dumps(...).encode(...) is exempt (ASCII by construction), as are
    non-UTF-8 codecs (declared fixed-alphabet data, e.g. ascii hex)."""
    for rel in project.files():
        if not (rel.startswith(_R3_SCOPE) or rel in _R3_FILES):
            continue
        tree = project.tree(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("encode", "decode")):
                continue
            encoding = None
            if node.args and isinstance(node.args[0], ast.Constant):
                encoding = node.args[0].value
            for k in node.keywords:
                if k.arg == "encoding" and isinstance(k.value, ast.Constant):
                    encoding = k.value.value
            if node.args and not isinstance(node.args[0], ast.Constant):
                encoding = "<dynamic>"  # can't prove it's utf-8: still flag
            if isinstance(encoding, str) and encoding not in _UTF8 \
                    and encoding != "<dynamic>":
                continue  # ascii/latin-1 etc: fixed-alphabet by declaration
            has_errors = len(node.args) >= 2 or any(
                k.arg == "errors" for k in node.keywords)
            if has_errors:
                continue
            recv = node.func.value
            if isinstance(recv, ast.Call) and _last_name(recv.func) == "dumps":
                continue  # json.dumps output is ASCII by construction
            yield Violation(
                "surrogateescape", rel, node.lineno,
                f".{node.func.attr}() without an errors= policy on a "
                f"data-plane path — pattern/path bytes round-trip via "
                f"surrogateescape (display output uses 'replace')",
            )


# ------------------------------------------------------------------- rule R4

def _env_key_expr(node: ast.AST) -> ast.expr | None:
    """The key expression of an environment READ (``os.environ.get(k)``,
    ``os.getenv(k)``, ``os.environ[k]``), or None."""
    if isinstance(node, ast.Call) and node.args:
        dn = _dotted(node.func)
        if dn.endswith("environ.get") or _last_name(node.func) == "getenv":
            return node.args[0]
    elif (isinstance(node, ast.Subscript)
          and isinstance(node.ctx, ast.Load)
          and _last_name(node.value) == "environ"):
        return node.slice
    return None


def _env_sink(node: ast.AST) -> tuple[str, object] | None:
    key = _env_key_expr(node)
    return (key.id, None) if isinstance(key, ast.Name) else None


def _env_reads(tree: ast.Module,
               helpers: dict[str, tuple[int, str, object]] | None = None
               ) -> Iterator[tuple[str, int]]:
    """(var, line) for each environment READ with a resolvable key.
    Key constants resolve through EVERY scope's assignments (module
    ``_ENV_VAR = ...`` indirection and function-local names alike); a
    name assigned several string constants yields each — over-reporting
    beats a knob read hidden behind a local variable.  A call of a
    ``helpers`` entry (a function whose parameter is the key it reads,
    ``ops/layout._env_int``) is a read of the key its call site passes."""
    consts: dict[str, set[str]] = {}
    for scope, _ in _enclosing_scopes(tree):
        for name, exprs in _scope_assignments(scope).items():
            for e in exprs:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    consts.setdefault(name, set()).add(e.value)

    for node in ast.walk(tree):
        key = _env_key_expr(node)
        if key is None and helpers and isinstance(node, ast.Call):
            helper = helpers.get(_last_name(node.func))
            if helper is not None:
                key = _call_arg(node, helper[0], helper[1])
        for var in sorted(_const_strs(key, consts)):
            yield var, node.lineno


def rule_env_knobs(project: Project) -> Iterator[Violation]:
    """R4: each DGREP_* env knob is read by exactly one owner module — the
    one registered in analysis/knobs.py (which doubles as the generated
    operator docs).  Two parsers of one knob can disagree on a malformed
    override (the DGREP_BATCH_BYTES failure mode env_batch_bytes guards);
    an unregistered knob is undocumented and unowned, and a knob listed
    as not ported must not be read.  A helper whose parameter is the key
    it reads counts as a read at each call site."""
    from distributed_grep_tpu_torch.analysis.knobs import KNOBS, NOT_PORTED

    helpers = _helpers(project, "env", _env_sink)
    seen: dict[str, list[tuple[str, int]]] = {}
    for rel in project.files():
        tree = project.tree(rel)
        if tree is None:
            continue
        for var, line in _env_reads(tree, helpers):
            if var.startswith("DGREP_"):
                seen.setdefault(var, []).append((rel, line))
    for var in sorted(seen):
        knob = KNOBS.get(var)
        for rel, line in seen[var]:
            if knob is None and var in NOT_PORTED:
                yield Violation(
                    "env-knobs", rel, line,
                    f"{var} is listed in analysis/knobs.py NOT_PORTED but "
                    f"read here: move it to KNOBS (owner, default, doc)",
                )
            elif knob is None:
                yield Violation(
                    "env-knobs", rel, line,
                    f"unregistered env knob {var}: add it (owner, default, "
                    f"doc) to analysis/knobs.py KNOBS",
                )
            elif rel != knob.owner:
                yield Violation(
                    "env-knobs", rel, line,
                    f"{var} read outside its owner module {knob.owner} — "
                    f"import the owner's accessor instead of re-parsing "
                    f"the env var",
                )
    # stale registry entries: the owner module exists but never reads the
    # knob (fixture mini-trees without the owner file stay silent)
    for var, knob in KNOBS.items():
        if var in seen:
            continue
        if (project.root / knob.owner).exists():
            yield Violation(
                "env-knobs", knob.owner, 1,
                f"registered env knob {var} is never read by its owner "
                f"{knob.owner}: stale registry entry in analysis/knobs.py",
            )


# ------------------------------------------------------------------- rule R5

def _is_dataclass(node: ast.ClassDef) -> bool:
    return any(_last_name(d if not isinstance(d, ast.Call) else d.func)
               == "dataclass" for d in node.decorator_list)


def _field_default(expr: ast.expr | None):
    """(known, value): the field's declared default, when statically
    derivable.  field(default_factory=list/dict) -> []/{}."""
    if expr is None:
        return False, None
    if isinstance(expr, ast.Constant):
        return True, expr.value
    if isinstance(expr, ast.Call) and _last_name(expr.func) == "field":
        for k in expr.keywords:
            if k.arg == "default_factory":
                factory = _last_name(k.value)
                if factory == "list":
                    return True, []
                if factory == "dict":
                    return True, {}
            if k.arg == "default" and isinstance(k.value, ast.Constant):
                return True, k.value.value
    return False, None


def _is_optional_ann(ann: ast.expr | None) -> bool:
    if ann is None:
        return False
    for n in ast.walk(ann):
        if isinstance(n, ast.Constant) and n.value is None:
            return True
        if isinstance(n, ast.Name) and n.id == "Optional":
            return True
        # annotations arrive as strings under `from __future__ import
        # annotations`-style quoting: "dict | None"
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and "None" in n.value:
            return True
    return False


def _str_seq_assign(tree: ast.AST, name: str):
    """(values, lineno) of a module-level ``NAME = ("a", "b", ...)`` tuple/
    list of string constants; (None, 1) when absent."""
    for node in ast.walk(tree):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if (targets
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in targets)
                and isinstance(node.value, (ast.Tuple, ast.List))):
            return ([e.value for e in node.value.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str)], node.lineno)
    return None, 1


def rule_rpc_elide(project: Project, rel: str = "runtime/rpc.py"
                   ) -> Iterator[Violation]:
    """R5: wire-compat reflection over the RPC schema, both halves.  Every
    Optional-default field on the rpc dataclasses must appear in
    ``_ELIDE_DEFAULTS`` (else a span-disabled run's payloads grow keys old
    peers choke on), every elide key must exist as a field, and the
    registered elide default must EQUAL the field's declared default on
    every dataclass carrying it (drift silently un-elides the field).
    Reply side: every field on a ``*Reply`` dataclass must be declared on
    exactly one side of the wire contract — ``_REPLY_BASE`` (historical
    asdict shape, always present) or ``_REPLY_ELIDE`` (dropped at its
    falsy default by ``reply_to_dict`` — old peers interop) — and an
    elide-registered field's default must be falsy, because reply_to_dict
    elides by ``not value``: a truthy default never elides and the
    registration is a lie."""
    tree = project.tree(rel)
    if tree is None:
        return
    elide: dict[str, object] | None = None
    elide_line = 1
    for node in ast.walk(tree):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if (targets
                and any(isinstance(t, ast.Name) and t.id == "_ELIDE_DEFAULTS"
                        for t in targets)
                and isinstance(node.value, ast.Dict)):
            elide, elide_line = {}, node.lineno
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    try:
                        elide[k.value] = ast.literal_eval(v)
                    except ValueError:
                        elide[k.value] = _field_default(v)[1]
    if elide is None:
        yield Violation("rpc-elide", rel, 1,
                        "no _ELIDE_DEFAULTS dict literal found")
        return
    field_names: set[str] = set()
    for cls in ast.walk(tree):
        if not (isinstance(cls, ast.ClassDef) and _is_dataclass(cls)):
            continue
        for stmt in cls.body:
            if not (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                continue
            name = stmt.target.id
            field_names.add(name)
            known, default = _field_default(stmt.value)
            if (_is_optional_ann(stmt.annotation) and stmt.value is not None
                    and name not in elide):
                yield Violation(
                    "rpc-elide", rel, stmt.lineno,
                    f"Optional-default field {cls.name}.{name} missing from "
                    f"_ELIDE_DEFAULTS: span-disabled payloads would grow a "
                    f"key old peers reject",
                )
            if name in elide and known and elide[name] != default:
                yield Violation(
                    "rpc-elide", rel, stmt.lineno,
                    f"_ELIDE_DEFAULTS[{name!r}] == {elide[name]!r} but "
                    f"{cls.name}.{name} defaults to {default!r}: elision "
                    f"would silently stop matching the wire default",
                )
    for key in sorted(set(elide) - field_names):
        yield Violation(
            "rpc-elide", rel, elide_line,
            f"_ELIDE_DEFAULTS key {key!r} is not a field on any rpc "
            f"dataclass: dead elision entry",
        )

    replies = [cls for cls in ast.walk(tree)
               if isinstance(cls, ast.ClassDef) and _is_dataclass(cls)
               and cls.name.endswith("Reply")]
    if not replies:
        return
    base, base_line = _str_seq_assign(tree, "_REPLY_BASE")
    reply_elide, relide_line = _str_seq_assign(tree, "_REPLY_ELIDE")
    if base is None or reply_elide is None:
        yield Violation(
            "rpc-elide", rel, replies[0].lineno,
            "reply dataclasses present but _REPLY_BASE/_REPLY_ELIDE tuple "
            "literals missing: every reply field must declare its wire side",
        )
        return
    base_set, elide_set = set(base), set(reply_elide)
    for key in sorted(base_set & elide_set):
        yield Violation(
            "rpc-elide", rel, relide_line,
            f"reply field {key!r} registered in BOTH _REPLY_BASE and "
            f"_REPLY_ELIDE: the wire contract must pick one side",
        )
    reply_field_names: set[str] = set()
    for cls in replies:
        for stmt in cls.body:
            if not (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                continue
            name = stmt.target.id
            reply_field_names.add(name)
            if name not in base_set and name not in elide_set:
                yield Violation(
                    "rpc-elide", rel, stmt.lineno,
                    f"reply field {cls.name}.{name} is in neither "
                    f"_REPLY_BASE nor _REPLY_ELIDE: a new reply field must "
                    f"declare its wire side (elide it unless old peers "
                    f"already expect the key)",
                )
            if name in elide_set:
                known, default = _field_default(stmt.value)
                if known and default:
                    yield Violation(
                        "rpc-elide", rel, stmt.lineno,
                        f"_REPLY_ELIDE field {cls.name}.{name} defaults to "
                        f"{default!r} (truthy): reply_to_dict elides falsy "
                        f"values only, so this registration never fires",
                    )
    for key in sorted((base_set | elide_set) - reply_field_names):
        yield Violation(
            "rpc-elide", rel,
            base_line if key in base_set else relide_line,
            f"reply registry key {key!r} is not a field on any *Reply "
            f"dataclass: dead wire-contract entry",
        )


# ------------------------------------------------------------------- rule R7

_LOG_ROOTS = ("runtime/", "utils/", "parallel/")
_LOG_EXEMPT = "utils/logging.py"


def rule_logging(project: Project) -> Iterator[Violation]:
    """R7: control-plane modules (runtime/, utils/, parallel/) log via
    utils.logging.get_logger only — no bare print() (stdout is a DATA
    contract: bench.py's one-JSON-line, the CLI's user output), no root
    logging.getLogger.  Migrated from the grep-based obs test; AST-walked,
    so prints in nested expressions are caught too."""
    for rel in project.files():
        if not rel.startswith(_LOG_ROOTS):
            continue
        tree = project.tree(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Name) and node.func.id == "print":
                    yield Violation(
                        "logging", rel, node.lineno,
                        "bare print() on a control-plane path (use "
                        "utils.logging.get_logger)",
                    )
                elif (rel != _LOG_EXEMPT
                      and isinstance(node.func, ast.Attribute)
                      and node.func.attr == "getLogger"
                      and _last_name(node.func.value) == "logging"):
                    yield Violation(
                        "logging", rel, node.lineno,
                        "root-logger use (want utils.logging.get_logger)",
                    )
            elif isinstance(node, ast.Assign):
                if (any(isinstance(t, ast.Name) and t.id == "log"
                        for t in node.targets)
                        and not (isinstance(node.value, ast.Call)
                                 and _last_name(node.value.func)
                                 == "get_logger")):
                    yield Violation(
                        "logging", rel, node.lineno,
                        "log defined without get_logger",
                    )


# ------------------------------------------------------------------- rule R8

_NET_SCOPE = ("runtime/",)
_NET_FILES = ("__main__.py",)
_NET_EXEMPT = "runtime/http_transport.py"
# Raw client-side connection constructors: urlopen plus the http.client /
# socket primitives it wraps.  Server-side classes (ThreadingHTTPServer)
# are not listed — serving has no retry story to bypass.
_RAW_NET_CALLS = {"urlopen", "create_connection", "HTTPConnection",
                  "HTTPSConnection"}


def rule_net_retry(project: Project) -> Iterator[Violation]:
    """R8: no raw ``urlopen``/client-socket calls on control-plane paths
    (runtime/, the CLI) outside runtime/http_transport.py — every client
    HTTP call routes through the transport's bounded-jittered-retry
    helpers (``HttpTransport._request`` / ``client_call``).  A raw call
    dies on the first transient connection reset, exactly the failure the
    retry layer exists to absorb (a daemon restart resets EVERY attached
    client at once), and silently forks the retry policy the
    DGREP_RPC_RETRIES/DGREP_RPC_BACKOFF_S knobs are supposed to govern.

    Round 18 extension (active/standby failover): comma-splitting an
    address outside http_transport is also flagged — address-list
    rotation lives INSIDE the shared retry loop (``split_addrs`` + the
    transport's rotating ``base``), and a hand-rolled split grows a
    second rotation policy that the failover machinery can't see (it
    would pin one member, or rotate on HTTPError, or skip the jittered
    backoff)."""
    for rel in project.files():
        if not (rel.startswith(_NET_SCOPE) or rel in _NET_FILES):
            continue
        if rel == _NET_EXEMPT:
            continue
        tree = project.tree(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _last_name(node.func)
            if name in _RAW_NET_CALLS:
                yield Violation(
                    "net-retry", rel, node.lineno,
                    f"raw {name}() on a control-plane path: client HTTP "
                    f"calls must route through the retry-wrapped transport "
                    f"helpers (http_transport._request / client_call) — a "
                    f"bare call dies on the first transient reset and "
                    f"bypasses the DGREP_RPC_RETRIES policy",
                )
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "split"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value == ","
                    and "addr" in ast.unparse(node.func.value).lower()):
                yield Violation(
                    "net-retry", rel, node.lineno,
                    "address list split outside http_transport: use "
                    "split_addrs / the transport's rotating base — a "
                    "hand-rolled comma split forks the failover rotation "
                    "policy out of the shared retry loop",
                )


# --------------------------------------------- shared lock model (R9/R10)
# The concurrency rules resolve lock expressions through their
# construction sites, so the static layer reads the SAME declarations the
# dynamic harness (utils/lockdep.py) instruments:
#
#   X = lockdep.make_lock("name", io_ok=True)     -> node "name", io_ok
#   self._lock = threading.Lock()                 -> node "<rel>:<attr>"
#   self._cond = threading.Condition(self._lock)  -> alias of self._lock
#
# ``io_ok=True`` is the blessed escape for locks whose PURPOSE is
# serializing blocking work (registry/journal/start flush, the model-cache
# compile lock, the kernels' table uploads) — R9 skips their critical
# sections; R10 still graphs them.

_CONC_SCOPE = ("runtime/", "ops/", "parallel/")
_LOCKISH_SUFFIXES = ("lock", "cond", "mutex")


def _lock_ctor_info(value: ast.expr) -> tuple[str | None, bool] | None:
    """(make_lock name or None, io_ok) when ``value`` constructs a lock;
    None when it does not."""
    if not isinstance(value, ast.Call):
        return None
    fname = _last_name(value.func)
    if fname in ("make_lock", "make_rlock"):
        name = None
        if value.args and isinstance(value.args[0], ast.Constant) \
                and isinstance(value.args[0].value, str):
            name = value.args[0].value
        io_ok = any(
            k.arg == "io_ok" and isinstance(k.value, ast.Constant)
            and bool(k.value.value)
            for k in value.keywords
        )
        return name, io_ok
    if fname in ("Lock", "RLock"):
        return None, False
    return None


class _LockDecls:
    """Lock bindings of one module: (class-or-None, binding name) ->
    (node id, io_ok).  Condition(self._lock) aliases the wrapped lock.
    One recursive pass over the tree (the enclosing class travels down
    with the recursion — no per-class re-walk)."""

    def __init__(self, tree: ast.Module, rel: str):
        self.rel = rel
        self.map: dict[tuple[str | None, str], tuple[str, bool]] = {}
        self._collect(tree, None)

    def _bind(self, cls: str | None, name: str, value: ast.expr) -> None:
        info = _lock_ctor_info(value)
        if info is not None:
            node_id, io_ok = info
            self.map[(cls, name)] = (node_id or f"{self.rel}:{name}", io_ok)
            return
        # Condition over a declared lock: alias the lock's node
        if isinstance(value, ast.Call) \
                and _last_name(value.func) == "Condition" and value.args:
            tgt = value.args[0]
            key = None
            if isinstance(tgt, ast.Attribute) \
                    and _last_name(tgt.value) == "self":
                key = (cls, tgt.attr)
            elif isinstance(tgt, ast.Name):
                key = (cls, tgt.id) if (cls, tgt.id) in self.map \
                    else (None, tgt.id)
            if key in self.map:
                self.map[(cls, name)] = self.map[key]

    def _collect(self, scope: ast.AST, cls: str | None) -> None:
        for node in ast.iter_child_nodes(scope):
            if isinstance(node, ast.ClassDef):
                self._collect(node, node.name)
                continue
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if cls is not None and isinstance(tgt, ast.Attribute) \
                            and _last_name(tgt.value) == "self":
                        self._bind(cls, tgt.attr, node.value)
                    elif isinstance(tgt, ast.Name):
                        self._bind(cls, tgt.id, node.value)
            self._collect(node, cls)

    def resolve(self, expr: ast.expr,
                cls: str | None) -> tuple[str, bool] | None:
        """(node id, io_ok) for a with-item lock expression, or None when
        the expression is not lock-like.  Undeclared names that END in
        lock/cond still count (io_ok False) — an unregistered lock must
        not silently escape the rules."""
        if isinstance(expr, ast.Attribute) and _last_name(expr.value) == "self":
            hit = self.map.get((cls, expr.attr))
            if hit is not None:
                return hit
            name = expr.attr
        elif isinstance(expr, ast.Name):
            hit = self.map.get((cls, expr.id)) or self.map.get((None, expr.id))
            if hit is not None:
                return hit
            name = expr.id
        else:
            return None
        stripped = name.lstrip("_").lower()
        if stripped.endswith(_LOCKISH_SUFFIXES):
            return f"{self.rel}:{name}", False
        return None


def _decls_for(project: Project, rel: str, tree: ast.Module) -> _LockDecls:
    """Per-run memo of a file's lock declarations (R9 and R10 both need
    them; deriving once per file keeps the repo-wide analyze fast)."""
    key = ("lock-decls", rel)
    decls = project.cache.get(key)
    if decls is None:
        decls = project.cache[key] = _LockDecls(tree, rel)
    return decls


def _functions_with_class(tree: ast.Module
                          ) -> Iterator[tuple[str | None, ast.AST]]:
    """(enclosing class name or None, function node) for every function,
    carrying the nearest enclosing class through nested defs (closures in
    a method still see that method's ``self``)."""

    def rec(node: ast.AST, cls: str | None) -> Iterator:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from rec(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield cls, child
                yield from rec(child, cls)
            else:
                yield from rec(child, cls)

    yield from rec(tree, None)


# ------------------------------------------------------------------- rule R9

# Blocking primitives by bare callable name (Name or trailing Attribute).
_BLOCKING_CALLS = {
    "open", "urlopen", "create_connection",
    # engine/journal/log construction: model compile, file open+fsync
    "GrepEngine", "TaskJournal", "EventLog", "WorkDir", "Popen",
    # the cross-job engine cache (a miss compiles a model), a process
    # group's rendezvous, and ops/_build's compiles (nvcc, g++)
    "cached_engine", "init_process_group", "build_all", "build_host",
    "load_host",
}
# Attribute calls gated on the receiver (os.replace yes, str.replace no).
# Receivers are matched with leading underscores and a "_mod" suffix
# stripped: ``_build.load`` is receiver "build".
_BLOCKING_RECV_ATTRS = {
    "os": {"fsync", "replace", "rename", "unlink", "remove"},
    "time": {"sleep"},
    "subprocess": {"run", "call", "check_call", "check_output"},
    "shutil": {"rmtree", "copyfile", "copy", "move"},
    "build": {"load", "load_host", "build_all", "build_host"},
}
# torch.distributed's collectives and group calls: each waits for every
# rank (receiver ``dist`` or ``torch.distributed``).
_DIST_CALLS = {
    "init_process_group", "destroy_process_group", "new_group", "barrier",
    "all_reduce", "all_gather", "all_gather_object",
    "all_gather_into_tensor", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "broadcast", "broadcast_object_list",
    "gather", "gather_object", "scatter", "all_to_all",
    "all_to_all_single", "send", "recv", "monitored_barrier",
}
# Any method call on these receivers is filesystem/flush work: the
# journal/registry fsync per record, event logs flush per batch, stores
# and work dirs touch the work-dir filesystem.
_IO_RECEIVERS = {"journal", "event_log", "registry", "store", "workdir"}


def _is_device_arg(expr: ast.expr) -> bool:
    """A ``.to()`` argument that names a device (``device``, ``dev``,
    ``x.device``, ``"cuda..."``), not a dtype."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value.startswith(("cuda", "cpu"))
    return _last_name(expr).lstrip("_") in ("device", "dev")


def _blocking_call(node: ast.Call) -> str | None:
    """A short label when ``node`` is a blocking call, else None."""
    fn = node.func
    name = _last_name(fn)
    if name in _BLOCKING_CALLS:
        return f"{name}()"
    if isinstance(fn, ast.Attribute):
        recv = _last_name(fn.value).lstrip("_")
        # normalized receiver module aliases (time as _time / _time_mod)
        recv_mod = recv[:-len("_mod")] if recv.endswith("_mod") else recv
        for mod, attrs in _BLOCKING_RECV_ATTRS.items():
            if fn.attr in attrs and (recv == mod or recv_mod == mod):
                return f"{mod}.{fn.attr}()"
        if recv in _IO_RECEIVERS:
            return f"{recv}.{fn.attr}() [I/O object]"
        # torch.cuda.synchronize(), stream.synchronize(), event.synchronize()
        if fn.attr == "synchronize":
            return f"{_dotted(fn) or fn.attr}() [waits for the card]"
        if fn.attr in _DIST_CALLS and (
                recv == "dist" or _dotted(fn.value).endswith("distributed")):
            return f"torch.distributed.{fn.attr}() [waits for every rank]"
        if fn.attr == "to" and (
                (node.args and _is_device_arg(node.args[0]))
                or any(k.arg == "device" for k in node.keywords)):
            return ".to(device) [a copy to or from the card]"
    return None


def rule_locked_blocking(project: Project) -> Iterator[Violation]:
    """R9: no blocking work inside a lock's critical section on the
    control plane (runtime/, ops/, parallel/) — no file opens/fsyncs, no
    sockets, no sleeps, no engine construction, no kernel builds, no waits
    for the card or for other ranks, no copies to the card, and no calls on
    the journal/event-log/registry/store/work-dir I/O objects, either
    lexically under ``with <lock>:`` or anywhere in a ``*_locked``-
    convention method (called with the lock already held).  The blessed
    escapes are the staged-flush pattern (stage under the lock, write
    after release) and locks DECLARED ``io_ok=True`` via lockdep.make_lock
    — locks whose purpose is serializing that I/O (registry/journal/start
    flush, the model-cache compile lock, the kernels' table uploads)."""
    for rel in project.files():
        if not rel.startswith(_CONC_SCOPE):
            continue
        tree = project.tree(rel)
        if tree is None:
            continue
        decls = _decls_for(project, rel, tree)
        for cls, fn in _functions_with_class(tree):
            base_held: list[tuple[str, bool]] = []
            if fn.name.endswith("_locked") or "_locked_" in fn.name:
                base_held.append((f"<{fn.name}: _locked convention>", False))

            def check(node: ast.Call, held) -> Iterator[Violation]:
                label = _blocking_call(node)
                if label is None:
                    return
                hot = [n for n, io_ok in held if not io_ok]
                if hot:
                    yield Violation(
                        "locked-blocking", rel, node.lineno,
                        f"blocking {label} inside the critical section of "
                        f"{hot[-1]} — stage the work under the lock and "
                        f"flush after release (or declare the lock "
                        f"io_ok=True if serializing this I/O is its "
                        f"purpose)",
                    )

            def scan(node: ast.AST, held) -> Iterator[Violation]:
                # nested defs/classes are their own scope: defining one
                # under a lock runs nothing (the outer loop visits it)
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    return
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    cur = list(held)
                    for item in node.items:  # left-to-right acquisition
                        for c in ast.walk(item.context_expr):
                            if isinstance(c, ast.Call):
                                yield from check(c, cur)
                        r = decls.resolve(item.context_expr, cls)
                        if r is not None:
                            cur.append(r)
                    for child in node.body:
                        yield from scan(child, cur)
                    return
                if isinstance(node, ast.Call):
                    yield from check(node, held)
                for child in ast.iter_child_nodes(node):
                    yield from scan(child, held)

            for stmt in fn.body:
                yield from scan(stmt, base_held)


# ------------------------------------------------------------------ rule R10

def _module_of_import(node: ast.ImportFrom | ast.Import) -> dict[str, str]:
    """alias -> dotted module/name path for import statements."""
    out = {}
    if isinstance(node, ast.Import):
        for a in node.names:
            out[(a.asname or a.name.split(".")[0])] = a.name
    else:
        mod = node.module or ""
        for a in node.names:
            out[a.asname or a.name] = f"{mod}.{a.name}"
    return out


class _CallGraph:
    """Project-wide lock-acquisition summaries: which locks each function
    acquires (directly or transitively) and which locks are HELD at each
    call site — the inputs to R10's cycle search.

    Receiver typing is deliberately shallow but declaration-driven:
    ``self`` resolves to the enclosing class; attribute/variable receivers
    resolve through dataclass field annotations and ``self.x = Class()``
    assignments anywhere in the project; bare names resolve to same-module
    functions, ``from x import y`` targets, and project classes (their
    __init__).  Unresolvable calls contribute no edges — under-
    approximation here is covered by the dynamic lockdep harness."""

    def __init__(self, project: Project):
        self.project = project
        self.fns: dict[tuple, ast.AST] = {}  # (rel, cls, name) -> node
        self.decls: dict[str, _LockDecls] = {}
        self.classes: dict[str, list[str]] = {}  # class name -> [rel]
        self.attr_types: dict[str, set[str]] = {}  # attr -> class names
        self.imports: dict[str, dict[str, str]] = {}  # rel -> alias map
        self.mod_to_rel: dict[str, str] = {}
        for rel in project.files():
            tree = project.tree(rel)
            if tree is None:
                continue
            self.decls[rel] = _decls_for(project, rel, tree)
            mod = rel[:-3].replace("/", ".")
            self.mod_to_rel[mod] = rel
            self.mod_to_rel[f"distributed_grep_tpu_torch.{mod}"] = rel
            imp: dict[str, str] = {}
            # one walk per file: imports, classes, attr types together
            for node in ast.walk(tree):
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    imp.update(_module_of_import(node))
                elif isinstance(node, ast.ClassDef):
                    self.classes.setdefault(node.name, []).append(rel)
                elif isinstance(node, ast.AnnAssign) \
                        and isinstance(node.target, ast.Name):
                    for n in ast.walk(node.annotation):
                        if isinstance(n, ast.Name) and n.id[:1].isupper():
                            self.attr_types.setdefault(
                                node.target.id, set()).add(n.id)
                elif isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Attribute) \
                                and _last_name(tgt.value) == "self":
                            for c in ast.walk(node.value):
                                if isinstance(c, ast.Call):
                                    nm = _last_name(c.func)
                                    if nm[:1].isupper():
                                        self.attr_types.setdefault(
                                            tgt.attr, set()).add(nm)
            self.imports[rel] = imp
            for cls, fn in _functions_with_class(tree):
                self.fns[(rel, cls, fn.name)] = fn

    # ---------------------------------------------------------- resolution
    def _method_keys(self, class_name: str, meth: str) -> list[tuple]:
        out = []
        for rel in self.classes.get(class_name, ()):
            key = (rel, class_name, meth)
            if key in self.fns:
                out.append(key)
        return out

    def resolve_call(self, call: ast.Call, rel: str,
                     cls: str | None) -> list[tuple]:
        fn = call.func
        if isinstance(fn, ast.Name):
            name = fn.id
            if (rel, cls, name) in self.fns:
                return [(rel, cls, name)]
            if (rel, None, name) in self.fns:
                return [(rel, None, name)]
            if name in self.attr_types:  # local var named like a field
                return [k for c in self.attr_types[name]
                        for k in self._method_keys(c, "__init__")] or []
            if name in self.classes:
                return self._method_keys(name, "__init__")
            target = self.imports.get(rel, {}).get(name)
            if target:
                mod, _, leaf = target.rpartition(".")
                trel = self.mod_to_rel.get(mod)
                if trel and (trel, None, leaf) in self.fns:
                    return [(trel, None, leaf)]
                if trel and leaf in self.classes:
                    return self._method_keys(leaf, "__init__")
            return []
        if isinstance(fn, ast.Attribute):
            recv = _last_name(fn.value)
            meth = fn.attr
            if recv == "self" and cls is not None:
                keys = self._method_keys(cls, meth)
                return [k for k in keys if k[0] == rel] or keys
            out: list[tuple] = []
            for c in self.attr_types.get(recv, ()):
                out.extend(self._method_keys(c, meth))
            if not out and recv in self.classes:  # ClassName.static()
                out.extend(self._method_keys(recv, meth))
            if not out:
                target = self.imports.get(rel, {}).get(recv)
                if target:
                    trel = self.mod_to_rel.get(target)
                    if trel:
                        if (trel, None, meth) in self.fns:
                            out.append((trel, None, meth))
                        elif meth in self.classes:
                            out.extend(self._method_keys(meth, "__init__"))
            return out
        return []


def rule_lock_order(project: Project) -> Iterator[Violation]:
    """R10: the static lock-acquisition graph must be acyclic.  Nodes are
    declared locks (lockdep.make_lock names; raw Locks key by module:var);
    edges run held -> acquired, from nested ``with`` scopes and from calls
    made inside a critical section to functions that (transitively)
    acquire other locks — cross-module edges included, resolved through
    dataclass annotations and ``self.x = Class()`` sites (the service ->
    scheduler ``stop()`` edge, the flush locks' outer-to-inner contract).
    Any cycle is a potential deadlock and is reported once with the
    participating locks.  Same-lock call-path self-edges are skipped (the
    ``locked=True`` conditional-acquire helpers would false-positive);
    a LEXICAL ``with A: with A:`` still reports — that one is a certain
    deadlock on a non-reentrant Lock."""
    graph = _CallGraph(project)
    # direct acquires per function
    direct: dict[tuple, set[str]] = {}
    calls: dict[tuple, list] = {}
    edges: dict[tuple[str, str], tuple[str, int]] = {}  # (a,b) -> site

    for (rel, cls, name), fn in graph.fns.items():
        decls = graph.decls[rel]
        acq: set[str] = set()
        fncalls: list = []

        def walk(node: ast.AST, held: tuple) -> None:
            # nested defs/classes are their own scope: defining one under
            # a lock runs nothing (they get their own summary)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                cur = held
                for item in node.items:  # left-to-right acquisition
                    for c in ast.walk(item.context_expr):
                        if isinstance(c, ast.Call):
                            fncalls.append((cur, c, c.lineno))
                    r = decls.resolve(item.context_expr, cls)
                    if r is not None:
                        g = r[0]
                        acq.add(g)
                        for h in cur:
                            edges.setdefault((h, g), (rel, node.lineno))
                        cur = cur + (g,)
                for child in node.body:
                    walk(child, cur)
                return
            if isinstance(node, ast.Call):
                fncalls.append((held, node, node.lineno))
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        for stmt in fn.body:
            walk(stmt, ())
        direct[(rel, cls, name)] = acq
        calls[(rel, cls, name)] = fncalls

    # transitive acquires: fixpoint over the (shallow) call graph
    trans: dict[tuple, set[str]] = {k: set(v) for k, v in direct.items()}
    resolved: dict[tuple, list[list[tuple]]] = {}
    for key, fncalls in calls.items():
        rel, cls, _ = key
        resolved[key] = [graph.resolve_call(c, rel, cls)
                         for _, c, _ in fncalls]
    changed = True
    while changed:
        changed = False
        for key, callee_lists in resolved.items():
            cur = trans[key]
            before = len(cur)
            for callees in callee_lists:
                for ck in callees:
                    cur |= trans.get(ck, set())
            if len(cur) != before:
                changed = True

    # call edges: held locks -> everything the callee may acquire
    for key, fncalls in calls.items():
        for (held, call, line), callees in zip(fncalls, resolved[key]):
            if not held:
                continue
            for ck in callees:
                for lk in trans.get(ck, ()):
                    for h in held:
                        if h != lk:  # call-path self-edges: see docstring
                            edges.setdefault((h, lk), (key[0], line))

    # cycle detection over the edge graph (iterative DFS per node)
    adj: dict[str, list[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    reported: set[frozenset] = set()
    for (a, b), (rel, line) in sorted(edges.items(),
                                      key=lambda kv: (kv[1][0], kv[1][1])):
        if a == b:
            yield Violation(
                "lock-order", rel, line,
                f"lock {a!r} re-acquired while already held — certain "
                f"deadlock on a non-reentrant Lock",
            )
            continue
        # path b ->* a closes a cycle through edge (a, b); keep the path
        # so one N-lock cycle dedups to ONE report (keying on just the
        # closing edge would report a 3-cycle three times, once per edge)
        stack, seen = [(b, (b,))], {b}
        found: tuple | None = None
        while stack and found is None:
            n, path = stack.pop()
            for m in adj.get(n, ()):
                if m == a:
                    found = path
                    break
                if m not in seen:
                    seen.add(m)
                    stack.append((m, path + (m,)))
        if found is not None:
            cyc = frozenset(found) | {a}
            if cyc in reported:
                continue
            reported.add(cyc)
            chain = " -> ".join(found + (a,))
            yield Violation(
                "lock-order", rel, line,
                f"lock-order cycle: {a!r} -> {b!r} here, but a path "
                f"{chain} exists elsewhere — two threads taking the two "
                f"routes deadlock",
            )


# ------------------------------------------------------------------ rule R12

# Instrument factory callables (utils/metrics.py): module-level
# counter()/gauge()/histogram() and the MetricsRegistry methods share
# these names; a first argument that is a "dgrep_"-prefixed string
# constant marks the call as a series creation.
_METRIC_FACTORIES = {"counter": "counter", "gauge": "gauge",
                     "histogram": "histogram"}
_SERIES_PREFIX = "dgrep_"


def rule_metrics_registry(project: Project) -> Iterator[Violation]:
    """R12: every exported metrics series name is declared once in
    ``utils/metrics.SERIES`` (the env-knobs registry pattern — the table
    doubles as the /metrics HELP text).  A ``counter()``/``gauge()``/
    ``histogram()`` creation whose name is undeclared is unowned and
    undocumented; a creation whose kind disagrees with the declaration
    would render the series under the wrong Prometheus TYPE; a declared
    name no call site creates is a stale registry entry (checked only
    when the project carries utils/metrics.py — fixture mini-trees stay
    silent, like the env-knobs stale check)."""
    from distributed_grep_tpu_torch.utils.metrics import SERIES

    seen: dict[str, list[tuple[str, int, str]]] = {}
    for rel in project.files():
        tree = project.tree(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            kind = _METRIC_FACTORIES.get(_last_name(node.func))
            if kind is None:
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)
                    and arg.value.startswith(_SERIES_PREFIX)):
                continue
            seen.setdefault(arg.value, []).append((rel, node.lineno, kind))
    for name in sorted(seen):
        decl = SERIES.get(name)
        for rel, line, kind in seen[name]:
            if decl is None:
                yield Violation(
                    "metrics-registry", rel, line,
                    f"undeclared metrics series {name}: add it (kind, "
                    f"help) to utils/metrics.py SERIES — the registry is "
                    f"the /metrics HELP text and the one place a series "
                    f"name is owned",
                )
            elif decl[0] != kind:
                yield Violation(
                    "metrics-registry", rel, line,
                    f"{name} created as a {kind} but declared "
                    f"{decl[0]} in utils/metrics.py SERIES — the series "
                    f"would render under the wrong Prometheus TYPE",
                )
    if (project.root / "utils/metrics.py").exists():
        for name in SERIES:
            if name not in seen:
                yield Violation(
                    "metrics-registry", "utils/metrics.py", 1,
                    f"declared metrics series {name} is never created by "
                    f"any counter()/gauge()/histogram() call site: stale "
                    f"registry entry in utils/metrics.py SERIES",
                )


# ------------------------------------------------------------------ rule R13

# Consumer modules that string-match event names (explain views, fleet
# trace export, daemon-log readers, `dgrep top`): every literal compare on
# a variable named `name`/`kind` there must hit a declared event.
_EVENT_CONSUMER_FILES = ("runtime/explain.py", "utils/spans.py",
                         "runtime/daemon_log.py", "__main__.py")
# Emitter callables: span-pipeline entry points plus the daemon-event
# helpers (service._daemon_event, DaemonLog.append_now, the scheduler's
# daemon_events hook, WorkerHealth._emit).
_SPAN_EMITTERS = {"instant": "instant", "span": "span", "complete": "span"}
_DAEMON_EMITTERS = {"_daemon_event", "append_now", "daemon_events", "_emit"}


def _event_name_shapes(expr: ast.expr):
    """Resolve an emit-site name expression to concrete names and family
    patterns (``*`` marks a computed f-string segment).  None = not
    statically resolvable (a bare-Name pass-through helper parameter) —
    silently skipped, the metrics-registry convention; the
    utils/event_audit.py dynamic recorder covers those at runtime."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return [expr.value]
    if isinstance(expr, ast.IfExp):
        body = _event_name_shapes(expr.body)
        orelse = _event_name_shapes(expr.orelse)
        if body is not None and orelse is not None:
            return body + orelse
        return None
    if isinstance(expr, ast.JoinedStr):
        parts = []
        for v in expr.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append("*")
        pat = "".join(parts)
        if pat.count("*") == 1:
            return [pat]
    return None


def _event_emit(node: ast.AST) -> tuple[str, ast.expr, str | None] | None:
    """(kind, name expression, cat or None) of an emit site: a raw
    ``{"t": "instant"|"span", "name": ...}`` dict literal, a span-pipeline
    call (``instant()``/``span()``/``complete()``/``_event()``) or a
    daemon-event helper; None for any other node."""
    if isinstance(node, ast.Dict):
        keys = {k.value: v for k, v in zip(node.keys, node.values)
                if isinstance(k, ast.Constant)}
        t = keys.get("t")
        if not (isinstance(t, ast.Constant)
                and t.value in ("span", "instant")):
            return None
        name_expr = keys.get("name")
        if name_expr is None:
            return None
        cat_expr = keys.get("cat")
        cat = (cat_expr.value
               if isinstance(cat_expr, ast.Constant)
               and isinstance(cat_expr.value, str) else None)
        return t.value, name_expr, cat
    if not (isinstance(node, ast.Call) and node.args):
        return None
    fname = _last_name(node.func)
    kind = cat = None
    if fname in _SPAN_EMITTERS:
        kind = _SPAN_EMITTERS[fname]
        for k in node.keywords:
            if (k.arg == "cat"
                    and isinstance(k.value, ast.Constant)
                    and isinstance(k.value.value, str)):
                cat = k.value.value
    elif fname == "_event":
        kind = "instant"
    elif fname in _DAEMON_EMITTERS:
        kind = "daemon"
    elif fname == "stage" and isinstance(node.func, ast.Attribute):
        recv = _last_name(node.func.value) or ""
        if "daemon" in recv or recv == "dl":
            kind = "daemon"
    if kind is None:
        return None
    return kind, node.args[0], cat


def _event_sink(node: ast.AST) -> tuple[str, object] | None:
    emit = _event_emit(node)
    if emit is None or not isinstance(emit[1], ast.Name):
        return None
    return emit[1].id, (emit[0], emit[2])


def rule_event_registry(project: Project) -> Iterator[Violation]:
    """R13: every exported telemetry event name — span/instant names and
    DaemonLog kinds — is declared once in ``analysis/events.py EVENTS``
    (the knobs/metrics registry pattern; the table is also the operator
    docs via ``analyze --events``).  Emit sites (``instant()``/``span()``/
    ``complete()`` calls, daemon-event helpers, and raw ``{"t": "instant"|
    "span", "name": ...}`` dict literals) must use string constants or
    declared-family f-strings; a consumer-side compare in explain / trace
    export / daemon-log readers matching an undeclared name is a one-sided
    rename that turns the view into a lie; a declared name with no
    surviving emit site is stale (checked only when the project carries
    utils/spans.py — fixture mini-trees stay silent).  A helper whose
    parameter is the emitted name (``runtime/follow._wake_event``) emits,
    at each call site, the name that site passes."""
    from distributed_grep_tpu_torch.analysis.events import (
        EVENTS, is_family, lookup)

    seen_keys: set[str] = set()

    def check_site(rel, line, kind, name_expr, cat):
        shapes = _event_name_shapes(name_expr)
        if shapes is None:
            return
        for shape in shapes:
            if "*" in shape:
                ev = EVENTS.get(shape)
                if ev is None or not is_family(shape):
                    yield Violation(
                        "event-registry", rel, line,
                        f"undeclared event family {shape!r}: a computed "
                        f"emit name must match an enumerated family "
                        f"declared in analysis/events.py EVENTS",
                    )
                    continue
                key = shape
            else:
                hit = lookup(shape)
                if hit is None:
                    yield Violation(
                        "event-registry", rel, line,
                        f"undeclared event name {shape!r}: add it (kind, "
                        f"cat, owner) to analysis/events.py EVENTS — the "
                        f"registry is the telemetry vocabulary and the one "
                        f"place an event name is owned",
                    )
                    continue
                key, ev = hit
            seen_keys.add(key)
            if kind not in ev.kinds:
                yield Violation(
                    "event-registry", rel, line,
                    f"{shape!r} emitted as a {kind} but declared "
                    f"{'/'.join(ev.kinds)} in analysis/events.py EVENTS",
                )
            if cat is not None and ev.cat and cat != ev.cat:
                yield Violation(
                    "event-registry", rel, line,
                    f"{shape!r} emitted with cat {cat!r} but declared cat "
                    f"{ev.cat!r} in analysis/events.py EVENTS — consumers "
                    f"and trace rows bucket by cat",
                )

    helpers = _helpers(project, "event", _event_sink)
    for rel in project.files():
        if rel.startswith("analysis/"):
            continue
        tree = project.tree(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            emit = _event_emit(node)
            if emit is None and isinstance(node, ast.Call):
                helper = helpers.get(_last_name(node.func))
                if helper is not None:
                    arg = _call_arg(node, helper[0], helper[1])
                    if arg is not None:
                        emit = (helper[2][0], arg, helper[2][1])
            if emit is not None:
                yield from check_site(rel, node.lineno, *emit)

    for rel in _EVENT_CONSUMER_FILES:
        tree = project.tree(rel)
        if tree is None:
            continue
        module_dicts: dict[str, tuple[list[str], int]] = {}
        for node in tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Dict)
                    and node.value.keys
                    and all(isinstance(k, ast.Constant)
                            and isinstance(k.value, str)
                            for k in node.value.keys)):
                module_dicts[node.targets[0].id] = (
                    [k.value for k in node.value.keys], node.lineno)
        getted: set[str] = set()
        matched: list[tuple[str, int]] = []
        for node in ast.walk(tree):
            if (isinstance(node, ast.Compare)
                    and isinstance(node.left, ast.Name)
                    and node.left.id in ("name", "kind")
                    and len(node.ops) == 1
                    and isinstance(node.ops[0], (ast.Eq, ast.In))):
                comp = node.comparators[0]
                if (isinstance(comp, ast.Constant)
                        and isinstance(comp.value, str)):
                    matched.append((comp.value, node.lineno))
                elif isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                    matched.extend(
                        (e.value, node.lineno) for e in comp.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str))
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.args
                    and isinstance(node.func.value, ast.Name)):
                if (node.func.attr == "startswith"
                        and node.func.value.id in ("name", "kind")
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)
                        and node.args[0].value.endswith(":")):
                    pat = node.args[0].value + "*"
                    if not (pat in EVENTS and is_family(pat)):
                        yield Violation(
                            "event-registry", rel, node.lineno,
                            f"consumer matches undeclared event family "
                            f"{pat!r}: no declared family produces these "
                            f"names (analysis/events.py EVENTS)",
                        )
                elif (node.func.attr == "get"
                        and isinstance(node.args[0], ast.Name)
                        and node.args[0].id in ("name", "kind")):
                    getted.add(node.func.value.id)
        for dname in sorted(getted & set(module_dicts)):
            keys, line = module_dicts[dname]
            matched.extend((k, line) for k in keys)
        for value, line in matched:
            if value and lookup(value) is None:
                yield Violation(
                    "event-registry", rel, line,
                    f"consumer matches undeclared event name {value!r}: "
                    f"no emitter produces it (analysis/events.py EVENTS) — "
                    f"a one-sided rename turns this view into a lie",
                )

    if (project.root / "utils/spans.py").exists():
        for key in EVENTS:
            if key not in seen_keys:
                yield Violation(
                    "event-registry", "analysis/events.py", 1,
                    f"declared event {key!r} has no surviving emit site: "
                    f"stale registry entry in analysis/events.py EVENTS",
                )


# ------------------------------------------------------- rule P1 own-copy

_FOREIGN_ROOTS = ("jax", "jaxlib", "distributed_grep_tpu")
_IMPORTERS = {"import_module", "__import__"}


def _foreign(module: str) -> bool:
    """True for jax, jaxlib, the reference package, or a module of one."""
    return any(module == r or module.startswith(r + ".")
               for r in _FOREIGN_ROOTS)


def rule_own_copy(project: Project) -> Iterator[Violation]:
    """P1: no module of the package imports jax, jaxlib or anything of the
    reference package distributed_grep_tpu — function-local imports and
    ``importlib.import_module``/``__import__`` of a constant name
    included.  The port keeps its own copy of what it needs (even of the
    reference's jax-free modules), so it runs where no jax is installed
    and the reference stays free to change."""
    for rel in project.files():
        tree = project.tree(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            names: list[str] = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and node.args
                  and _last_name(node.func) in _IMPORTERS
                  and isinstance(node.args[0], ast.Constant)
                  and isinstance(node.args[0].value, str)):
                names = [node.args[0].value]
            for name in names:
                if _foreign(name):
                    yield Violation(
                        "own-copy", rel, node.lineno,
                        f"import of {name!r}: the port imports no jax and "
                        f"nothing of the reference package — keep an own "
                        f"copy of what is needed",
                    )


# ---------------------------------------------------- rule P2 no-fallback

_PLAIN_SUFFIXES = ("_plain", "_numpy")
_DEVICE_PROBES = {"is_available", "device_count"}


def _handler_bodies(node: ast.AST) -> Iterator[tuple[str, list[ast.stmt]]]:
    if isinstance(node, (ast.Try, getattr(ast, "TryStar", ast.Try))):
        for h in node.handlers:
            yield "an except handler", h.body
        if node.finalbody:
            yield "a finally block", node.finalbody


def _probes_device(expr: ast.AST) -> bool:
    return any(isinstance(n, ast.Call)
               and _last_name(n.func) in _DEVICE_PROBES
               and "cuda" in _dotted(n.func)
               for n in ast.walk(expr))


def _picks_cpu(nodes: Iterable[ast.AST]) -> bool:
    return any(isinstance(n, ast.Constant) and n.value == "cpu"
               for top in nodes for n in ast.walk(top))


def rule_no_fallback(project: Project) -> Iterator[Violation]:
    """P2: no fallback hides the card or a kernel — no call of a plain
    version (``*_plain``/``*_numpy``) inside an ``except`` handler or a
    ``finally`` block, and no ``torch.cuda.is_available()``/
    ``device_count()`` test whose outcome picks ``"cpu"``.  A kernel that
    fails must fail the scan; a plain leg runs only where the caller's
    tensor lies on the CPU (the explicit device dispatch), or where the
    host library declines data and says so by returning None."""
    for rel in project.files():
        tree = project.tree(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            for where, body in _handler_bodies(node):
                for stmt in body:
                    for n in ast.walk(stmt):
                        if (isinstance(n, ast.Call) and _last_name(
                                n.func).endswith(_PLAIN_SUFFIXES)):
                            yield Violation(
                                "no-fallback", rel, n.lineno,
                                f"plain version {_last_name(n.func)}() "
                                f"called in {where}: a failed kernel or "
                                f"card would be hidden behind the plain "
                                f"leg — let the error fail the scan",
                            )
            picks = None
            if isinstance(node, ast.IfExp) and _probes_device(node.test):
                picks = _picks_cpu([node.body, node.orelse])
            elif isinstance(node, ast.If) and _probes_device(node.test):
                picks = _picks_cpu(node.body + node.orelse)
            elif isinstance(node, ast.BoolOp) and _probes_device(node):
                picks = _picks_cpu(node.values)
            if picks:
                yield Violation(
                    "no-fallback", rel, node.lineno,
                    "a test of torch.cuda.is_available()/device_count() "
                    "picks \"cpu\": an entry point runs on the card unless "
                    "the caller asks for the CPU — without a card it "
                    "raises",
                )


# ------------------------------------------------------- rule P3 cuda-abi

# The card's opt-in shared memory a block (an H100: 227 KB).
_SMEM_LIMIT_BYTES = 232448
_CTYPES_POINTERS = {"c_void_p", "c_char_p", "c_wchar_p"}
# ctypes type -> (bits, signed); c_long is 64 bits on the LP64 hosts the
# package builds for.
_CTYPES_INTS = {
    "c_bool": (8, False), "c_char": (8, True), "c_byte": (8, True),
    "c_int8": (8, True), "c_ubyte": (8, False), "c_uint8": (8, False),
    "c_short": (16, True), "c_int16": (16, True),
    "c_ushort": (16, False), "c_uint16": (16, False),
    "c_int": (32, True), "c_int32": (32, True),
    "c_uint": (32, False), "c_uint32": (32, False),
    "c_long": (64, True), "c_longlong": (64, True), "c_int64": (64, True),
    "c_ssize_t": (64, True),
    "c_ulong": (64, False), "c_ulonglong": (64, False),
    "c_uint64": (64, False), "c_size_t": (64, False),
    "c_float": ("float", True), "c_double": ("double", True),
}
# C scalar type (qualifiers and spaces normalized) -> (bits, signed)
_C_INTS = {
    "bool": (8, False), "char": (8, True), "signed char": (8, True),
    "int8_t": (8, True), "unsigned char": (8, False), "uint8_t": (8, False),
    "short": (16, True), "int16_t": (16, True),
    "unsigned short": (16, False), "uint16_t": (16, False),
    "int": (32, True), "signed": (32, True), "int32_t": (32, True),
    "unsigned": (32, False), "unsigned int": (32, False),
    "uint32_t": (32, False),
    "long": (64, True), "long long": (64, True), "long long int": (64, True),
    "int64_t": (64, True), "ssize_t": (64, True), "ptrdiff_t": (64, True),
    "unsigned long": (64, False), "unsigned long long": (64, False),
    "uint64_t": (64, False), "size_t": (64, False),
    "float": ("float", True), "double": ("double", True),
}
_EXTERN_C = re.compile(r'extern\s+"C"\s*')
_C_FUNC = re.compile(
    r"([A-Za-z_][\w\s\*&]*?)\b([A-Za-z_]\w*)\s*\(([^()]*)\)\s*(?:\{|;)")


def _strip_c_comments(src: str) -> str:
    """``src`` with its comments blanked (newlines kept, so an offset
    still gives its line); string and character literals are skipped
    whole, so a ``//`` inside one is not a comment."""
    out = list(src)
    i, n = 0, len(src)
    while i < n:
        two = src[i:i + 2]
        if src[i] in "\"'":
            q, i = src[i], i + 1
            while i < n and src[i] != q:
                i += 2 if src[i] == "\\" else 1
            i += 1
            continue
        if two == "//":
            j = src.find("\n", i)
        elif two == "/*":
            j = src.find("*/", i + 2)
            j = j + 2 if j >= 0 else j
        else:
            i += 1
            continue
        j = n if j < 0 else j
        for k in range(i, j):
            if out[k] != "\n":
                out[k] = " "
        i = j
    return "".join(out)


_C_QUALIFIERS = re.compile(
    r"\b(const|volatile|__restrict__|restrict|struct|inline|static|"
    r"__host__|__device__|__global__)\b")


def _c_type(text: str, named: bool = False):
    """'ptr', 'void', (bits, signed), or the normalized text when the
    type is not known.  ``named``: the text ends in a parameter's name."""
    if "*" in text or "&" in text or "[" in text:
        return "ptr"
    words = _C_QUALIFIERS.sub(" ", text).split()
    if named and len(words) > 1 and " ".join(words) not in _C_INTS:
        words = words[:-1]
    norm = " ".join(words)
    if norm in ("", "void"):
        return "void"
    return _C_INTS.get(norm, norm)


def extern_c_functions(src: str) -> dict[str, tuple[int, object, list]]:
    """name -> (line, return type, [parameter types]) of every function
    a C/C++ source exports with C linkage: ``extern "C" T f(...)`` and
    the non-static functions of ``extern "C" { ... }`` blocks."""
    text = _strip_c_comments(src)
    out: dict[str, tuple[int, object, list]] = {}

    def add(m: re.Match) -> None:
        ret, name, params = m.group(1), m.group(2), m.group(3)
        if re.search(r"\bstatic\b", ret):
            return
        plist = [] if params.strip() in ("", "void") else [
            _c_type(q.split("=", 1)[0], named=True)
            for q in params.split(",")]
        out[name] = (text.count("\n", 0, m.start(2)) + 1, _c_type(ret),
                     plist)

    for em in _EXTERN_C.finditer(text):
        start = em.end()
        if not text.startswith("{", start):
            m = _C_FUNC.match(text, start)
            if m is not None:
                add(m)
            continue
        # the block's own level: function bodies and other nested braces
        # blanked (offsets kept), so only its declarations remain
        flat, depth, i = list(text), 1, start + 1
        while i < len(text) and depth:
            c = text[i]
            if c == "{":
                depth += 1
            elif c == "}":
                depth -= 1
            elif depth > 1 and c != "\n":
                flat[i] = " "
            i += 1
        for m in _C_FUNC.finditer("".join(flat), start + 1, i):
            add(m)
    return out


def _assign_pairs(node: ast.Assign
                  ) -> Iterator[tuple[ast.expr, ast.expr | None]]:
    """(target, value) of an assignment, tuple unpacking paired element by
    element (value None where the right side is not a tuple literal)."""
    for tgt in node.targets:
        if isinstance(tgt, ast.Tuple):
            vals = (node.value.elts if isinstance(node.value, ast.Tuple)
                    and len(node.value.elts) == len(tgt.elts)
                    else [None] * len(tgt.elts))
            yield from zip(tgt.elts, vals)
        else:
            yield tgt, node.value


def _assigns(nodes: list[ast.AST]) -> list[ast.Assign]:
    """The assignments among one scope's nodes, in source order."""
    return sorted((n for n in nodes if isinstance(n, ast.Assign)),
                  key=lambda n: (n.lineno, n.col_offset))


def _bindings(nodes: list[ast.AST]) -> dict[str, list[ast.expr]]:
    """name -> values assigned among one scope's nodes, in source order."""
    out: dict[str, list[ast.expr]] = {}
    for node in _assigns(nodes):
        for t, v in _assign_pairs(node):
            if isinstance(t, ast.Name) and v is not None:
                out.setdefault(t.id, []).append(v)
    return out


class _AbiModule:
    """One Python module's view for cuda-abi: its module-level bindings
    and a resolver of ctypes type expressions through local aliases
    (``_P, _I = ctypes.c_void_p, ctypes.c_int``), module constants
    (``K1_ARGTYPES``) and other modules' constants (``dfa_scan.K1_...``)."""

    def __init__(self, project: Project, rel: str, tree: ast.Module):
        self.project, self.rel, self.tree = project, rel, tree
        self.module = _bindings(_enclosing_scopes(tree)[0][1])

    def lookup(self, name: str, local: dict) -> ast.expr | None:
        vals = local.get(name) or self.module.get(name)
        return vals[-1] if vals else None

    def const_list(self, expr: ast.expr, local: dict,
                   depth: int = 0) -> list[ast.expr] | None:
        if depth > 4:
            return None
        if isinstance(expr, (ast.List, ast.Tuple)):
            return list(expr.elts)
        if isinstance(expr, ast.Name):
            v = self.lookup(expr.id, local)
            return None if v is None else self.const_list(v, local,
                                                          depth + 1)
        if isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                          ast.Name):
            other = _module_named(self.project, expr.value.id)
            if other is not None:
                return other.const_list(ast.Name(expr.attr), {}, depth + 1)
        return None

    def ctype(self, expr: ast.expr, local: dict, depth: int = 0):
        """'ptr', 'void', (bits, signed), or None when unresolvable."""
        if depth > 6:
            return None
        if isinstance(expr, ast.Constant) and expr.value is None:
            return "void"
        if isinstance(expr, ast.Call) and _last_name(expr.func) == "POINTER":
            return "ptr"
        if isinstance(expr, ast.Attribute):
            if expr.attr in _CTYPES_POINTERS:
                return "ptr"
            if expr.attr in _CTYPES_INTS:
                return _CTYPES_INTS[expr.attr]
            return None
        if isinstance(expr, ast.Name):
            if expr.id in _CTYPES_POINTERS:
                return "ptr"
            if expr.id in _CTYPES_INTS and self.lookup(expr.id,
                                                       local) is None:
                return _CTYPES_INTS[expr.id]
            v = self.lookup(expr.id, local)
            return None if v is None else self.ctype(v, local, depth + 1)
        return None

    def str_const(self, expr: ast.expr, local: dict,
                  depth: int = 0) -> str | None:
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value
        if isinstance(expr, ast.Name) and depth < 4:
            v = self.lookup(expr.id, local)
            return None if v is None else self.str_const(v, local,
                                                         depth + 1)
        return None


def _module_named(project: Project, stem: str) -> _AbiModule | None:
    hits = [f for f in project.files() if Path(f).stem == stem]
    if len(hits) != 1:
        return None
    tree = project.tree(hits[0])
    return None if tree is None else _AbiModule(project, hits[0], tree)


def _ctype_label(t) -> str:
    if t in ("ptr", "void"):
        return {"ptr": "a pointer", "void": "void"}[t]
    if isinstance(t, tuple):
        bits, signed = t
        if isinstance(bits, str):
            return bits
        return f"{'' if signed else 'un'}signed {bits}-bit"
    return str(t)


def _abi_compatible(c_type, py_type) -> bool:
    """False only where both sides are known and differ (a typedef the
    table does not know, or an unresolvable ctypes name, holds nothing)."""
    def known(t) -> bool:
        return t in ("ptr", "void") or isinstance(t, tuple)

    return not (known(c_type) and known(py_type)) or c_type == py_type


def _check_signature(rel: str, line: int, name: str, lib: str, c_sig,
                     args: list | None, restype, has_restype: bool
                     ) -> Iterator[Violation]:
    c_line, c_ret, c_params = c_sig
    where = f"{lib}:{c_line}"
    if args is not None:
        if len(args) != len(c_params):
            yield Violation(
                "cuda-abi", rel, line,
                f"{name} is bound with {len(args)} argtypes but {where} "
                f"declares {len(c_params)} parameters: the call would "
                f"pass the wrong arguments",
            )
        else:
            for i, (c_t, py_t) in enumerate(zip(c_params, args), 1):
                if not _abi_compatible(c_t, py_t):
                    yield Violation(
                        "cuda-abi", rel, line,
                        f"{name} argument {i} is bound as "
                        f"{_ctype_label(py_t)} but {where} declares "
                        f"{_ctype_label(c_t)}",
                    )
    want = c_ret
    got = restype if has_restype else (32, True)  # ctypes' default c_int
    if want == "void" and not has_restype:
        return
    if not _abi_compatible(want, got):
        yield Violation(
            "cuda-abi", rel, line,
            f"{name} restype is {_ctype_label(got)}"
            f"{'' if has_restype else ' (ctypes default c_int)'} but "
            f"{where} returns {_ctype_label(want)}",
        )


def _extern_tables(project: Project) -> tuple[dict, dict]:
    """The ``extern "C"`` functions of each csrc/*.cu and csrc/*.cpp, by
    the source's stem."""
    tables: tuple[dict, dict] = ({}, {})
    for table, pattern in zip(tables, ("*.cu", "*.cpp")):
        for path in sorted((project.root / "csrc").glob(pattern)):
            table[path.stem] = extern_c_functions(path.read_text(
                encoding="utf-8", errors="replace"))
    return tables


def _lib_of(mod: _AbiModule, expr: ast.expr, local: dict,
            depth: int = 0) -> tuple[str, str | None]:
    """('cu'|'cpp', source stem or None) of the library a bound name is
    read from: ``_build.load(NAME)`` / ``load_host(NAME)``, through the
    scope's names; ('cu', None) when the library is not known (a
    parameter, a variant build)."""
    if depth > 4:
        return "cu", None
    if isinstance(expr, ast.Name):
        v = mod.lookup(expr.id, local)
        return ("cu", None) if v is None else _lib_of(mod, v, local,
                                                      depth + 1)
    if isinstance(expr, ast.Call):
        fname = _last_name(expr.func)
        if fname in ("load", "load_host"):
            kind = "cpp" if fname == "load_host" else "cu"
            stem = (mod.str_const(expr.args[0], local) if expr.args
                    else ("dgrep" if kind == "cpp" else None))
            return kind, stem
    return "cu", None


def rule_cuda_abi(project: Project) -> Iterator[Violation]:
    """P3: the C interface holds on both sides — every ctypes binding of
    a ``csrc/`` entry point (``fn.argtypes = [...]`` beside ``lib.<name>``,
    and utils/native.py's ``_SIGNATURES``) matches the ``extern "C"``
    signature in arity, pointer-ness, integer width and signedness and
    return type, and binds a function that exists; ops/_build.py's
    SOURCES and HOST_SOURCES are exactly csrc/'s .cu and .cpp files; and
    a shared-memory constant (``*SMEM*``) is within the card's 227 KB
    opt-in a block and equal to the source's ``kSmemBytes``.  Checked
    only where the project has a csrc/ directory."""
    csrc = project.root / "csrc"
    if not csrc.is_dir():
        return
    cu, cpp = _extern_tables(project)
    cu_all: dict[str, tuple[str, tuple]] = {}
    for stem, funcs in cu.items():
        for name, sig in funcs.items():
            cu_all.setdefault(name, (f"csrc/{stem}.cu", sig))

    def find(kind: str, stem: str | None, name: str):
        if kind == "cpp":
            for s, funcs in cpp.items():
                if (stem is None or s == stem) and name in funcs:
                    return f"csrc/{s}.cpp", funcs[name]
            return None
        if stem is not None and stem in cu:
            return ((f"csrc/{stem}.cu", cu[stem][name])
                    if name in cu[stem] else None)
        return cu_all.get(name)

    for rel in project.files():
        tree = project.tree(rel)
        if tree is None:
            continue
        if not any((isinstance(n, ast.Attribute)
                    and n.attr.startswith("dgrep_"))
                   or (isinstance(n, ast.Name) and n.id == "_SIGNATURES")
                   for n in ast.walk(tree)):
            continue  # binds no C function
        mod = _AbiModule(project, rel, tree)
        for scope, nodes in _enclosing_scopes(tree):
            local = {} if scope is tree else _bindings(nodes)
            # bound C functions: V = <lib>.dgrep_x
            bound: dict[str, tuple[str, ast.expr, int]] = {}
            sets: list[tuple[str, str, ast.expr, int]] = []
            for node in _assigns(nodes):
                for t, v in _assign_pairs(node):
                    if (isinstance(t, ast.Name)
                            and isinstance(v, ast.Attribute)
                            and v.attr.startswith("dgrep_")):
                        bound[t.id] = (v.attr, v.value, node.lineno)
                    elif (isinstance(t, ast.Attribute)
                          and t.attr in ("argtypes", "restype")
                          and v is not None):
                        recv = t.value
                        if isinstance(recv, ast.Attribute) \
                                and recv.attr.startswith("dgrep_"):
                            bound[ast.unparse(recv)] = (
                                recv.attr, recv.value, node.lineno)
                        sets.append((ast.unparse(recv), t.attr, v,
                                     node.lineno))
            for var, (cname, lib_expr, line) in bound.items():
                kind, stem = _lib_of(mod, lib_expr, local)
                hit = find(kind, stem, cname)
                mine = [s for s in sets if s[0] == var]
                if hit is None:
                    lib = (f"csrc/{stem}.{kind}" if stem
                           else "csrc/*.cu")
                    yield Violation(
                        "cuda-abi", rel, line,
                        f"{cname} is bound but {lib} exports no such "
                        f"extern \"C\" function",
                    )
                    continue
                if not mine:
                    continue
                src_path, sig = hit
                argtypes = [s for s in mine if s[1] == "argtypes"]
                restypes = [s for s in mine if s[1] == "restype"]
                for _, _, value, aline in argtypes or [(None, None, None,
                                                        line)]:
                    elts = (None if value is None
                            else mod.const_list(value, local))
                    args = (None if elts is None
                            else [mod.ctype(e, local) for e in elts])
                    res = (mod.ctype(restypes[-1][2], local)
                           if restypes else None)
                    yield from _check_signature(
                        rel, aline, cname, src_path, sig, args, res,
                        bool(restypes))
        # utils/native.py's _SIGNATURES: name -> (restype, [argtypes])
        sig_table = mod.module.get("_SIGNATURES")
        if sig_table and isinstance(sig_table[-1], ast.Dict):
            for k, v in zip(sig_table[-1].keys, sig_table[-1].values):
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)):
                    continue
                hit = find("cpp", None, k.value)
                if hit is None:
                    yield Violation(
                        "cuda-abi", rel, k.lineno,
                        f"{k.value} is bound in _SIGNATURES but no "
                        f"csrc/*.cpp exports such an extern \"C\" function",
                    )
                    continue
                if not (isinstance(v, ast.Tuple) and len(v.elts) == 2):
                    continue
                elts = mod.const_list(v.elts[1], {})
                args = (None if elts is None
                        else [mod.ctype(e, {}) for e in elts])
                yield from _check_signature(
                    rel, k.lineno, k.value, hit[0], hit[1], args,
                    mod.ctype(v.elts[0], {}), True)

    yield from _check_sources(project, cu, cpp)
    yield from _check_smem(project)


def _check_sources(project: Project, cu: dict, cpp: dict
                   ) -> Iterator[Violation]:
    rel = "ops/_build.py"
    tree = project.tree(rel)
    if tree is None:
        return
    for const, have, ext in (("SOURCES", cu, "cu"),
                             ("HOST_SOURCES", cpp, "cpp")):
        names, line = _str_seq_assign(tree, const)
        if names is None:
            yield Violation("cuda-abi", rel, 1,
                            f"no {const} tuple literal in ops/_build.py")
            continue
        for stem in sorted(set(have) - set(names)):
            yield Violation(
                "cuda-abi", rel, line,
                f"csrc/{stem}.{ext} is not in {const}: build_all would "
                f"never build it",
            )
        for stem in sorted(set(names) - set(have)):
            yield Violation(
                "cuda-abi", rel, line,
                f"{const} names {stem!r} but csrc/{stem}.{ext} does not "
                f"exist",
            )


def _int_value(expr: ast.expr, env: dict[str, list[ast.expr]],
               depth: int = 0) -> int | None:
    """The integer a module-level constant expression folds to."""
    if depth > 8:
        return None
    if isinstance(expr, ast.Constant) and isinstance(expr.value, int) \
            and not isinstance(expr.value, bool):
        return expr.value
    if isinstance(expr, ast.Name):
        vals = env.get(expr.id)
        return _int_value(vals[-1], env, depth + 1) if vals else None
    if isinstance(expr, ast.BinOp):
        a = _int_value(expr.left, env, depth + 1)
        b = _int_value(expr.right, env, depth + 1)
        if a is None or b is None:
            return None
        ops = {ast.Add: lambda: a + b, ast.Sub: lambda: a - b,
               ast.Mult: lambda: a * b, ast.LShift: lambda: a << b,
               ast.FloorDiv: lambda: a // b if b else None}
        f = ops.get(type(expr.op))
        return f() if f else None
    return None


_C_SMEM = re.compile(r"constexpr\s+(?:int|long long|size_t|unsigned)\s+"
                     r"(kSmem\w*)\s*=\s*(\d+)\s*;")


def _check_smem(project: Project) -> Iterator[Violation]:
    c_smem: dict[str, int] = {}
    for path in sorted((project.root / "csrc").glob("*.cu")):
        text = _strip_c_comments(path.read_text(encoding="utf-8",
                                                errors="replace"))
        for m in _C_SMEM.finditer(text):
            value, line = int(m.group(2)), text.count("\n", 0,
                                                      m.start()) + 1
            if m.group(1) == "kSmemBytes":
                c_smem[path.stem] = value
            if value > _SMEM_LIMIT_BYTES:
                yield Violation(
                    "cuda-abi", f"csrc/{path.name}", line,
                    f"{m.group(1)} = {value} exceeds the card's "
                    f"{_SMEM_LIMIT_BYTES}-byte opt-in shared memory a block",
                )
    for rel in project.files():
        tree = project.tree(rel)
        if tree is None:
            continue
        env = _scope_assignments(tree)
        library = None
        for v in env.get("LIBRARY", ()):
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                library = v.value
        for stmt in tree.body:
            if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and "SMEM" in stmt.targets[0].id):
                continue
            name = stmt.targets[0].id
            value = _int_value(stmt.value, env)
            if value is None:
                continue
            if value > _SMEM_LIMIT_BYTES:
                yield Violation(
                    "cuda-abi", rel, stmt.lineno,
                    f"{name} = {value} exceeds the card's "
                    f"{_SMEM_LIMIT_BYTES}-byte opt-in shared memory a block: "
                    f"a launch sized by it would fail",
                )
            if (name == "SMEM_BYTES" and library in c_smem
                    and c_smem[library] != value):
                yield Violation(
                    "cuda-abi", rel, stmt.lineno,
                    f"SMEM_BYTES = {value} but csrc/{library}.cu's "
                    f"kSmemBytes is {c_smem[library]}: the launch plan and "
                    f"the kernel disagree on the block's shared memory",
                )


# ------------------------------------------------------------------ registry

RULES: dict[str, Callable[[Project], Iterator[Violation]]] = {
    "posix-expand": rule_posix_expand,
    "store-resolve": rule_store_resolve,
    "surrogateescape": rule_surrogateescape,
    "env-knobs": rule_env_knobs,
    "rpc-elide": rule_rpc_elide,
    "logging": rule_logging,
    "net-retry": rule_net_retry,
    "locked-blocking": rule_locked_blocking,
    "lock-order": rule_lock_order,
    "metrics-registry": rule_metrics_registry,
    "event-registry": rule_event_registry,
    "own-copy": rule_own_copy,
    "no-fallback": rule_no_fallback,
    "cuda-abi": rule_cuda_abi,
}

RULE_DOCS: dict[str, str] = {
    name: (fn.__doc__ or "").strip().splitlines()[0].rstrip(".")
    for name, fn in RULES.items()
}
