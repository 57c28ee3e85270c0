"""Regex subset -> AST -> Thompson NFA -> newline-reset DFA table.

The port's own copy of the reference package's regex front end (the
parser, POSIX class expansion, the Thompson construction and the subset
construction of ``compile_dfa``).  The Shift-And compiler
(models/shift_and.py) and the Glushkov compiler (models/nfa.py) walk the
AST and the Thompson NFA built here; the DFA table is the host oracle of
the regex path (ops/host_match.py).

Supported syntax: literals (UTF-8 as raw byte sequences), '.', escapes
(\\n \\t \\xHH \\d \\w \\s and their negations, escaped metachars),
character classes [a-z] / [^...] / [[:alpha:]], alternation '|', groups,
repeats '* + ? {m,n}', anchors '^' '$' '\\b', and case folding.

Semantics baked into the DFA table:

* **Unanchored search**: the DFA recognizes Sigma*.pattern -- an accepting
  state means "a match ends at this byte".
* **Newline reset**: every state's transition on '\\n' goes to the
  line-start state.  Patterns that would consume '\\n' raise
  NewlineInPattern, so the reset is semantics-preserving.
* **Non-consuming anchors**: '^' branches are reachable only at a line
  start; '$' is a second accept set ``accept_eol`` -- a match iff the line
  ends right after this byte.  Mid-pattern anchors are position-gated
  epsilons (ls_eps / eol_eps).
* **Byte classes**: bytes with the same membership in every transition
  mask share a column, so the table is [n_states, n_classes].
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class RegexError(ValueError):
    """Malformed pattern."""


class TooManyStates(RegexError):
    """DFA exceeded the state cap (or a repeat the expansion cap)."""


class NewlineInPattern(RegexError):
    """Pattern would consume '\\n'; the newline-reset table cannot express it."""


class UnsupportedSyntax(RegexError):
    """Valid grep -E syntax that no finite automaton expresses
    (backreferences, assertions beyond ^/$/\\b)."""


NL = 0x0A
_ALL = (1 << 256) - 1
_ANY_NO_NL = _ALL & ~(1 << NL)  # '.' — any byte except newline


def _mask_of(byte: int) -> int:
    return 1 << byte


def _class_mask(chars: str) -> int:
    m = 0
    for c in chars:
        m |= 1 << ord(c)
    return m


_DIGIT = _class_mask("0123456789")
_WORD = _DIGIT | _class_mask("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_")
# \s normally includes '\n', but the scan is strictly per-line (lines never
# contain '\n'), so excluding it here is semantics-preserving — and keeps \s
# usable under the newline-reset table.
_SPACE = _class_mask(" \t\r\x0b\x0c")


def _range_mask(lo: int, hi: int) -> int:
    m = 0
    for b in range(lo, hi + 1):
        m |= 1 << b
    return m


_UPPER = _range_mask(ord("A"), ord("Z"))
_LOWER = _range_mask(ord("a"), ord("z"))
_ALPHA = _UPPER | _LOWER
# POSIX bracket classes ([[:digit:]] etc.) in the C locale — GNU grep -E
# supports these and Python re does NOT, so they must compile into the
# automaton subset.  ASCII
# byte definitions; space/cntrl exclude '\n' (never matchable within a
# line — the same semantics-preserving exclusion as '.'/\s above).
_POSIX_CLASSES = {
    "alpha": _ALPHA,
    "digit": _DIGIT,
    "alnum": _ALPHA | _DIGIT,
    "upper": _UPPER,
    "lower": _LOWER,
    "space": _SPACE,
    "blank": _class_mask(" \t"),
    "punct": (_range_mask(33, 47) | _range_mask(58, 64)
              | _range_mask(91, 96) | _range_mask(123, 126)),
    "print": _range_mask(32, 126),
    "graph": _range_mask(33, 126),
    "cntrl": (_range_mask(0, 31) | _mask_of(127)) & ~_mask_of(NL),
    "xdigit": _DIGIT | _range_mask(ord("A"), ord("F"))
              | _range_mask(ord("a"), ord("f")),
}


def _scan_collating(src: bytes, i: int) -> tuple[int, int]:
    """``src[i:i+2]`` is ``[.`` or ``[=`` inside a bracket expression:
    a POSIX collating symbol / equivalence class.  In the C locale only
    the trivial single-character forms exist — ``[.c.]`` / ``[=c=]``
    denote the character itself; anything longer (or empty) is GNU's
    "Invalid collation character", exit 2 (GNU-verified).  Returns
    (byte, index past the closing ``.]``/``=]``)."""
    d = src[i + 1]  # ord('.') or ord('=')
    end = src.find(bytes([d, ord("]")]), i + 2)
    if end < 0:
        raise RegexError(f"unterminated '[{chr(d)}' at {i}")
    if end != i + 3:  # exactly one character between the delimiters
        raise RegexError("invalid collation character")
    return src[i + 2], end + 2


def _scan_posix_class(src: bytes, i: int) -> tuple[str, int]:
    """``src[i:i+2] == b'[:'`` inside a bracket expression: scan the
    class name.  Returns (name, index just past ':]').  Raises on an
    unterminated '[:' or an unknown name — GNU rejects both with exit 2
    ("Unmatched [ ..." / "Unknown character class name")."""
    end = src.find(b":]", i + 2)
    if end < 0:
        raise RegexError(f"unterminated '[:' at {i}")
    name = src[i + 2:end].decode("ascii", "replace")
    if name not in _POSIX_CLASSES:
        raise RegexError(f"unknown POSIX class [:{name}:]")
    return name, end + 2


def _reject_single_bracket_class(src: bytes, open_pos: int) -> None:
    """GNU errors on the `[:name:]` single-bracket form ("character
    class syntax is [[:space:]], not [:space:]"): a bracket expression
    whose content starts with ':' AND whose closing ']' is preceded by
    ':'.  `[:a]` (no ':]' close) stays a literal member class, like GNU,
    and the negated form `[^:name:]` rejects exactly like the plain one
    (GNU-verified).  ``open_pos`` indexes the '['."""
    j = open_pos + 1
    if j < len(src) and src[j] == ord("^"):
        j += 1
    if j >= len(src) or src[j] != ord(":"):
        return
    close = src.find(b"]", j + 1)
    if close > j + 1 and src[close - 1] == ord(":"):
        raise RegexError(
            "character class syntax is [[:name:]], not [:name:]"
        )


def _mask_to_class_text(mask: int) -> bytes:
    """Class-body text (\\xHH / \\xHH-\\xHH runs) denoting `mask` — valid
    inside a bracket expression for BOTH this module's parser and
    Python re."""
    parts = []
    b = 0
    while b < 256:
        if mask >> b & 1:
            lo = b
            while b < 256 and mask >> b & 1:
                b += 1
            hi = b - 1
            parts.append(b"\\x%02x" % lo if lo == hi
                         else b"\\x%02x-\\x%02x" % (lo, hi))
        else:
            b += 1
    return b"".join(parts)


_POSIX_EXPANSIONS = {k: _mask_to_class_text(v) for k, v in _POSIX_CLASSES.items()}


def expand_posix_classes(pattern):
    """Rewrite POSIX bracket classes ([[:digit:]] etc.) into \\xHH-range
    form understood by BOTH this module's parser and Python re.

    This is the single translation point for every code path that hands
    the user's pattern to re for SEMANTICS — the -w/-x confirm regexes,
    the CLI's -o matcher, apps/grep.py's reference-mirror matcher, the
    engine's re fallback: Python re has no POSIX classes and silently
    misparses ``[[:digit:]]`` as the character set {[ : d i g t}, so any
    unexpanded handoff would diverge from GNU.  Outside bracket
    expressions ``[:name:]`` has no special meaning and is left alone;
    a well-formed ``[:name:]`` with an unknown name raises RegexError
    (GNU errors on those too).  Accepts str or bytes and returns the
    same type."""
    is_str = isinstance(pattern, str)
    src = pattern.encode("utf-8", "surrogateescape") if is_str else bytes(pattern)
    out = bytearray()
    i, n = 0, len(src)
    in_class = False
    # previous in-class token kind — "none" (just opened / after ^ or a
    # leading ]), "member" (char, escaped pair, class, collating symbol),
    # "dash" (a '-' that follows a member, i.e. a potential range
    # operator).  Tracked so the range-adjacency guards can't be fooled
    # by escaped bytes the way raw last-byte peeking was (round-5
    # review: '[a\\-[:digit:]]' vs '[\\^-[:digit:]]').
    prev = "none"
    while i < n:
        c = src[i]
        if c == 0x5C and i + 1 < n:  # backslash escape, either context
            out += src[i:i + 2]
            i += 2
            if in_class:
                prev = "member"
            continue
        if not in_class:
            if c == ord("["):
                _reject_single_bracket_class(src, i)  # [:name:] like GNU
            out.append(c)
            i += 1
            if c == ord("["):
                in_class = True
                prev = "none"
                # leading '^' and a first ']' are literal class members
                if i < n and src[i] == ord("^"):
                    out.append(src[i])
                    i += 1
                if i < n and src[i] == ord("]"):
                    out.append(src[i])
                    i += 1
                    prev = "member"
            continue
        if c == ord("[") and i + 1 < n and src[i + 1] in (
            ord(":"), ord("."), ord("=")
        ):
            # dash just before: [a-[:digit:]] is GNU "Invalid range end"
            # (a LEADING '-' as in [-[:digit:]] stays a literal member)
            if prev == "dash" and src[i + 1] == ord(":"):
                raise RegexError("invalid range: POSIX class as range end")
            if src[i + 1] == ord(":"):
                name, i = _scan_posix_class(src, i)
                out += _POSIX_EXPANSIONS[name]
                # dash just after: [[:digit:]-z] is GNU "Invalid range
                # end" ([[:digit:]-] with the literal dash stays fine)
                if (i + 1 < n and src[i] == ord("-")
                        and src[i + 1] != ord("]")):
                    raise RegexError(
                        "invalid range: POSIX class as range start"
                    )
            else:
                # [.c.] / [=c=]: the character itself (C locale);
                # emit \xHH so re can't misread metacharacters
                byte, i = _scan_collating(src, i)
                out += b"\\x%02x" % byte
            prev = "member"
            continue
        if c == ord("]"):
            in_class = False
        elif c == ord("-"):
            prev = "dash" if prev == "member" else "member"
        else:
            prev = "member"
        out.append(c)
        i += 1
    res = bytes(out)
    return res.decode("utf-8", "surrogateescape") if is_str else res


# --------------------------------------------------------------------- AST

@dataclass
class Char:
    mask: int  # 256-bit membership bitmask


@dataclass
class Concat:
    parts: list


@dataclass
class Alt:
    options: list


@dataclass
class Repeat:
    node: object
    min: int
    max: int | None  # None = unbounded


@dataclass
class Anchor:
    kind: str  # "^" or "$"


_REPEAT_EXPANSION_CAP = 512  # total copies a bounded repeat may expand to

# Literal decomposition: how many byte strings an alternation or class
# product may expand to before it stops counting as a literal set.
LITERAL_SET_CAP = 256


def enumerate_literal_set(
    pattern: str, cap: int = LITERAL_SET_CAP, *, ignore_case: bool = False
) -> list[bytes] | None:
    """The byte strings ``pattern`` matches when it denotes a finite
    literal set -- alternations, concatenations and small class products,
    with no repeat or anchor -- else None (also past ``cap`` members, or
    when a member would be empty or hold '\\n').

    The parse is case-SENSITIVE: under -i the set engines fold the members
    themselves (enumerating folded classes would blow the cap at 2^len).
    ``ignore_case`` still folds a NEGATED class before it is complemented,
    or ``[^x]`` would enumerate ``X``, which the set engine folds back to
    the excluded ``x``.  Members come deduplicated in first-seen order."""
    try:
        ast = _Parser(pattern, ignore_case=False,
                      fold_negated_classes=ignore_case).parse()
    except RegexError:
        return None

    def enum(node) -> list[bytes] | None:
        if isinstance(node, Char):
            byts = [b for b in range(256) if node.mask >> b & 1]
            if not byts or len(byts) > cap or NL in byts:
                return None
            return [bytes([b]) for b in byts]
        if isinstance(node, Concat):
            acc = [b""]
            for part in node.parts:
                sub = enum(part)
                if sub is None or len(acc) * len(sub) > cap:
                    return None
                acc = [a + x for a in acc for x in sub]
            return acc
        if isinstance(node, Alt):
            out: list[bytes] = []
            for opt in node.options:
                sub = enum(opt)
                if sub is None or len(out) + len(sub) > cap:
                    return None
                out.extend(sub)
            return out
        return None  # Repeat, Anchor: unbounded or zero-width

    lits = enum(ast)
    if lits is None or not lits or any(not x for x in lits):
        return None
    return list(dict.fromkeys(lits))


def _fold_mask(mask: int) -> int:
    """Case-close a 256-bit byte-class mask (ASCII letters only)."""
    folded = mask
    for lo, up in zip(range(ord("a"), ord("z") + 1), range(ord("A"), ord("Z") + 1)):
        if mask >> lo & 1:
            folded |= 1 << up
        if mask >> up & 1:
            folded |= 1 << lo
    return folded


class _Parser:
    """Recursive-descent parser for the grep -E subset."""

    def __init__(self, pattern: str, ignore_case: bool,
                 fold_negated_classes: bool = False):
        self.src = (pattern.encode("utf-8", "surrogateescape")
                    if isinstance(pattern, str) else bytes(pattern))
        self.pos = 0
        self.ignore_case = ignore_case
        # A case-sensitive parse whose consumer folds members itself must
        # still fold a NEGATED class before complementing, or the
        # consumer's fold re-adds the excluded letter via its case partner.
        self.fold_negated_classes = fold_negated_classes

    def parse(self):
        node = self._alt()
        if self.pos != len(self.src):
            raise RegexError(f"unexpected {chr(self.src[self.pos])!r} at {self.pos}")
        return node

    # alt := concat ('|' concat)*
    def _alt(self):
        options = [self._concat()]
        while self._peek() == ord("|"):
            self.pos += 1
            options.append(self._concat())
        return options[0] if len(options) == 1 else Alt(options)

    # concat := repeat*
    def _concat(self):
        parts = []
        while True:
            c = self._peek()
            if c is None or c in (ord("|"), ord(")")):
                break
            parts.append(self._repeat())
        if not parts:
            return Concat([])
        return parts[0] if len(parts) == 1 else Concat(parts)

    # repeat := atom ('*'|'+'|'?'|'{m,n}')?
    def _repeat(self):
        atom = self._atom()
        c = self._peek()
        if c == ord("*"):
            self.pos += 1
            node = Repeat(atom, 0, None)
        elif c == ord("+"):
            self.pos += 1
            node = Repeat(atom, 1, None)
        elif c == ord("?"):
            self.pos += 1
            node = Repeat(atom, 0, 1)
        elif c == ord("{"):
            node = Repeat(atom, *self._bounds())
        else:
            return atom
        if isinstance(atom, Anchor):
            raise RegexError("cannot repeat an anchor")
        if self._peek() == ord("?"):  # lazy marker — match-detection is identical
            self.pos += 1
        return node

    def _bounds(self) -> tuple[int, int | None]:
        start = self.pos
        assert self.src[self.pos] == ord("{")
        self.pos += 1
        end = self.src.find(b"}", self.pos)
        if end < 0:
            raise RegexError(f"unterminated {{...}} at {start}")
        body = self.src[self.pos : end].decode("ascii", "replace")
        self.pos = end + 1
        try:
            if "," not in body:
                m = int(body)
                return m, m
            lo, hi = body.split(",", 1)
            m = int(lo) if lo else 0
            n = int(hi) if hi else None
        except ValueError as e:
            raise RegexError(f"bad repeat bounds {{{body}}}") from e
        if n is not None and n < m:
            raise RegexError(f"bad repeat bounds {{{body}}}: max < min")
        return m, n

    def _atom(self):
        c = self._peek()
        if c is None:
            raise RegexError("unexpected end of pattern")
        if c == ord("("):
            self.pos += 1
            if self.src[self.pos : self.pos + 2] == b"?:":  # non-capturing group
                self.pos += 2
            node = self._alt()
            if self._peek() != ord(")"):
                raise RegexError(f"unbalanced '(' at {self.pos}")
            self.pos += 1
            return node
        if c == ord("["):
            return Char(self._char_class())
        if c == ord("."):
            self.pos += 1
            return Char(_ANY_NO_NL)
        if c == ord("^"):
            self.pos += 1
            return Anchor("^")
        if c == ord("$"):
            self.pos += 1
            return Anchor("$")
        if c == ord("\\"):
            nxt = self.src[self.pos + 1] if self.pos + 1 < len(self.src) else None
            if nxt in (ord("A"), ord("Z")):
                # Per-line semantics make these exact synonyms of the
                # line anchors: a line-string contains no '\n', so \A is
                # start-of-line and \Z is end-of-line (verified
                # equivalent under the per-line re oracle).  GNU grep -E
                # has no \A/\Z, so CLI parity is unaffected.
                self.pos += 2
                return Anchor("^" if nxt == ord("A") else "$")
            if nxt in (ord("b"), ord("B")):
                # Word boundaries parse into Anchor nodes: no automaton
                # of this package expresses them yet, but the parse
                # stays identical to the reference's, so a pattern is
                # either accepted or rejected the same way by both.
                self.pos += 2
                return Anchor(chr(nxt))
            return Char(self._fold(self._escape()))
        if c in (ord("*"), ord("+"), ord("?"), ord("{"), ord("}")):
            # '{' not opening a valid bound is literal, like grep
            if c == ord("{"):
                save = self.pos
                try:
                    self.pos += 0
                    self._bounds()
                    raise RegexError("repeat with nothing to repeat")
                except RegexError as e:
                    if "nothing to repeat" in str(e):
                        raise
                    self.pos = save
            else:
                raise RegexError(f"nothing to repeat before {chr(c)!r} at {self.pos}")
        self.pos += 1
        return Char(self._fold(_mask_of(c)))

    def _escape(self, in_class: bool = False) -> int:
        self.pos += 1  # consume backslash
        if self.pos >= len(self.src):
            raise RegexError("trailing backslash")
        c = self.src[self.pos]
        self.pos += 1
        simple = {
            ord("n"): _mask_of(NL),
            ord("t"): _mask_of(9),
            ord("r"): _mask_of(13),
            ord("f"): _mask_of(12),
            ord("v"): _mask_of(11),
            ord("d"): _DIGIT,
            ord("D"): _ALL & ~_DIGIT & ~_mask_of(NL),
            ord("w"): _WORD,
            ord("W"): _ALL & ~_WORD & ~_mask_of(NL),
            ord("s"): _SPACE,
            ord("S"): _ALL & ~_SPACE,
        }
        if c in simple:
            return simple[c]
        if c == ord("x"):
            hexs = self.src[self.pos : self.pos + 2]
            if len(hexs) != 2:
                raise RegexError("bad \\x escape")
            self.pos += 2
            return _mask_of(int(hexs, 16))
        if c == ord("0"):
            # \0 plus up to 2 more octal digits (re semantics, both inside
            # and outside classes): \011 is a tab, NOT NUL + "11"
            digs = "0"
            while (len(digs) < 3 and self.pos < len(self.src)
                   and ord("0") <= self.src[self.pos] <= ord("7")):
                digs += chr(self.src[self.pos])
                self.pos += 1
            return _mask_of(int(digs, 8))
        if ord("1") <= c <= ord("9"):
            if in_class:
                if c > ord("7"):
                    # re rejects [\8]/[\9] too ("bad escape")
                    raise RegexError(f"bad escape \\{chr(c)} in class")
                # inside a class, \1.. are octal escapes (re semantics):
                # consume up to 3 octal digits
                digs = chr(c)
                while (len(digs) < 3 and self.pos < len(self.src)
                       and ord("0") <= self.src[self.pos] <= ord("7")):
                    digs += chr(self.src[self.pos])
                    self.pos += 1
                val = int(digs, 8)
                if val > 0xFF:
                    raise RegexError(f"octal escape \\{digs} out of range")
                return _mask_of(val)
            # \1..\9: a backreference, which no finite automaton expresses;
            # silently treating it as a literal digit would drop matches.
            raise UnsupportedSyntax(f"backreference \\{chr(c)} is not supported "
                             "by the automaton subset")
        if c == ord("b") and in_class:
            return _mask_of(8)  # [\b] = backspace, like re
        if c in (ord("b"), ord("B"), ord("A"), ord("Z"), ord("z"), ord("G")):
            # zero-width assertions beyond ^/$/\b (inside a class these
            # are invalid in re too).  \b/\B never reach here at atom
            # level: _atom parses them into Anchor nodes first.
            raise UnsupportedSyntax(f"\\{chr(c)} assertion is not supported "
                             "by the automaton subset")
        return _mask_of(c)  # escaped literal (metachars, punctuation, ...)

    def _char_class(self) -> int:
        start = self.pos
        assert self.src[self.pos] == ord("[")
        _reject_single_bracket_class(self.src, start)  # [:name:] like GNU
        self.pos += 1
        negate = False
        if self._peek() == ord("^"):
            negate = True
            self.pos += 1
        mask = 0
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise RegexError(f"unterminated '[' at {start}")
            if c == ord("]") and not first:
                self.pos += 1
                break
            first = False
            if (
                c == ord("[")
                and self.pos + 1 < len(self.src)
                and self.src[self.pos + 1] in (ord("."), ord("="))
            ):
                # [.c.] / [=c=]: trivial C-locale collating forms — the
                # character itself; longer names reject (_scan_collating)
                byte, self.pos = _scan_collating(self.src, self.pos)
                m = _mask_of(byte)
                # fall through to the range logic: [[.a.]-z] is a valid
                # range in GNU (the collating symbol is its character)
            elif (
                c == ord("[")
                and self.pos + 1 < len(self.src)
                and self.src[self.pos + 1] == ord(":")
            ):
                # POSIX bracket class [:name:] (GNU grep -E supports
                # these; Python re does not).  C-locale / ASCII byte definitions; '\n' is
                # excluded from the classes that would contain it
                # (space, cntrl) — a pattern can never consume '\n'
                # under per-line semantics, so exclusion is
                # semantics-preserving (same argument as '.').
                name, after = _scan_posix_class(self.src, self.pos)
                mask |= _POSIX_CLASSES[name]
                self.pos = after
                # a class can't be a range endpoint ([[:digit:]-z] is
                # GNU's "Invalid range end", exit 2; a trailing literal
                # '-' as in [[:digit:]-] stays fine)
                if (
                    self._peek() == ord("-")
                    and self.pos + 1 < len(self.src)
                    and self.src[self.pos + 1] != ord("]")
                ):
                    raise RegexError(
                        "invalid range: POSIX class as range start"
                    )
                continue
            elif c == ord("\\"):
                m = self._escape(in_class=True)
            else:
                self.pos += 1
                m = _mask_of(c)
            # range a-z: single char followed by '-' and another single char
            if (
                m.bit_count() == 1
                and self._peek() == ord("-")
                and self.pos + 1 < len(self.src)
                and self.src[self.pos + 1] != ord("]")
            ):
                self.pos += 1
                hi_c = self._peek()
                if (
                    hi_c == ord("[")
                    and self.pos + 1 < len(self.src)
                    and self.src[self.pos + 1] == ord(":")
                ):
                    # [a-[:digit:]]: GNU "Invalid range end", exit 2
                    raise RegexError(
                        "invalid range: POSIX class as range end"
                    )
                if (
                    hi_c == ord("[")
                    and self.pos + 1 < len(self.src)
                    and self.src[self.pos + 1] in (ord("."), ord("="))
                ):
                    # [a-[.z.]]: the collating symbol is its character
                    byte, self.pos = _scan_collating(self.src, self.pos)
                    hi_m = _mask_of(byte)
                elif hi_c == ord("\\"):
                    hi_m = self._escape(in_class=True)
                else:
                    self.pos += 1
                    hi_m = _mask_of(hi_c)
                if hi_m.bit_count() != 1:
                    raise RegexError("bad class range endpoint")
                lo_b = m.bit_length() - 1
                hi_b = hi_m.bit_length() - 1
                if hi_b < lo_b:
                    raise RegexError(f"reversed class range at {start}")
                for b in range(lo_b, hi_b + 1):
                    mask |= 1 << b
            else:
                mask |= m
        # Fold BEFORE complementing: [^x] under -i must exclude both 'x'
        # and 'X' (re/grep semantics).  Folding after would re-add the
        # excluded letter — the complement contains its case partner, and
        # expanding that partner puts the letter back (every engine path
        # shares this class mask, so the old order over-matched them all).
        # The complement of a case-closed set is itself case-closed, so no
        # second fold is needed.
        mask = self._fold(mask)
        if negate:
            if self.fold_negated_classes:
                mask = _fold_mask(mask)
            mask = _ALL & ~mask & ~_mask_of(NL)  # grep: negated classes skip \n
        return mask

    def _fold(self, mask: int) -> int:
        return _fold_mask(mask) if self.ignore_case else mask

    def _peek(self) -> int | None:
        return self.src[self.pos] if self.pos < len(self.src) else None


# --------------------------------------------------------------------- NFA

@dataclass
class _NfaState:
    # char transitions: list of (mask, target); eps: list of targets.
    # ls_eps / eol_eps carry mid-pattern anchors (round 5): an ls_eps
    # edge is traversable only at a line start (offset 0 or right after
    # '\n' — exactly the newline-reset start state's closure), an
    # eol_eps edge only when the next byte is '\n' or end-of-input
    # (folded into the accept_eol plane, like top-level '$').
    chars: list = field(default_factory=list)
    eps: list = field(default_factory=list)
    ls_eps: list = field(default_factory=list)
    eol_eps: list = field(default_factory=list)


class _Nfa:
    """Thompson construction.  Fragments are (start, accept) state-id pairs."""

    def __init__(self):
        self.states: list[_NfaState] = []

    def new_state(self) -> int:
        self.states.append(_NfaState())
        return len(self.states) - 1

    def build(self, node) -> tuple[int, int]:
        if isinstance(node, Char):
            if node.mask >> NL & 1:
                raise NewlineInPattern(
                    "pattern consumes '\\n' — not representable with line semantics"
                )
            if node.mask == 0:
                raise RegexError("empty character class matches nothing")
            s, a = self.new_state(), self.new_state()
            self.states[s].chars.append((node.mask, a))
            return s, a
        if isinstance(node, Concat):
            s = a = self.new_state()
            for part in node.parts:
                ps, pa = self.build(part)
                self.states[a].eps.append(ps)
                a = pa
            return s, a
        if isinstance(node, Alt):
            s, a = self.new_state(), self.new_state()
            for opt in node.options:
                os_, oa = self.build(opt)
                self.states[s].eps.append(os_)
                self.states[oa].eps.append(a)
            return s, a
        if isinstance(node, Repeat):
            return self._build_repeat(node)
        if isinstance(node, Anchor):
            # Mid-pattern anchors (round 5 — e.g. '(^a|b)c', 'a(b$|c)'):
            # a zero-width fragment whose epsilon is position-gated.  The
            # newline-reset scan represents both exactly: every line-start
            # position maps to the start state (ls_eps edges are closed
            # over only there), and EOL validity is the accept_eol plane
            # (eol_eps edges fold into it at subset-construction time).
            # Top-level anchors never reach here (_split_anchors pops
            # them); patterns like 'a^b' simply compile to automata with
            # no matches, exactly GNU grep's per-line semantics.
            if node.kind not in ("^", "$"):
                # \b/\B: wordness of the NEXT byte is one byte of
                # lookahead the accept planes don't carry — no exact
                # table form.  Raising routes the engine to its re
                # fallback, where the device rescue strips the anchors
                # into a filter and re-confirms candidate lines.
                raise RegexError(
                    f"\\{node.kind} assertion has no exact automaton form"
                )
            s, a = self.new_state(), self.new_state()
            edges = self.states[s].ls_eps if node.kind == "^" else self.states[s].eol_eps
            edges.append(a)
            return s, a
        raise AssertionError(f"unknown node {node!r}")

    def _build_repeat(self, node: Repeat) -> tuple[int, int]:
        m, n = node.min, node.max
        if n is not None and n > _REPEAT_EXPANSION_CAP:
            raise TooManyStates(f"repeat bound {n} exceeds expansion cap")
        if m > _REPEAT_EXPANSION_CAP:
            raise TooManyStates(f"repeat bound {m} exceeds expansion cap")
        s = a = self.new_state()
        for _ in range(m):  # required copies
            ps, pa = self.build(node.node)
            self.states[a].eps.append(ps)
            a = pa
        if n is None:  # star over one more copy
            ps, pa = self.build(node.node)
            self.states[a].eps.append(ps)
            self.states[pa].eps.append(ps)
            end = self.new_state()
            self.states[a].eps.append(end)
            self.states[pa].eps.append(end)
            return s, end
        for _ in range(n - m):  # optional copies: a -> ps..pa -> end, skip a -> end
            ps, pa = self.build(node.node)
            end = self.new_state()
            self.states[a].eps.append(ps)
            self.states[a].eps.append(end)
            self.states[pa].eps.append(end)
            a = end
        return s, a


# --------------------------------------------------------------------- DFA

@dataclass
class DfaTable:
    """Dense scan tables of one pattern.

    trans        [n_states, n_classes] uint16 -- next state per byte class
    byte_to_cls  [256] uint8 -- the byte's class (its column in ``trans``)
    accept       [n_states] bool -- a match ends at this byte
    accept_eol   [n_states] bool -- a match ends here iff the line ends
                 right after this byte (the '$' accept set)
    start        line-start state (also every state's target on '\\n')
    """

    trans: np.ndarray
    byte_to_cls: np.ndarray
    accept: np.ndarray
    accept_eol: np.ndarray
    start: int
    pattern: str

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]

    @property
    def n_classes(self) -> int:
        return self.trans.shape[1]

    def full_table(self) -> np.ndarray:
        """[n_states, 256] uint16, one column per byte (cached: the host
        oracle reads it for every batch of lines)."""
        full = getattr(self, "_full_cache", None)
        if full is None:
            full = np.ascontiguousarray(self.trans[:, self.byte_to_cls])
            full.flags.writeable = False  # shared across calls
            object.__setattr__(self, "_full_cache", full)
        return full


def dfa_table_from_arrays(
    trans, byte_to_cls, accept, accept_eol, start: int, pattern: str
) -> DfaTable:
    """Build a table from plain arrays -- the state a compiled pattern
    carries (a grep system has no weights; its compiled automaton is what
    two implementations must share).  Copies every array to a fresh
    contiguous one of the table's dtypes and checks the shapes."""
    t = np.ascontiguousarray(np.asarray(trans, dtype=np.uint16)).copy()
    cls = np.ascontiguousarray(np.asarray(byte_to_cls, dtype=np.uint8)).copy()
    acc = np.asarray(accept, dtype=bool).copy()
    eol = np.asarray(accept_eol, dtype=bool).copy()
    if t.ndim != 2 or cls.shape != (256,):
        raise ValueError(
            f"trans must be 2-D and byte_to_cls (256,), got {t.shape} and "
            f"{cls.shape}"
        )
    n_states, n_classes = t.shape
    if acc.shape != (n_states,) or eol.shape != (n_states,):
        raise ValueError(f"accept planes must have shape ({n_states},)")
    if int(cls.max()) >= n_classes or int(t.max(initial=0)) >= n_states:
        raise ValueError("byte class or target state out of range")
    if not 0 <= int(start) < n_states:
        raise ValueError(f"start state {start} out of range")
    return DfaTable(trans=t, byte_to_cls=cls, accept=acc, accept_eol=eol,
                    start=int(start), pattern=pattern)


def _split_anchors(node):
    """Pull top-level '^'/'$' anchors out of each alternation branch.

    Returns list of (anchored_start, body, anchored_end) triples.
    """
    branches = node.options if isinstance(node, Alt) else [node]
    out = []
    for b in branches:
        parts = list(b.parts) if isinstance(b, Concat) else [b]
        a_start = a_end = False
        while parts and isinstance(parts[0], Anchor) and parts[0].kind == "^":
            a_start = True
            parts.pop(0)
        while parts and isinstance(parts[-1], Anchor) and parts[-1].kind == "$":
            a_end = True
            parts.pop()
        body = Concat(parts) if len(parts) != 1 else parts[0]
        out.append((a_start, body, a_end))
    return out


def compile_dfa(
    pattern: str,
    ignore_case: bool = False,
    max_states: int = 4096,
) -> DfaTable:
    """Compile a grep -E subset pattern into newline-reset scan tables."""
    ast = _Parser(pattern, ignore_case).parse()
    branches = _split_anchors(ast)

    nfa = _Nfa()
    root = nfa.new_state()  # line-start entry: active at line starts only
    floating = nfa.new_state()  # Sigma* self-loop: unanchored search restarts
    nfa.states[root].eps.append(floating)
    nfa.states[floating].chars.append((_ANY_NO_NL, floating))

    accepts_now: set[int] = set()
    accepts_eol: set[int] = set()
    for a_start, body, a_end in branches:
        s, a = nfa.build(body)
        (nfa.states[root] if a_start else nfa.states[floating]).eps.append(s)
        (accepts_eol if a_end else accepts_now).add(a)

    # --- eps closures -----------------------------------------------------
    n = len(nfa.states)
    closures: list[frozenset[int]] = [frozenset()] * n

    def closure(seed: frozenset[int], ls: bool = False) -> frozenset[int]:
        """Epsilon closure; ``ls=True`` additionally traverses ls_eps
        edges (mid-pattern '^') — valid only for the start state, whose
        context IS "at a line start": offset 0 and every post-'\\n'
        position reset to it, and no other DFA state ever corresponds to
        a line-start position."""
        stack, seen = list(seed), set(seed)
        while stack:
            s = stack.pop()
            nxt = nfa.states[s].eps
            if ls:
                nxt = nxt + nfa.states[s].ls_eps
            for t in nxt:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    # Mid-pattern '$' (eol_eps edges): a state that can cross an eol edge
    # and then reach an accept through eps/eol edges ONLY (no byte may be
    # consumed after asserting end-of-line within a line) accepts at EOL.
    # ls_eps edges are NOT traversed here: '$^' would need the match to
    # span a newline, which per-line semantics (and GNU grep) exclude.
    all_accepts = accepts_now | accepts_eol
    eol_sources: set[int] = set()
    for sid in range(len(nfa.states)):
        targets = nfa.states[sid].eol_eps
        if not targets:
            continue
        stack, seen = list(targets), set(targets)
        while stack:
            u = stack.pop()
            for v in nfa.states[u].eps + nfa.states[u].eol_eps:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        if seen & all_accepts:
            eol_sources.add(sid)

    # --- byte classes -----------------------------------------------------
    # Two bytes are equivalent iff they belong to exactly the same set of
    # transition masks; '\n' is always its own class (the reset column).
    masks = sorted({m for st in nfa.states for (m, _) in st.chars})
    sig_to_cls: dict[tuple, int] = {}
    byte_to_cls = np.zeros(256, dtype=np.uint8)
    cls_repr: list[int] = []
    for b in range(256):
        s = ("NL",) if b == NL else tuple((m >> b) & 1 for m in masks)
        if s not in sig_to_cls:
            sig_to_cls[s] = len(sig_to_cls)
            cls_repr.append(b)
        byte_to_cls[b] = sig_to_cls[s]
    n_classes = len(sig_to_cls)
    nl_cls = int(byte_to_cls[NL])

    # --- subset construction ---------------------------------------------
    start_set = closure(frozenset({root}), ls=True)
    dfa_index: dict[frozenset[int], int] = {start_set: 0}
    order: list[frozenset[int]] = [start_set]
    rows: list[list[int]] = []

    i = 0
    while i < len(order):
        S = order[i]
        i += 1
        row = [0] * n_classes
        for c in range(n_classes):
            if c == nl_cls:
                row[c] = 0  # newline reset: every state -> line start
                continue
            b = cls_repr[c]
            moved = set()
            for s in S:
                for mask, t in nfa.states[s].chars:
                    if mask >> b & 1:
                        moved.add(t)
            T = closure(frozenset(moved)) if moved else frozenset()
            if T not in dfa_index:
                if len(order) >= max_states:
                    raise TooManyStates(
                        f"pattern {pattern!r} needs >{max_states} DFA states"
                    )
                dfa_index[T] = len(order)
                order.append(T)
            row[c] = dfa_index[T]
        rows.append(row)

    n_states = len(order)
    trans = np.asarray(rows, dtype=np.uint16)
    accept = np.array([bool(S & accepts_now) for S in order], dtype=bool)
    accept_eol = np.array(
        [bool(S & accepts_eol) or bool(S & eol_sources) for S in order],
        dtype=bool,
    )
    # EMPTY-line case: in the start state at EOL the position is a line
    # start AND an end-of-line simultaneously, so chains mixing '$' and
    # '^' in either order ('$^', '$(^|b)') hold there — and only there
    # (no other DFA state is ever at a line start).  The eol_sources walk
    # above deliberately excludes ls_eps (mid-line '$^' must stay dead),
    # so re-walk from the start set with ALL non-consuming edge kinds.
    if not accept_eol[0]:
        stack = list(start_set)
        seen = set(stack)
        while stack:
            u = stack.pop()
            st_u = nfa.states[u]
            for v in st_u.eps + st_u.ls_eps + st_u.eol_eps:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        # An assertion-only accepting chain from line start is exactly
        # "the empty line matches".  (If it needed no eol edge at all,
        # accept[0] is already True and every line matches — setting the
        # eol plane too is subsumed, not wrong.)
        if seen & all_accepts:
            accept_eol[0] = True
    return DfaTable(
        trans=trans,
        byte_to_cls=byte_to_cls,
        accept=accept,
        accept_eol=accept_eol,
        start=0,
        pattern=pattern if isinstance(pattern, str) else repr(pattern),
    )


@dataclass
class StrideTable:
    """k-byte-stride composition of a DfaTable (the reference's
    models/dfa.py StrideTable): the scan takes chunk / k steps of ONE read
    from an [n_states, n_classes**k] table whose int32 entries pack the
    state after the k bytes with a k-bit accept bitmap:

        entry = (state_after_k_bytes << k) | accept_bitmap
        bit t of accept_bitmap = accept[state after byte t of the stride]

    The combined class index takes the stride's first byte as its most
    significant base-n_classes digit.  The bitmap keeps every match's
    exact byte, so a '\\n' inside a stride resets as in the per-byte
    walk.  '$' accepts need the next byte, so such tables keep stride 1.
    """

    trans_k: np.ndarray  # [n_states, n_classes**k] int32 packed entries
    byte_to_cls: np.ndarray  # [256], the base table's
    k: int
    n_classes: int  # the base (1-byte) class count
    start: int

    @property
    def n_states(self) -> int:
        return self.trans_k.shape[0]


def choose_stride(table: DfaTable, max_entries: int = 1 << 23,
                  max_cols: int = 1 << 13) -> int:
    """The largest k in (4, 2, 1) whose composed table fits the budget
    (``max_entries`` bounds its size, ``max_cols`` the combined class
    index); 1 for a table with '$' accepts.  Powers of two only: the
    layouts' chunks are multiples of 32, which k must divide."""
    if table.accept_eol.any():
        return 1
    for k in (4, 2):
        cols = table.n_classes ** k
        if cols <= max_cols and table.n_states * cols <= max_entries:
            return k
    return 1


def build_stride_table(table: DfaTable, k: int) -> StrideTable:
    """Compose ``table`` over k-byte strides (vectorized over states).
    Raises ValueError for k < 1, and for k > 1 on a table with '$'
    accepts."""
    if k < 1:
        raise ValueError(f"stride must be >= 1, got {k}")
    if k > 1 and table.accept_eol.any():
        raise ValueError("'$' accepts need next-byte context; stride must "
                         "be 1")
    n_states, n_classes = table.n_states, table.n_classes
    trans = table.trans.astype(np.int64)
    # states[s, j]: the state after the class sequence j (base-n_classes
    # digits, the first byte most significant) from s; bitmap the accepts
    states = np.arange(n_states, dtype=np.int64)[:, None]
    bitmap = np.zeros((n_states, 1), dtype=np.int64)
    for t in range(k):
        states = trans[states].reshape(n_states, -1)
        bitmap = (np.repeat(bitmap[:, :, None], n_classes, axis=2)
                  .reshape(n_states, -1)
                  | (table.accept[states].astype(np.int64) << t))
    packed = (states << k) | bitmap
    return StrideTable(trans_k=np.ascontiguousarray(packed.astype(np.int32)),
                       byte_to_cls=table.byte_to_cls, k=k,
                       n_classes=n_classes, start=table.start)


def reference_scan(table: DfaTable, data) -> np.ndarray:
    """Host scan of ``data``: the int64 end offsets (index + 1) of every
    match, sorted and unique.  The accept plane runs in the host library
    (utils/native.py: ``dfa_scan``, or ``dfa_scan_mt`` from
    MT_THRESHOLD_BYTES on).  A '$' pattern takes a second pass of the same
    state sequence with ``accept_eol`` as the accept plane, kept where the
    next byte is '\\n' or the input ends.  Two edges of that pass:

    * a trailing '\\n' leaves the scan in the start state at offset n; a
      zero-width accept there would be a line that does not exist, so it
      is dropped (a consuming match cannot end at n: it would hold the
      '\\n');
    * the scan reports accepts only after a byte, so a zero-width accept
      at offset 0 (an empty first line, '^$') never surfaces: offset 0 is
      added when the data starts with '\\n', which line attribution maps
      to line 1.  Empty data has no line, and no match."""
    from distributed_grep_tpu_torch.utils import native

    full = table.full_table()
    n = len(data)

    def run(accept: np.ndarray) -> np.ndarray:
        acc = accept.astype(np.uint8)
        if n >= native.MT_THRESHOLD_BYTES:
            offs = native.dfa_scan_mt(data, full, acc, table.start)
        else:
            offs, _ = native.dfa_scan(data, full, acc, table.start)
        return offs.astype(np.int64)

    offsets = run(table.accept)
    if not table.accept_eol.any():
        return offsets
    eol_offs = run(table.accept_eol)
    if eol_offs.size:
        arr = np.frombuffer(data, dtype=np.uint8)
        keep = (eol_offs == n) | (arr[np.minimum(eol_offs, n - 1)] == NL)
        if n and arr[n - 1] == NL and table.accept_eol[table.start]:
            keep &= eol_offs != n
        eol_offs = eol_offs[keep]
    if table.accept_eol[table.start] and n > 0 and data[0] == NL:
        eol_offs = np.concatenate([np.zeros(1, np.int64), eol_offs])
    if not eol_offs.size:
        return offsets
    return np.unique(np.concatenate([offsets, eol_offs]))
