"""Regex parser for the grep -E subset: pattern text -> AST of byte masks.

The port's own copy of the reference package's parser: only the parser
and its helpers (byte masks, escapes, bracket and POSIX classes, case
folding).  Automaton construction is not part of this package; the
Shift-And compiler (models/shift_and.py) walks the AST returned here.

Supported syntax: literals (UTF-8 as raw byte sequences), '.', escapes
(\\n \\t \\xHH \\d \\w \\s and their negations, escaped metachars),
character classes [a-z] / [^...] / [[:alpha:]], alternation '|', groups,
repeats '* + ? {m,n}', anchors '^' '$' '\\b', and case folding.
"""

from __future__ import annotations

from dataclasses import dataclass


class RegexError(ValueError):
    """Malformed pattern."""


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
