"""A ``tokenizer.json`` reader without the ``tokenizers`` package.

The GPU machine has no ``tokenizers`` package, so this module reads the
HF serialization itself, as ``sp_model.py`` reads ``tokenizer.model``
without ``sentencepiece``. It implements the encode and decode pipeline of
the package for the components the served families' files declare:

- model: BPE (``merges`` as ``"a b"`` strings or ``[a, b]`` pairs,
  ``ignore_merges``, ``byte_fallback``, ``unk_token`` / ``fuse_unk``,
  ``continuing_subword_prefix`` / ``end_of_word_suffix``);
- added tokens, matched in the raw text before normalization (those with
  ``normalized: true`` in each normalized piece), leftmost and longest
  first, with ``single_word``, ``lstrip`` and ``rstrip``;
- normalizers: NFC, NFKC, Prepend, Replace, Sequence;
- pre-tokenizers: ByteLevel (``use_regex`` on or off), Split (a Regex or
  String pattern, its ``behavior``, ``invert``), Metaspace, Sequence;
- post-processors: TemplateProcessing (single sequence), ByteLevel,
  Sequence;
- decoders: ByteLevel, Replace, ByteFallback, Fuse, Strip, Metaspace,
  Sequence.

Anything else raises ``ValueError`` naming the component: nothing falls
back to an approximate encoding.

The package's regexes run on Oniguruma. Python's ``re`` lacks ``\\p{..}``
and counts U+001C-U+001F as ``\\s``, which Oniguruma does not, so each
pattern is translated: ``\\p{X}`` becomes a class built from
``unicodedata`` (once per process, on first use), ``\\s`` the Unicode
White_Space set, and ``^`` / ``$`` the line anchors they are in
Oniguruma's Ruby syntax.
"""

from __future__ import annotations

import heapq
import json
import re
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["BpeTokenizer", "translate_regex"]

# ---------------------------------------------------------------- regexes

# Unicode White_Space, Oniguruma's \s (Python's \s adds U+001C-U+001F)
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))
_CATEGORY_RANGES: Dict[str, List[Tuple[int, int]]] = {}


def _category_ranges(name: str) -> List[Tuple[int, int]]:
    """Code point ranges of a general category (``L``, ``Lu``, ``N``...),
    built in one pass over all code points the first time any is asked."""
    if not _CATEGORY_RANGES:
        by_cat: Dict[str, List[Tuple[int, int]]] = {}
        prev, start = None, 0
        for cp in range(0x110000):
            cat = unicodedata.category(chr(cp))
            if cat != prev:
                if prev is not None:
                    by_cat.setdefault(prev, []).append((start, cp - 1))
                prev, start = cat, cp
        by_cat.setdefault(prev, []).append((start, 0x10FFFF))
        _CATEGORY_RANGES.update(by_cat)
    if name in _CATEGORY_RANGES:
        return _CATEGORY_RANGES[name]
    if len(name) != 1 or name not in "LMNPSZC":
        raise ValueError(f"unsupported regex class \\p{{{name}}}")
    return sorted(r for cat, rs in _CATEGORY_RANGES.items()
                  if cat[0] == name for r in rs)


def _class_body(ranges) -> str:
    def esc(cp: int) -> str:
        return f"\\U{cp:08x}"
    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}"
                   for a, b in ranges)


def _read_property(p: str, i: int) -> Tuple[str, int]:
    """The property name of ``\\p`` at ``p[i]`` (after the ``p``)."""
    if p[i] == "{":
        j = p.index("}", i)
        return p[i + 1:j], j + 1
    return p[i], i + 1


def translate_regex(pattern: str) -> "re.Pattern":
    """Compile an Oniguruma pattern of a ``tokenizer.json`` with Python's
    ``re`` (see the module docstring); an escape whose meaning differs and
    is not translated (``\\w``, ``\\b``...) raises ``ValueError``."""
    out: List[str] = []
    i, n = 0, len(pattern)
    ws = _class_body(_WHITE_SPACE)
    while i < n:
        c = pattern[i]
        if c == "\\":
            e = pattern[i + 1]
            if e in "pP":
                name, i = _read_property(pattern, i + 2)
                neg = "^" if e == "P" else ""
                out.append(f"[{neg}{_class_body(_category_ranges(name))}]")
                continue
            if e in "sS":
                out.append(f"[{'^' if e == 'S' else ''}{ws}]")
            elif e in "wWbBhHRXKGyY":
                raise ValueError(f"unsupported regex escape \\{e} in "
                                 f"{pattern!r}")
            elif e == "z":
                out.append(r"\Z")
            elif e == "Z":
                out.append(r"(?=\n?\Z)")
            else:
                out.append(pattern[i:i + 2])
            i += 2
        elif c == "[":
            j = i + 1
            body = ["["]
            if j < n and pattern[j] == "^":
                body.append("^")
                j += 1
            if j < n and pattern[j] == "]":
                body.append(r"\]")
                j += 1
            while j < n and pattern[j] != "]":
                d = pattern[j]
                if d == "[" or pattern.startswith("&&", j):
                    raise ValueError(f"unsupported nested class in "
                                     f"{pattern!r}")
                if d == "\\":
                    e = pattern[j + 1]
                    if e == "p":
                        name, j = _read_property(pattern, j + 2)
                        body.append(_class_body(_category_ranges(name)))
                        continue
                    if e == "s":
                        body.append(ws)
                    elif e in "PSwWhH":
                        raise ValueError(f"unsupported class escape \\{e} "
                                         f"in {pattern!r}")
                    else:
                        body.append(pattern[j:j + 2])
                    j += 2
                    continue
                body.append(d)
                j += 1
            if j >= n:
                raise ValueError(f"unterminated class in {pattern!r}")
            body.append("]")
            out.append("".join(body))
            i = j + 1
        elif c == "$":
            out.append(r"(?=\n|\Z)")
            i += 1
        elif c == "^":
            out.append(r"(?:\A|(?<=\n))")
            i += 1
        else:
            out.append(c)
            i += 1
    return re.compile("".join(out))


def _pattern_matcher(spec: dict, what: str) -> Callable[[str], list]:
    """A ``{"Regex": ..}`` / ``{"String": ..}`` pattern as a function giving
    the package's ``find_matches``: ``[(start, end, is_match)]`` covering
    the text."""
    if "Regex" in spec:
        rx = translate_regex(spec["Regex"])
    elif "String" in spec:
        if not spec["String"]:
            return lambda s: [(0, len(s), False)]
        rx = re.compile(re.escape(spec["String"]))
    else:
        raise ValueError(f"{what}: unsupported pattern {spec!r}")

    def find(s: str) -> list:
        if not s:
            return [(0, 0, False)]
        out, prev = [], 0
        for m in rx.finditer(s):
            a, b = m.span()
            if prev != a:
                out.append((prev, a, False))
            out.append((a, b, True))
            prev = b
        if prev != len(s):
            out.append((prev, len(s), False))
        return out
    return find


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's printable stand-in for every byte (the ByteLevel alphabet)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_CHAR = _bytes_to_unicode()
CHAR_BYTE = {c: b for b, c in BYTE_CHAR.items()}
_BYTE_LEVEL_RE = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                  r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")

# ------------------------------------------------------------- normalizers


def _normalizer(spec: Optional[dict]) -> Callable[[str], str]:
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_normalizer(s) for s in spec["normalizers"]]

        def seq(s: str) -> str:
            for p in parts:
                s = p(s)
            return s
        return seq
    if kind in ("NFC", "NFKC"):
        return lambda s: unicodedata.normalize(kind, s)
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        content = spec["content"]
        pat = spec["pattern"]
        if "String" in pat:
            lit = pat["String"]
            return lambda s: s.replace(lit, content) if lit else s
        if "Regex" in pat:
            rx = translate_regex(pat["Regex"])
            return lambda s: rx.sub(lambda _m: content, s)
    raise ValueError(f"tokenizer.json: unsupported normalizer {kind!r}")


# ---------------------------------------------------------- pre-tokenizers
# A piece is (text, at_start): at_start marks a piece that begins at offset
# 0 of the input (Metaspace's "first" prepend scheme reads it).

Piece = Tuple[str, bool]


def _split_behavior(find, behavior: str, invert: bool):
    def split(text: str) -> List[Tuple[int, int]]:
        matches = [(a, b, m != invert) for a, b, m in find(text)]
        if behavior == "Isolated":
            return [(a, b) for a, b, _ in matches]
        if behavior == "Removed":
            return [(a, b) for a, b, m in matches if not m]
        if behavior == "Contiguous":
            out: List[list] = []
            prev = None
            for a, b, m in matches:
                if out and m == prev:
                    out[-1][1] = b
                else:
                    out.append([a, b])
                prev = m
            return [tuple(x) for x in out]
        if behavior == "MergedWithPrevious":
            out, prev = [], False
            for a, b, m in matches:
                if m and not prev and out:
                    out[-1] = (out[-1][0], b)
                else:
                    out.append((a, b))
                prev = m
            return out
        if behavior == "MergedWithNext":
            out, prev = [], False
            for a, b, m in reversed(matches):
                if m and not prev and out:
                    out[-1] = (a, out[-1][1])
                else:
                    out.append((a, b))
                prev = m
            return out[::-1]
        raise ValueError(f"tokenizer.json: unsupported split behavior "
                         f"{behavior!r}")
    return split


def _apply_split(pieces: List[Piece], split) -> List[Piece]:
    out: List[Piece] = []
    for text, at_start in pieces:
        for a, b in split(text):
            if b > a:
                out.append((text[a:b], at_start and a == 0))
    return out


def _pre_tokenizer(spec: Optional[dict]):
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(pieces):
            for p in parts:
                pieces = p(pieces)
            return pieces
        return seq
    if kind == "Split":
        split = _split_behavior(_pattern_matcher(spec["pattern"], "Split"),
                                spec["behavior"], bool(spec.get("invert")))
        return lambda pieces: _apply_split(pieces, split)
    if kind == "ByteLevel":
        prefix = bool(spec.get("add_prefix_space"))
        split = (_split_behavior(
            _pattern_matcher({"Regex": _BYTE_LEVEL_RE}, "ByteLevel"),
            "Isolated", False) if spec.get("use_regex", True) else None)

        def byte_level(pieces):
            if prefix:
                pieces = [(t if t.startswith(" ") else " " + t, s)
                          for t, s in pieces]
            if split is not None:
                pieces = _apply_split(pieces, split)
            return [("".join(BYTE_CHAR[b] for b in t.encode("utf-8")), s)
                    for t, s in pieces]
        return byte_level
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:      # the older form's add_prefix_space
            scheme = "always" if spec.get("add_prefix_space", True) \
                else "never"
        if scheme not in ("always", "first", "never"):
            raise ValueError(f"tokenizer.json: unsupported Metaspace "
                             f"prepend_scheme {scheme!r}")
        do_split = spec.get("split", True)
        split = _split_behavior(
            _pattern_matcher({"String": rep}, "Metaspace"),
            "MergedWithNext", False)

        def metaspace(pieces):
            out = []
            for t, s in pieces:
                t = t.replace(" ", rep)
                if not t.startswith(rep) and (
                        scheme == "always" or (scheme == "first" and s)):
                    t = rep + t
                out.append((t, s))
            return _apply_split(out, split) if do_split else out
        return metaspace
    raise ValueError(f"tokenizer.json: unsupported pre_tokenizer {kind!r}")


# ---------------------------------------------------------------- decoders


def _byte_fallback(tokens: List[str]) -> List[str]:
    out: List[str] = []
    pending = bytearray()

    def flush():
        if pending:
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend(["�"] * len(pending))
            pending.clear()
    for t in tokens:
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                pending.append(int(t[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(t)
    flush()
    return out


def _strip(content: str, start: int, stop: int):
    def strip(tokens: List[str]) -> List[str]:
        out = []
        for t in tokens:
            a = 0
            while a < min(start, len(t)) and t[a] == content:
                a += 1
            b = len(t)
            for _ in range(stop):
                if b > a and t[b - 1] == content:
                    b -= 1
                else:
                    break
            out.append(t[a:b])
        return out
    return strip


def _decoder(spec: Optional[dict]):
    """A decoder as ``decode_chain``: token strings in, strings out."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_decoder(s) for s in spec["decoders"]]

        def seq(tokens):
            for p in parts:
                tokens = p(tokens)
            return tokens
        return seq
    if kind == "ByteLevel":
        def byte_level(tokens):
            buf = bytearray()
            for t in tokens:
                bs = [CHAR_BYTE.get(c) for c in t]
                buf += (t.encode("utf-8") if None in bs else bytes(bs))
            return [buf.decode("utf-8", errors="replace")]
        return byte_level
    if kind == "Replace":
        pat, content = spec["pattern"], spec["content"]
        if "String" in pat:
            lit = pat["String"]
            return lambda ts: [t.replace(lit, content) if lit else t
                               for t in ts]
        if "Regex" in pat:
            rx = translate_regex(pat["Regex"])
            return lambda ts: [rx.sub(lambda _m: content, t) for t in ts]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda ts: ["".join(ts)]
    if kind == "Strip":
        return _strip(spec["content"], int(spec["start"]), int(spec["stop"]))
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) \
                else "never"

        def metaspace(tokens):
            # the first token loses every replacement character
            return [t.replace(rep, "" if i == 0 and scheme != "never"
                              else " ") for i, t in enumerate(tokens)]
        return metaspace
    raise ValueError(f"tokenizer.json: unsupported decoder {kind!r}")


# ---------------------------------------------------------- post-processors


def _post_processor(spec: Optional[dict]):
    """``ids -> ids`` where special tokens are asked for; only
    TemplateProcessing adds ids (ByteLevel's trims offsets, which this
    reader does not keep)."""
    if spec is None:
        return lambda ids: ids
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_post_processor(s) for s in spec["processors"]]

        def seq(ids):
            for p in parts:
                ids = p(ids)
            return ids
        return seq
    if kind == "ByteLevel":
        return lambda ids: ids
    if kind == "TemplateProcessing":
        specials = {k: list(v["ids"])
                    for k, v in (spec.get("special_tokens") or {}).items()}
        pieces: List[Optional[List[int]]] = []
        for item in spec["single"]:
            if "SpecialToken" in item:
                pieces.append(specials[item["SpecialToken"]["id"]])
            elif item.get("Sequence", {}).get("id") == "A":
                pieces.append(None)
            else:
                raise ValueError(f"tokenizer.json: unsupported template "
                                 f"piece {item!r}")

        def template(ids):
            out: List[int] = []
            for p in pieces:
                out += ids if p is None else p
            return out
        return template
    raise ValueError(f"tokenizer.json: unsupported post_processor {kind!r}")


# -------------------------------------------------------------------- BPE


class _Bpe:
    """The BPE model: a pre-token's characters (or byte-fallback tokens, or
    unk) merged pair by pair, lowest merge rank first and leftmost among
    equals, as the package's ``Word::merge_all``."""

    def __init__(self, spec: dict):
        if spec.get("type", "BPE") != "BPE":
            raise ValueError(f"tokenizer.json: unsupported model "
                             f"{spec.get('type')!r}")
        if spec.get("dropout") not in (None, 0, 0.0):
            raise ValueError("tokenizer.json: BPE dropout is not supported")
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.vocab_r: Dict[int, str] = {i: t for t, i in self.vocab.items()}
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk"))
        self.byte_fallback = bool(spec.get("byte_fallback"))
        self.ignore_merges = bool(spec.get("ignore_merges"))
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges") or []):
            if isinstance(m, str):
                parts = m.split(" ", 1)
                if len(parts) != 2:
                    raise ValueError(f"tokenizer.json: bad merge {m!r}")
                a, b = parts
            else:
                a, b = m
            merged = a + b[len(self.prefix):]
            try:
                key = (self.vocab[a], self.vocab[b])
                self.merges[key] = (rank, self.vocab[merged])
            except KeyError as e:
                raise ValueError(f"tokenizer.json: merge {a!r} {b!r} has a "
                                 f"token out of the vocabulary: {e}") from None
        self._cache: Dict[str, List[int]] = {}

    def _symbols(self, word: str) -> List[int]:
        out: List[int] = []
        unk: Optional[int] = None     # a pending (fused) unk
        for i, ch in enumerate(word):
            s = ch
            if i > 0 and self.prefix:
                s = self.prefix + s
            if i == len(word) - 1 and self.suffix:
                s = s + self.suffix
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    out.append(unk)
                    unk = None
                out.append(tid)
                continue
            if self.byte_fallback:
                bs = [self.vocab.get(f"<0x{b:02X}>") for b in s.encode()]
                if None not in bs:
                    out += bs
                    continue
            if self.unk_token is not None:
                if self.unk_token not in self.vocab:
                    raise ValueError(f"tokenizer.json: unk token "
                                     f"{self.unk_token!r} is not in the "
                                     f"vocabulary")
                if unk is not None and not self.fuse_unk:
                    out.append(unk)
                unk = self.vocab[self.unk_token]
        if unk is not None:
            out.append(unk)
        return out

    def _merge_all(self, syms: List[int]) -> List[int]:
        n = len(syms)
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        merges = self.merges
        heap = []
        for i in range(n - 1):
            m = merges.get((syms[i], syms[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = merges.get((syms[pos], syms[right]))
            if m is None or m[1] != new_id:
                continue
            syms[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] != -1:
                prv[nxt[right]] = pos
            if prv[pos] >= 0:
                m = merges.get((syms[prv[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] != -1:
                m = merges.get((new_id, syms[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(syms, alive) if a]

    def tokenize(self, word: str) -> List[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        hit = self._cache.get(word)
        if hit is None:
            hit = self._merge_all(self._symbols(word))
            self._cache[word] = hit
        return list(hit)


# ------------------------------------------------------------ added tokens


def _is_word_char(c: str) -> bool:
    return c.isalnum() or c == "_"


def _is_white_space(c: str) -> bool:
    """Rust's ``char::is_whitespace`` (White_Space), not ``str.isspace``."""
    cp = ord(c)
    return any(a <= cp <= b for a, b in _WHITE_SPACE)


class _AddedTokens:
    def __init__(self, entries: List[dict], normalize):
        self.by_content: Dict[str, dict] = {}
        self.id_to_content: Dict[int, str] = {}
        self.special = set()
        for e in entries:
            self.by_content[e["content"]] = e
            self.id_to_content[int(e["id"])] = e["content"]
            if e.get("special"):
                self.special.add(e["content"])
        raw = [e for e in entries if not e.get("normalized")]
        norm = [e for e in entries if e.get("normalized")]
        self.raw = self._matcher({e["content"]: e for e in raw})
        self.norm = self._matcher({normalize(e["content"]): e
                                   for e in norm})

    @staticmethod
    def _matcher(by_pattern: Dict[str, dict]):
        pats = sorted((p for p in by_pattern if p), key=len, reverse=True)
        if not pats:
            return None
        # an alternation of literals, longest first, finds the leftmost
        # longest match at each position
        return re.compile("|".join(map(re.escape, pats))), by_pattern

    @staticmethod
    def split(text: str, matcher) -> List[Tuple[int, int, Optional[int]]]:
        """The package's ``find_matches``: ``[(start, end, id or None)]``."""
        if matcher is None or not text:
            return [(0, len(text), None)]
        rx, by_pattern = matcher
        out, offset = [], 0
        for m in rx.finditer(text):
            start, stop = m.start(), m.end()
            e = by_pattern[m.group()]
            if e.get("single_word"):
                if ((start > 0 and _is_word_char(text[start - 1]))
                        or (stop < len(text) and _is_word_char(text[stop]))):
                    continue
            if e.get("lstrip"):
                s = start
                while s > 0 and _is_white_space(text[s - 1]):
                    s -= 1
                start = max(s, offset)
            if e.get("rstrip"):
                while stop < len(text) and _is_white_space(text[stop]):
                    stop += 1
            if offset < start:
                out.append((offset, start, None))
            out.append((start, stop, int(e["id"])))
            offset = stop
        if offset != len(text):
            out.append((offset, len(text), None))
        return out


class BpeTokenizer:
    """A ``tokenizer.json`` with a BPE model, with the ``tokenizers``
    package's ``encode`` / ``decode`` / ``id_to_token`` / ``token_to_id``
    / ``get_vocab_size``."""

    def __init__(self, spec: dict):
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise ValueError(f"tokenizer.json: unsupported {key} "
                                 f"{spec[key]!r}")
        self.model = _Bpe(spec["model"])
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.added = _AddedTokens(spec.get("added_tokens") or [],
                                  self.normalize)
        self.post_process = _post_processor(spec.get("post_processor"))
        self.decoder = _decoder(spec.get("decoder"))

    @classmethod
    def from_file(cls, path: str) -> "BpeTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    def _pieces(self, text: str) -> List[Tuple[str, bool, Optional[int]]]:
        """Added tokens out of the raw text, each other piece normalized,
        then the normalized added tokens out of it."""
        out = []
        for a, b, tid in _AddedTokens.split(text, self.added.raw):
            if tid is not None:
                out.append((text[a:b], False, tid))
                continue
            norm = self.normalize(text[a:b])
            for c, d, tid2 in _AddedTokens.split(norm, self.added.norm):
                out.append((norm[c:d], a == 0 and c == 0, tid2))
        return out

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> Tuple[List[int], List[str]]:
        ids: List[int] = []
        for piece, at_start, tid in self._pieces(text):
            if tid is not None:
                ids.append(tid)
                continue
            if not piece:
                continue
            for word, _ in self.pre_tokenize([(piece, at_start)]):
                ids += self.model.tokenize(word)
        if add_special_tokens:
            ids = self.post_process(ids)
        return ids, [self.id_to_token(i) for i in ids]

    def id_to_token(self, tid: int) -> Optional[str]:
        tok = self.added.id_to_content.get(tid)
        return tok if tok is not None else self.model.vocab_r.get(tid)

    def token_to_id(self, token: str) -> Optional[int]:
        e = self.added.by_content.get(token)
        return int(e["id"]) if e is not None else self.model.vocab.get(token)

    def get_vocab_size(self) -> int:
        return len(set(self.model.vocab) | set(self.added.by_content))

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            t = self.id_to_token(int(i))
            if t is None or (skip_special_tokens and t in self.added.special):
                continue
            tokens.append(t)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))
