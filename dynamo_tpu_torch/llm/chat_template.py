"""Hugging Face chat templates rendered without ``jinja2``.

The GPU machine has no ``jinja2``, so the port renders the templates a
model directory ships with an interpreter of the subset of Jinja they use,
with the semantics of the environment the JAX ``PromptFormatter`` builds
(``trim_blocks``, ``lstrip_blocks``, loop controls, ``tojson`` as plain
``json.dumps``, ``raise_exception`` and ``strftime_now``):

- ``{{ }}``, ``{% %}`` and ``{# #}`` with the ``-`` / ``+`` whitespace
  markers, and Jinja's newline normalization;
- ``if`` / ``elif`` / ``else``, ``for`` (tuple targets, an ``if`` filter,
  ``else``, ``loop.*``), ``break`` / ``continue``, ``set`` (names, tuples
  and namespace attributes) and ``namespace()``, with Jinja's scoping: a
  ``set`` inside a ``for`` is local to the iteration;
- expressions with Jinja's precedence: conditional, ``or`` / ``and`` /
  ``not``, comparisons and ``in``, ``+ -``, ``~``, ``* / // %``, ``**``,
  filters and ``is`` tests, subscripts, slices and attributes (a dict's
  keys read through ``.``), list / tuple / dict literals;
- the undefined value, which renders ``""``, is falsy, iterates as empty
  and raises on arithmetic and on attribute access;
- the filters, tests, functions and methods named in ``FILTERS``,
  ``TESTS``, ``FUNCTIONS`` and ``METHODS``.

Anything else (a ``macro``, an unknown filter, a call to a method outside
``METHODS``) is a ``TemplateSyntaxError`` when the template is parsed,
naming the construct.
"""

from __future__ import annotations

import datetime
import json
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["ChatTemplate", "TemplateError", "TemplateSyntaxError",
           "UndefinedError", "Undefined"]


class TemplateError(Exception):
    """A template failed to render (``raise_exception`` among others)."""


class TemplateSyntaxError(TemplateError):
    """A template uses a construct outside the supported subset, or is
    malformed."""


class UndefinedError(TemplateError):
    """An undefined value was used where Jinja raises for it."""


class Undefined:
    """Jinja's default undefined value."""

    __slots__ = ("_name",)

    def __init__(self, name: str = "value"):
        self._name = name

    def _fail(self, *_a, **_kw):
        raise UndefinedError(f"{self._name!r} is undefined")

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _fail
    __truediv__ = __rtruediv__ = __floordiv__ = __rfloordiv__ = _fail
    __mod__ = __rmod__ = __pow__ = __rpow__ = __neg__ = __pos__ = _fail
    __lt__ = __le__ = __gt__ = __ge__ = __call__ = __getitem__ = _fail

    def __str__(self) -> str:
        return ""

    def __bool__(self) -> bool:
        return False

    def __iter__(self):
        return iter(())

    def __len__(self) -> int:
        return 0

    def __eq__(self, other) -> bool:
        return type(other) is Undefined

    def __ne__(self, other) -> bool:
        return type(other) is not Undefined

    def __hash__(self) -> int:
        return id(type(self))


class Namespace:
    """``namespace()``: the one object a ``set`` may change across
    scopes."""

    def __init__(self, *args, **kwargs):
        self.attrs = dict(*args, **kwargs)


class _Loop:
    """``loop`` inside a ``for``."""

    def __init__(self, items: list):
        self._items = items
        self.index0 = 0

    def attr(self, name: str):
        i, n = self.index0, len(self._items)
        values = {"index0": i, "index": i + 1, "revindex": n - i,
                  "revindex0": n - i - 1, "first": i == 0,
                  "last": i == n - 1, "length": n, "depth": 1,
                  "depth0": 0}
        if name in values:
            return values[name]
        if name == "previtem":
            return self._items[i - 1] if i > 0 else Undefined(
                "there is no previous item")
        if name == "nextitem":
            return self._items[i + 1] if i + 1 < n else Undefined(
                "there is no next item")
        return Undefined(f"loop.{name}")

    def cycle(self, *args):
        if not args:
            raise TemplateError("no items for cycling given")
        return args[self.index0 % len(args)]


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


# ------------------------------------------------------------ the library


def _tojson(value, ensure_ascii: bool = False, indent=None, separators=None,
            sort_keys: bool = False) -> str:
    """transformers' chat-template tojson (plain json.dumps, no HTML
    escaping)."""
    return json.dumps(value, ensure_ascii=ensure_ascii, indent=indent,
                      separators=separators, sort_keys=sort_keys)


def _first(seq):
    for x in seq:
        return x
    return Undefined("No first item, sequence was empty.")


def _last(seq):
    items = list(seq)
    return items[-1] if items else Undefined(
        "No last item, sequence was empty.")


def _items(value):
    if isinstance(value, Undefined):
        return []
    if not isinstance(value, dict):
        raise TypeError("Can only get item pairs from a mapping.")
    return list(value.items())


def _join(value, d: str = "", attribute=None):
    if attribute is not None:
        value = [_getattr(v, attribute) for v in value]
    return str(d).join(map(str, value))


def _default(value, default_value="", boolean: bool = False):
    if isinstance(value, Undefined) or (boolean and not value):
        return default_value
    return value


FILTERS: Dict[str, Callable] = {
    "trim": lambda v, chars=None: str(v).strip(chars),
    "tojson": _tojson,
    "length": len,
    "upper": lambda v: str(v).upper(),
    "lower": lambda v: str(v).lower(),
    "join": _join,
    "default": _default,
    "first": _first,
    "last": _last,
    "list": list,
    "items": _items,
    "string": str,
}

TESTS: Dict[str, Callable] = {
    "defined": lambda v: not isinstance(v, Undefined),
    "undefined": lambda v: isinstance(v, Undefined),
    "none": lambda v: v is None,
    "string": lambda v: isinstance(v, str),
    "mapping": lambda v: isinstance(v, dict),
    "number": lambda v: isinstance(v, (int, float, complex)),
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "boolean": lambda v: v is True or v is False,
    "true": lambda v: v is True,
    "false": lambda v: v is False,
    "iterable": lambda v: hasattr(v, "__iter__"),
    "sequence": lambda v: hasattr(v, "__len__") and hasattr(v, "__getitem__"),
    "odd": lambda v: v % 2 == 1,
    "even": lambda v: v % 2 == 0,
}


def _raise_exception(message):
    raise TemplateError(message)


def _strftime_now(fmt: str) -> str:
    return datetime.datetime.now().strftime(fmt)


FUNCTIONS: Dict[str, Callable] = {
    "raise_exception": _raise_exception,
    "strftime_now": _strftime_now,
    "namespace": Namespace,
    "range": range,
}

# the methods a template may call, by the type they are called on
METHODS = {
    str: ("strip", "lstrip", "rstrip", "startswith", "endswith", "split",
          "lower", "upper", "replace"),
    dict: ("items", "keys", "values", "get"),
}
_METHOD_NAMES = {m for ms in METHODS.values() for m in ms} | {"cycle"}
_DICT_ATTRS = set(dir(dict))


def _getattr(obj, name: str):
    """Jinja's ``obj.name``: an attribute, else the item ``name``, else
    undefined; an undefined object raises."""
    if isinstance(obj, Undefined):
        obj._fail()
    if isinstance(obj, Namespace):
        return obj.attrs.get(name, Undefined(name))
    if isinstance(obj, _Loop):
        return obj.attr(name)
    if isinstance(obj, dict):
        if name in _DICT_ATTRS:
            return getattr(obj, name)
        return obj[name] if name in obj else Undefined(name)
    for typ, names in METHODS.items():
        if isinstance(obj, typ) and name in names:
            return getattr(obj, name)
    try:
        return obj[name]
    except (TypeError, LookupError):
        return Undefined(name)


def _getitem(obj, key):
    """Jinja's ``obj[key]``: the item, else for a string key the
    attribute, else undefined; an undefined object raises."""
    if isinstance(obj, Undefined):
        obj._fail()
    if isinstance(obj, Namespace) or isinstance(obj, _Loop):
        return _getattr(obj, key) if isinstance(key, str) else Undefined()
    try:
        return obj[key]
    except (TypeError, LookupError, AttributeError):
        if isinstance(key, str):
            return _getattr(obj, key) if not isinstance(obj, dict) \
                else Undefined(key)
        return Undefined(str(key))


def _call_method(obj, name: str, args, kwargs):
    if isinstance(obj, Undefined):
        obj._fail()
    if isinstance(obj, _Loop) and name == "cycle":
        return obj.cycle(*args)
    for typ, names in METHODS.items():
        if isinstance(obj, typ) and name in names:
            return getattr(obj, name)(*args, **kwargs)
    # Jinja would look the attribute up and call it: a key holding a
    # callable is not something a chat template stores
    raise TemplateError(f"{type(obj).__name__!r} object has no method "
                        f"{name!r}")


# ----------------------------------------------------------------- lexing

_NAME = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")
_NUMBER = re.compile(r"(\d(?:_?\d)*)(\.\d(?:_?\d)*)?([eE][+\-]?\d(?:_?\d)*)?")
_STRING = re.compile(r"('([^'\\]*(?:\\.[^'\\]*)*)'|\"([^\"\\]*(?:\\.[^\"\\]*)*)\")",
                     re.S)
_OPERATORS = sorted(["+", "-", "/", "//", "*", "%", "**", "~", "[", "]",
                     "(", ")", "{", "}", "==", "!=", ">", ">=", "<", "<=",
                     "=", ".", ":", "|", ",", ";"], key=len, reverse=True)
_ENDS = {"{{": "}}", "{%": "%}"}

Token = Tuple[str, Any]       # (kind, value); kinds: data, var, block,
#                               end, name, num, str, op


def _lex(source: str) -> List[Token]:
    """The template as Jinja's lexer sees it under ``trim_blocks`` and
    ``lstrip_blocks``: data between tags, and each tag's tokens."""
    src = "\n".join(source.splitlines())   # Jinja's newline normalization
    out: List[Token] = []
    i, n = 0, len(src)
    line_starting = True
    while i < n:
        starts = [j for j in (src.find(d, i) for d in ("{{", "{%", "{#"))
                  if j >= 0]
        j = min(starts) if starts else n
        text = src[i:j]
        if j == n:
            out.append(("data", text))
            break
        opener = src[j:j + 2]
        k = j + 2
        sign = src[k] if k < n and src[k] in "-+" else ""
        if sign == "-":
            text = text.rstrip()
        elif sign != "+" and opener != "{{":
            l_pos = text.rfind("\n") + 1
            if (l_pos > 0 or line_starting) and text[l_pos:] \
                    and not text[l_pos:].strip():
                text = text[:l_pos]
        if text:
            out.append(("data", text))
        k += len(sign)
        if opener == "{#":
            m = re.compile(r"(.*?)(\-#\}\s*|\+#\}|#\}\n?)", re.S).match(src, k)
            if m is None:
                raise TemplateSyntaxError("unterminated comment")
            i = m.end()
            line_starting = src[i - 1:i] == "\n"
            continue
        kind = "var" if opener == "{{" else "block"
        out.append((kind, None))
        i, line_starting = _lex_tag(src, k, _ENDS[opener], out)
    return out


def _lex_tag(src: str, i: int, end: str, out: List[Token]) -> Tuple[int, bool]:
    """Tokens of one tag from ``src[i]`` to its ``end`` delimiter; returns
    the position after it and whether that ends a line."""
    depth = 0
    n = len(src)
    while True:
        while i < n and src[i].isspace():
            i += 1
        if i >= n:
            raise TemplateSyntaxError(f"unexpected end of template, "
                                      f"expected {end!r}")
        if depth == 0:
            if src.startswith("-" + end, i):
                i += 1 + len(end)
                while i < n and src[i].isspace():
                    i += 1
                out.append(("end", None))
                return i, src[i - 1:i] == "\n"
            if src.startswith("+" + end, i):
                i += 1 + len(end)
                out.append(("end", None))
                return i, False
            if src.startswith(end, i):
                i += len(end)
                if end == "%}" and src[i:i + 1] == "\n":
                    i += 1           # trim_blocks
                out.append(("end", None))
                return i, src[i - 1:i] == "\n"
        m = _STRING.match(src, i)
        if m:
            raw = m.group()[1:-1]
            value = (raw.encode("ascii", "backslashreplace")
                     .decode("unicode-escape"))
            out.append(("str", value))
            i = m.end()
            continue
        m = _NUMBER.match(src, i)
        if m:
            text = m.group().replace("_", "")
            out.append(("num", float(text) if m.group(2) or m.group(3)
                        else int(text)))
            i = m.end()
            continue
        m = _NAME.match(src, i)
        if m:
            out.append(("name", m.group()))
            i = m.end()
            continue
        for op in _OPERATORS:
            if src.startswith(op, i):
                if op in "([{":
                    depth += 1
                elif op in ")]}":
                    depth -= 1
                out.append(("op", op))
                i += len(op)
                break
        else:
            raise TemplateSyntaxError(f"unexpected character {src[i]!r}")


# ---------------------------------------------------------------- parsing

_UNSUPPORTED_TAGS = ("macro", "call", "filter", "with", "include", "import",
                     "from", "extends", "block", "raw", "autoescape",
                     "generation", "do", "trans")
_COMPARE = {"==", "!=", "<", "<=", ">", ">="}


class _Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.pos = 0

    # -- token helpers
    def peek(self, k: int = 0) -> Token:
        p = self.pos + k
        return self.toks[p] if p < len(self.toks) else ("eof", None)

    def next(self) -> Token:
        t = self.peek()
        self.pos += 1
        return t

    def at(self, kind: str, value=None, k: int = 0) -> bool:
        t = self.peek(k)
        return t[0] == kind and (value is None or t[1] == value)

    def skip(self, kind: str, value=None) -> bool:
        if self.at(kind, value):
            self.pos += 1
            return True
        return False

    def expect(self, kind: str, value=None):
        t = self.next()
        if t[0] != kind or (value is not None and t[1] != value):
            want = value if value is not None else kind
            raise TemplateSyntaxError(f"expected {want!r}, got {t[1]!r}"
                                      if t[0] != "end" else
                                      f"expected {want!r} before the end "
                                      f"of the tag")
        return t[1]

    # -- statements
    def parse_body(self, end_tags: Tuple[str, ...]) -> Tuple[list, str]:
        """Nodes up to one of ``end_tags`` (consumed: returns its name and
        leaves its arguments to the caller)."""
        body: list = []
        while True:
            t = self.next()
            if t[0] == "eof":
                if end_tags:
                    raise TemplateSyntaxError(
                        f"unexpected end of template, expected one of "
                        f"{end_tags}")
                return body, ""
            if t[0] == "data":
                body.append(("data", t[1]))
            elif t[0] == "var":
                body.append(("out", self.parse_tuple()))
                self.expect("end")
            elif t[0] == "block":
                name = self.expect("name")
                if name in end_tags:
                    return body, name
                body.append(self.parse_statement(name))
            else:
                raise TemplateSyntaxError(f"unexpected token {t[1]!r}")

    def parse_statement(self, name: str):
        if name == "if":
            return self.parse_if()
        if name == "for":
            return self.parse_for()
        if name == "set":
            return self.parse_set()
        if name in ("break", "continue"):
            self.expect("end")
            return (name,)
        if name in _UNSUPPORTED_TAGS:
            raise TemplateSyntaxError(f"unsupported tag {name!r}")
        raise TemplateSyntaxError(f"unknown tag {name!r}")

    def parse_if(self):
        branches = []
        cond = self.parse_tuple(with_condexpr=False)
        self.expect("end")
        while True:
            body, tag = self.parse_body(("elif", "else", "endif"))
            branches.append((cond, body))
            if tag == "elif":
                cond = self.parse_tuple(with_condexpr=False)
                self.expect("end")
                continue
            self.expect("end")
            if tag == "else":
                body, _ = self.parse_body(("endif",))
                self.expect("end")
                return ("if", branches, body)
            return ("if", branches, [])

    def parse_target(self):
        names = [self.expect("name")]
        while self.skip("op", ","):
            names.append(self.expect("name"))
        return names[0] if len(names) == 1 else tuple(names)

    def parse_for(self):
        target = self.parse_target()
        self.expect("name", "in")
        it = self.parse_tuple(with_condexpr=False)
        cond = None
        if self.skip("name", "if"):
            cond = self.parse_expression()
        if self.at("name", "recursive"):
            raise TemplateSyntaxError("unsupported loop modifier "
                                      "'recursive'")
        self.expect("end")
        body, tag = self.parse_body(("else", "endfor"))
        self.expect("end")
        else_body = []
        if tag == "else":
            else_body, _ = self.parse_body(("endfor",))
            self.expect("end")
        return ("for", target, it, cond, body, else_body)

    def parse_set(self):
        if self.at("name") and self.at("op", ".", 1):
            ns = self.expect("name")
            self.next()
            target = ("attr", ns, self.expect("name"))
        else:
            target = self.parse_target()
        if not self.skip("op", "="):
            raise TemplateSyntaxError("unsupported construct: a block "
                                      "'set'")
        value = self.parse_tuple()
        self.expect("end")
        return ("set", target, value)

    # -- expressions
    def parse_tuple(self, with_condexpr: bool = True):
        parse = self.parse_expression if with_condexpr else self.parse_or
        items = [parse()]
        is_tuple = False
        while self.skip("op", ","):
            is_tuple = True
            if self.at("end") or self.at("op", ")"):
                break
            items.append(parse())
        return ("tuple", items) if is_tuple else items[0]

    def parse_expression(self):
        expr = self.parse_or()
        while self.skip("name", "if"):
            cond = self.parse_or()
            other = self.parse_expression() if self.skip("name", "else") \
                else None
            expr = ("cond", cond, expr, other)
        return expr

    def parse_or(self):
        left = self.parse_and()
        while self.skip("name", "or"):
            left = ("or", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.skip("name", "and"):
            left = ("and", left, self.parse_not())
        return left

    def parse_not(self):
        if self.skip("name", "not"):
            return ("not", self.parse_not())
        return self.parse_compare()

    def parse_compare(self):
        expr = self.parse_math1()
        ops = []
        while True:
            if self.peek()[0] == "op" and self.peek()[1] in _COMPARE:
                ops.append((self.next()[1], self.parse_math1()))
            elif self.skip("name", "in"):
                ops.append(("in", self.parse_math1()))
            elif self.at("name", "not") and self.at("name", "in", 1):
                self.pos += 2
                ops.append(("notin", self.parse_math1()))
            else:
                break
        return ("compare", expr, ops) if ops else expr

    def parse_math1(self):
        left = self.parse_concat()
        while self.peek() in (("op", "+"), ("op", "-")):
            op = self.next()[1]
            left = ("bin", op, left, self.parse_concat())
        return left

    def parse_concat(self):
        items = [self.parse_math2()]
        while self.skip("op", "~"):
            items.append(self.parse_math2())
        return items[0] if len(items) == 1 else ("concat", items)

    def parse_math2(self):
        left = self.parse_pow()
        while self.peek()[0] == "op" and self.peek()[1] in ("*", "/", "//",
                                                            "%"):
            op = self.next()[1]
            left = ("bin", op, left, self.parse_pow())
        return left

    def parse_pow(self):
        left = self.parse_unary()
        while self.skip("op", "**"):
            left = ("bin", "**", left, self.parse_unary())
        return left

    def parse_unary(self, with_filter: bool = True):
        if self.skip("op", "-"):
            node = ("neg", self.parse_unary(False))
        elif self.skip("op", "+"):
            node = ("pos", self.parse_unary(False))
        else:
            node = self.parse_primary()
        node = self.parse_postfix(node)
        if with_filter:
            node = self.parse_filter_expr(node)
        return node

    def parse_primary(self):
        kind, value = self.next()
        if kind == "name":
            if value in ("true", "True"):
                return ("const", True)
            if value in ("false", "False"):
                return ("const", False)
            if value in ("none", "None"):
                return ("const", None)
            return ("name", value)
        if kind == "str":
            while self.at("str"):          # adjacent literals concatenate
                value += self.next()[1]
            return ("const", value)
        if kind == "num":
            return ("const", value)
        if (kind, value) == ("op", "("):
            if self.skip("op", ")"):
                return ("tuple", [])
            node = self.parse_tuple()
            self.expect("op", ")")
            return node
        if (kind, value) == ("op", "["):
            items = []
            while not self.skip("op", "]"):
                if items:
                    self.expect("op", ",")
                    if self.skip("op", "]"):
                        break
                items.append(self.parse_expression())
            return ("list", items)
        if (kind, value) == ("op", "{"):
            pairs = []
            while not self.skip("op", "}"):
                if pairs:
                    self.expect("op", ",")
                    if self.skip("op", "}"):
                        break
                k = self.parse_expression()
                self.expect("op", ":")
                pairs.append((k, self.parse_expression()))
            return ("dict", pairs)
        raise TemplateSyntaxError(f"unexpected {value!r}")

    def parse_postfix(self, node):
        while True:
            if self.skip("op", "."):
                t = self.next()
                if t[0] == "name":
                    node = ("getattr", node, t[1])
                elif t[0] == "num" and isinstance(t[1], int):
                    node = ("getitem", node, ("const", t[1]))
                else:
                    raise TemplateSyntaxError(f"unexpected {t[1]!r} after "
                                              f"'.'")
            elif self.skip("op", "["):
                node = ("getitem", node, self.parse_subscript())
                self.expect("op", "]")
            elif self.at("op", "("):
                node = self.parse_call(node)
            else:
                return node

    def parse_subscript(self):
        parts: List[Any] = [None]
        while True:
            if self.at("op", ":"):
                self.next()
                parts.append(None)
                if len(parts) > 3:
                    raise TemplateSyntaxError("bad slice")
            elif self.at("op", "]"):
                break
            else:
                if parts[-1] is not None:
                    raise TemplateSyntaxError("bad subscript")
                parts[-1] = self.parse_expression()
        if len(parts) == 1:
            return parts[0]
        return ("slice", parts + [None] * (3 - len(parts)))

    def parse_args(self):
        self.expect("op", "(")
        args, kwargs = [], []
        while not self.skip("op", ")"):
            if args or kwargs:
                self.expect("op", ",")
                if self.skip("op", ")"):
                    break
            if self.at("name") and self.at("op", "=", 1):
                key = self.next()[1]
                self.next()
                kwargs.append((key, self.parse_expression()))
            else:
                args.append(self.parse_expression())
        return args, kwargs

    def parse_call(self, node):
        if node[0] == "name":
            if node[1] not in FUNCTIONS:
                raise TemplateSyntaxError(f"unsupported function "
                                          f"{node[1]!r}")
        elif node[0] == "getattr":
            if node[2] not in _METHOD_NAMES:
                raise TemplateSyntaxError(f"unsupported method "
                                          f"{node[2]!r}")
        else:
            raise TemplateSyntaxError("unsupported call")
        args, kwargs = self.parse_args()
        return ("call", node, args, kwargs)

    def parse_filter_expr(self, node):
        while True:
            if self.skip("op", "|"):
                name = self.expect("name")
                if name not in FILTERS:
                    raise TemplateSyntaxError(f"unsupported filter {name!r}")
                args, kwargs = (self.parse_args() if self.at("op", "(")
                                else ([], []))
                node = ("filter", name, node, args, kwargs)
            elif self.skip("name", "is"):
                negate = self.skip("name", "not")
                name = self.expect("name")
                if name not in TESTS:
                    raise TemplateSyntaxError(f"unsupported test {name!r}")
                node = ("test", name, node, negate)
            else:
                return node


# ------------------------------------------------------------- evaluating


class _Scope:
    __slots__ = ("vars", "parent")

    def __init__(self, parent: Optional["_Scope"], vars=None):
        self.vars = dict(vars or {})
        self.parent = parent

    def lookup(self, name: str):
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return FUNCTIONS.get(name, Undefined(name))


_BIN: Dict[str, Callable] = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "//": lambda a, b: a // b, "%": lambda a, b: a % b,
    "**": lambda a, b: a ** b,
}
_CMP: Dict[str, Callable] = {
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "in": lambda a, b: a in b, "notin": lambda a, b: a not in b,
}


def _eval(node, scope: _Scope):
    kind = node[0]
    if kind == "const":
        return node[1]
    if kind == "name":
        return scope.lookup(node[1])
    if kind == "getattr":
        return _getattr(_eval(node[1], scope), node[2])
    if kind == "getitem":
        obj = _eval(node[1], scope)
        key = node[2]
        if key[0] == "slice":
            if isinstance(obj, Undefined):
                obj._fail()
            return obj[slice(*(None if p is None else _eval(p, scope)
                               for p in key[1]))]
        return _getitem(obj, _eval(key, scope))
    if kind == "filter":
        _, name, arg, args, kwargs = node
        return FILTERS[name](_eval(arg, scope),
                             *[_eval(a, scope) for a in args],
                             **{k: _eval(v, scope) for k, v in kwargs})
    if kind == "test":
        _, name, arg, negate = node
        return TESTS[name](_eval(arg, scope)) != negate
    if kind == "call":
        _, fn, args, kwargs = node
        a = [_eval(x, scope) for x in args]
        kw = {k: _eval(v, scope) for k, v in kwargs}
        if fn[0] == "getattr":
            return _call_method(_eval(fn[1], scope), fn[2], a, kw)
        f = scope.lookup(fn[1])
        if isinstance(f, Undefined):
            f._fail()
        return f(*a, **kw)
    if kind == "bin":
        a, b = _eval(node[2], scope), _eval(node[3], scope)
        if isinstance(a, Undefined):
            a._fail()
        if isinstance(b, Undefined):
            b._fail()
        return _BIN[node[1]](a, b)
    if kind == "concat":
        return "".join(str(_eval(x, scope)) for x in node[1])
    if kind == "compare":
        left = _eval(node[1], scope)
        for op, expr in node[2]:
            right = _eval(expr, scope)
            if not _CMP[op](left, right):
                return False
            left = right
        return True
    if kind == "and":
        left = _eval(node[1], scope)
        return _eval(node[2], scope) if left else left
    if kind == "or":
        left = _eval(node[1], scope)
        return left if left else _eval(node[2], scope)
    if kind == "not":
        return not _eval(node[1], scope)
    if kind == "neg":
        return -_eval(node[1], scope)
    if kind == "pos":
        return +_eval(node[1], scope)
    if kind == "cond":
        if _eval(node[1], scope):
            return _eval(node[2], scope)
        if node[3] is None:
            return Undefined("the inline if-expression's else")
        return _eval(node[3], scope)
    if kind == "list":
        return [_eval(x, scope) for x in node[1]]
    if kind == "tuple":
        return tuple(_eval(x, scope) for x in node[1])
    if kind == "dict":
        return {_eval(k, scope): _eval(v, scope) for k, v in node[1]}
    raise TemplateError(f"unknown node {kind!r}")


def _assign(target, value, vars: dict) -> None:
    if isinstance(target, tuple):
        values = list(value)
        if len(values) != len(target):
            raise TemplateError(f"cannot unpack {len(values)} values into "
                                f"{len(target)} names")
        for t, v in zip(target, values):
            vars[t] = v
    else:
        vars[target] = value


def _render(body: list, scope: _Scope, out: List[str]) -> None:
    for node in body:
        kind = node[0]
        if kind == "data":
            out.append(node[1])
        elif kind == "out":
            out.append(str(_eval(node[1], scope)))
        elif kind == "if":
            for cond, branch in node[1]:
                if _eval(cond, scope):
                    _render(branch, scope, out)
                    break
            else:
                _render(node[2], scope, out)
        elif kind == "for":
            _render_for(node, scope, out)
        elif kind == "set":
            target, value = node[1], _eval(node[2], scope)
            if isinstance(target, tuple) and target[:1] == ("attr",):
                ns = scope.lookup(target[1])
                if not isinstance(ns, Namespace):
                    raise TemplateError("cannot assign attribute on "
                                        "non-namespace object")
                ns.attrs[target[2]] = value
            else:
                _assign(target, value, scope.vars)
        elif kind == "break":
            raise _Break()
        elif kind == "continue":
            raise _Continue()


def _render_for(node, scope: _Scope, out: List[str]) -> None:
    _, target, it, cond, body, else_body = node
    items = list(_eval(it, scope))
    if cond is not None:
        kept = []
        for item in items:
            probe = _Scope(scope)
            _assign(target, item, probe.vars)
            if _eval(cond, probe):
                kept.append(item)
        items = kept
    loop = _Loop(items)
    for i, item in enumerate(items):
        loop.index0 = i
        # every iteration is a scope of its own: a set inside it is gone
        # at the next iteration and after the loop
        inner = _Scope(scope, {"loop": loop})
        _assign(target, item, inner.vars)
        try:
            _render(body, inner, out)
        except _Continue:
            continue
        except _Break:
            break
    if not items:
        _render(else_body, scope, out)


class ChatTemplate:
    """A parsed template; ``render(**context)`` gives its text."""

    def __init__(self, source: str):
        self._body, _ = _Parser(_lex(source)).parse_body(())

    def render(self, **context) -> str:
        out: List[str] = []
        try:
            _render(self._body, _Scope(None, context), out)
        except (_Break, _Continue):
            raise TemplateError("'break' or 'continue' outside a loop") \
                from None
        return "".join(out)
