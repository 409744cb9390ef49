"""Name sanitization for discovery keys and bus subjects (a copy of
``dynamo_tpu.runtime.slug``).

Reference: lib/runtime/src/slug.rs:25-163 — canonical slugging so user
strings can't produce invalid NATS subjects / etcd keys (the reference's
component.rs:323-339 carries a TODO for char validation; the slug type is
its answer). Our subjects use ``|``/``.``/``-``/``:`` as structure
characters, so component parts must never contain them.
"""

from __future__ import annotations

import re

__all__ = ["slugify", "validate_name"]

_VALID = re.compile(r"^[A-Za-z0-9_-]+$")
_INVALID_CHARS = re.compile(r"[^A-Za-z0-9_-]+")


def slugify(text: str) -> str:
    """Canonical slug: lowercase, invalid runs → single ``-``, trimmed.
    ``slugify("Hello World/v2") == "hello-world-v2"``."""
    out = _INVALID_CHARS.sub("-", text.strip().lower()).strip("-")
    return out or "x"


def validate_name(name: str, what: str = "name") -> str:
    """Reject names that would corrupt subjects/keys instead of silently
    rewriting them (explicit beats implicit for addressing)."""
    if not _VALID.match(name or ""):
        raise ValueError(
            f"invalid {what} {name!r}: use [A-Za-z0-9_-] only "
            f"(try slugify() → {slugify(name or '')!r})")
    return name
