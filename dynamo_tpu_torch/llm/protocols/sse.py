"""Server-Sent Events encoder for the HTTP front end, with the reference
codec's framing (lib/llm/src/protocols/codec.rs): multi-line `data:` fields
are split over several `data:` lines, comments (`:` lines) ride
out-of-band, and `data: [DONE]` ends a stream.
"""

from __future__ import annotations

import json
from typing import List, Optional

from .annotated import Annotated

DONE_SENTINEL = "[DONE]"


def encode_event(data: Optional[str] = None, event: Optional[str] = None,
                 id: Optional[str] = None, comments: Optional[List[str]] = None) -> str:
    """Encode one SSE event block (trailing blank line included)."""
    lines: List[str] = []
    for c in comments or []:
        for part in c.split("\n"):
            lines.append(f": {part}")
    if event is not None:
        lines.append(f"event: {event}")
    if id is not None:
        lines.append(f"id: {id}")
    if data is not None:
        for part in data.split("\n"):
            lines.append(f"data: {part}")
    return "\n".join(lines) + "\n\n"


def encode_annotated(ann: Annotated, data_encoder=json.dumps) -> str:
    data = None if ann.data is None else data_encoder(ann.data)
    return encode_event(data=data, event=ann.event, id=ann.id, comments=ann.comment)


def encode_done() -> str:
    return encode_event(data=DONE_SENTINEL)
