"""Server-Sent Events codec (a copy of ``dynamo_tpu.llm.protocols.sse``),
with the reference codec's edge-case semantics
(lib/llm/src/protocols/codec.rs:52-754, lib/llm/tests/aggregators.rs:32-113):
multi-line `data:` fields are split over several `data:` lines and joined
again with newlines, comment lines (leading `:`) ride out-of-band,
`[DONE]` ends a stream, and invalid JSON in a data field surfaces as an
error event rather than a crash.
"""

from __future__ import annotations

import dataclasses
import json
from typing import AsyncIterator, Iterator, List, Optional

from .annotated import Annotated

DONE_SENTINEL = "[DONE]"


@dataclasses.dataclass
class SseEvent:
    data: Optional[str] = None
    event: Optional[str] = None
    id: Optional[str] = None
    comments: List[str] = dataclasses.field(default_factory=list)

    @property
    def is_done(self) -> bool:
        return self.data is not None and self.data.strip() == DONE_SENTINEL


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


class SseParser:
    """Incremental line-oriented SSE parser (push text in, pull events out)."""

    def __init__(self) -> None:
        self._buf = ""
        self._cur = SseEvent()
        self._data_lines: List[str] = []

    def push(self, text: str) -> Iterator[SseEvent]:
        self._buf += text
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            ev = self._push_line(line.rstrip("\r"))
            if ev is not None:
                yield ev

    def _push_line(self, line: str) -> Optional[SseEvent]:
        if line == "":
            if (self._data_lines or self._cur.event or self._cur.id
                    or self._cur.comments):
                ev = self._cur
                ev.data = "\n".join(self._data_lines) if self._data_lines else None
                self._cur = SseEvent()
                self._data_lines = []
                return ev
            return None
        if line.startswith(":"):
            self._cur.comments.append(line[1:].lstrip(" "))
            return None
        if ":" in line:
            field, value = line.split(":", 1)
            value = value.lstrip(" ")
        else:
            field, value = line, ""
        if field == "data":
            self._data_lines.append(value)
        elif field == "event":
            self._cur.event = value
        elif field == "id":
            self._cur.id = value
        # unknown fields are ignored per the SSE spec
        return None

    def finish(self) -> Optional[SseEvent]:
        """Flush a trailing event not terminated by a blank line (the final
        line itself may also lack its newline, so push two)."""
        for ev in self.push("\n\n"):
            return ev
        return None


def event_to_annotated(ev: SseEvent) -> Annotated[dict]:
    """Decode a parsed SSE event into Annotated[dict]; malformed JSON becomes
    an error element (reference codec behavior, not an exception)."""
    if ev.is_done:
        return Annotated(event="done")
    ann: Annotated[dict] = Annotated(id=ev.id, event=ev.event,
                                     comment=ev.comments or None)
    if ev.data is not None:
        try:
            ann.data = json.loads(ev.data)
        except json.JSONDecodeError as e:
            return Annotated.from_error(f"invalid JSON in SSE data: {e}")
    return ann


async def parse_sse_stream(chunks: AsyncIterator[bytes]) -> AsyncIterator[Annotated[dict]]:
    """Parse an async byte stream into Annotated dicts; stops at [DONE].
    UTF-8 is decoded incrementally so multi-byte characters split across
    network chunks survive."""
    import codecs
    decoder = codecs.getincrementaldecoder("utf-8")(errors="replace")
    parser = SseParser()
    async for chunk in chunks:
        for ev in parser.push(decoder.decode(chunk)):
            if ev.is_done:
                return
            yield event_to_annotated(ev)
    tail_text = decoder.decode(b"", final=True)
    if tail_text:
        for ev in parser.push(tail_text):
            if ev.is_done:
                return
            yield event_to_annotated(ev)
    tail = parser.finish()
    if tail is not None and not tail.is_done:
        yield event_to_annotated(tail)
