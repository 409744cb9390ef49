"""SSE-shaped stream element carrying data, errors and annotations out-of-band.

Reference: ``Annotated<R>`` (lib/runtime/src/protocols/annotated.rs:32-150).
Every response stream in the framework is a stream of ``Annotated`` items so
that errors and metadata (e.g. the preprocessor's ``token_ids`` annotation)
ride the same channel as data without corrupting the payload type.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Generic, List, Optional, TypeVar

R = TypeVar("R")

ERROR_EVENT = "error"


@dataclasses.dataclass
class Annotated(Generic[R]):
    data: Optional[R] = None
    id: Optional[str] = None
    event: Optional[str] = None
    comment: Optional[List[str]] = None

    @classmethod
    def from_data(cls, data: R) -> "Annotated[R]":
        return cls(data=data)

    @classmethod
    def from_error(cls, message: str) -> "Annotated[R]":
        return cls(event=ERROR_EVENT, comment=[message])

    @classmethod
    def from_annotation(cls, event: str, value: Any) -> "Annotated[R]":
        return cls(event=event, comment=[json.dumps(value)])

    @property
    def is_error(self) -> bool:
        return self.event == ERROR_EVENT

    def error_message(self) -> Optional[str]:
        if not self.is_error:
            return None
        return "; ".join(self.comment or ["unknown error"])

    def map_data(self, fn) -> "Annotated":
        if self.data is None:
            return Annotated(None, self.id, self.event, self.comment)
        return Annotated(fn(self.data), self.id, self.event, self.comment)

    def to_json_dict(self, data_encoder=None) -> dict:
        out: dict = {}
        if self.data is not None:
            out["data"] = data_encoder(self.data) if data_encoder else self.data
        if self.id is not None:
            out["id"] = self.id
        if self.event is not None:
            out["event"] = self.event
        if self.comment:
            out["comment"] = self.comment
        return out


# Wire serde for the distributed response plane: workers stream
# Annotated[dict] items; the frontend client reconstructs them so errors
# and annotations survive the hop (the reference streams the same
# Annotated JSON over its TCP response plane).

def encode_annotated_json(item) -> bytes:
    if not isinstance(item, Annotated):
        item = Annotated.from_data(item)
    enc = (dataclasses.asdict
           if dataclasses.is_dataclass(item.data) else None)
    return json.dumps(item.to_json_dict(data_encoder=enc)).encode()


def decode_annotated_json(raw: bytes) -> "Annotated":
    d = json.loads(raw)
    return Annotated(data=d.get("data"), id=d.get("id"),
                     event=d.get("event"), comment=d.get("comment"))
