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
