"""Two-part wire codec + control messages for the response plane.

A copy of ``dynamo_tpu.runtime.codec``: the analog of the reference's length-prefixed two-part framing
(lib/runtime/src/pipeline/network/codec/two_part.rs) and the control
messages that ride the response TCP stream
(lib/runtime/src/pipeline/network.rs: ``ControlMessage::{Stop, Kill,
Sentinel}``, ``ResponseStreamPrologue``).

Frame layout (all integers big-endian u32):

    [kind u8][header_len u32][data_len u32][header bytes][data bytes]

``kind`` distinguishes data frames from control frames so a reader never has
to sniff payload bytes. Headers and control payloads are JSON (small, rare);
data payloads are opaque bytes chosen by the layer above (JSON today,
msgpack-able later without touching this file).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import struct
from enum import IntEnum
from typing import Optional, Tuple

__all__ = [
    "FrameKind",
    "Frame",
    "ControlMessage",
    "Prologue",
    "RequestControlMessage",
    "ConnectionInfo",
    "write_frame",
    "read_frame",
    "encode_two_part",
    "decode_two_part",
]

_HDR = struct.Struct(">BII")
MAX_FRAME = 256 * 1024 * 1024  # defensive bound, not a protocol limit


class FrameKind(IntEnum):
    DATA = 0        # one response item
    PROLOGUE = 1    # first frame on a response stream
    SENTINEL = 2    # end of stream (clean)
    STOP = 3        # receiver → sender: graceful stop_generating
    KILL = 4        # receiver → sender: hard kill
    ERROR = 5       # stream aborted with error (header carries message)


@dataclasses.dataclass
class Frame:
    kind: FrameKind
    header: bytes = b""
    data: bytes = b""

    def header_json(self) -> dict:
        return json.loads(self.header) if self.header else {}


@dataclasses.dataclass
class Prologue:
    """First frame a worker sends on the response stream; carries early
    errors (e.g. request deserialization failed) before any data flows.
    Reference: ``ResponseStreamPrologue`` (network.rs)."""

    error: Optional[str] = None

    def to_frame(self) -> Frame:
        return Frame(FrameKind.PROLOGUE,
                     json.dumps(dataclasses.asdict(self)).encode())

    @classmethod
    def from_frame(cls, f: Frame) -> "Prologue":
        return cls(**f.header_json())


class ControlMessage:
    """Constructors for receiver→sender control frames."""

    @staticmethod
    def stop() -> Frame:
        return Frame(FrameKind.STOP)

    @staticmethod
    def kill() -> Frame:
        return Frame(FrameKind.KILL)

    @staticmethod
    def sentinel() -> Frame:
        return Frame(FrameKind.SENTINEL)


@dataclasses.dataclass
class ConnectionInfo:
    """Where the worker should dial back to stream responses.
    Reference: ``ConnectionInfo`` in network/tcp/client.rs."""

    address: str          # "host:port"
    stream_id: str        # registered subject on the caller's stream server

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ConnectionInfo":
        return cls(address=d["address"], stream_id=d["stream_id"])


@dataclasses.dataclass
class RequestControlMessage:
    """Header half of a request two-part message.
    Reference: ``RequestControlMessage{id, request_type, response_type,
    connection_info}`` (network/egress/push.rs).

    ``trace`` is the optional distributed-tracing propagation record
    ``{trace_id, parent_span, origin_ts}`` of the JAX package's tracer.
    The port has no tracer yet (ROADMAP A10): it sends none and ignores
    a received one, and the field stays so that the frames cross between
    the packages both ways.

    ``deadline_ms`` is the request's REMAINING end-to-end budget at
    send time (runtime/engine.py EngineContext deadline): the serving
    side re-anchors it against its own monotonic clock, so the deadline
    survives hops without clock synchronization. A worker whose budget
    runs out cancels the request engine-side (slot/hold release within
    one loop tick) even if the client vanished without a KILL frame.
    Absent = no deadline; ignored by old receivers.

    ``tenant`` / ``priority`` are the multi-tenant identity
    (llm/tenancy.py): the serving side re-attaches them to its
    EngineContext so fair-share admission and per-tenant KV quotas
    price the request without re-parsing the payload. Absent = the
    implicit single tenant; ignored by old receivers."""

    id: str
    request_type: str = "single_in"     # single_in | many_in
    response_type: str = "many_out"
    connection_info: Optional[ConnectionInfo] = None
    trace: Optional[dict] = None
    deadline_ms: Optional[float] = None
    tenant: Optional[str] = None
    priority: Optional[str] = None

    def to_json(self) -> bytes:
        d = {"id": self.id, "request_type": self.request_type,
             "response_type": self.response_type}
        if self.connection_info is not None:
            d["connection_info"] = self.connection_info.to_dict()
        if self.trace is not None:
            d["trace"] = self.trace
        if self.deadline_ms is not None:
            d["deadline_ms"] = self.deadline_ms
        if self.tenant is not None:
            d["tenant"] = self.tenant
        if self.priority is not None:
            d["priority"] = self.priority
        return json.dumps(d).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "RequestControlMessage":
        d = json.loads(raw)
        ci = d.get("connection_info")
        return cls(id=d["id"],
                   request_type=d.get("request_type", "single_in"),
                   response_type=d.get("response_type", "many_out"),
                   connection_info=ConnectionInfo.from_dict(ci) if ci else None,
                   trace=d.get("trace"),
                   deadline_ms=d.get("deadline_ms"),
                   tenant=d.get("tenant"),
                   priority=d.get("priority"))


# ----------------------------------------------------------------- framing

def encode_frame(f: Frame) -> bytes:
    return _HDR.pack(int(f.kind), len(f.header), len(f.data)) + f.header + f.data


async def write_frame(writer: asyncio.StreamWriter, f: Frame) -> None:
    writer.write(encode_frame(f))
    await writer.drain()


async def read_frame(reader: asyncio.StreamReader) -> Optional[Frame]:
    """Read one frame; returns None on clean EOF at a frame boundary."""
    try:
        hdr = await reader.readexactly(_HDR.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    kind, hlen, dlen = _HDR.unpack(hdr)
    if hlen > MAX_FRAME or dlen > MAX_FRAME:
        raise ValueError(f"frame too large: header={hlen} data={dlen}")
    header = await reader.readexactly(hlen) if hlen else b""
    data = await reader.readexactly(dlen) if dlen else b""
    return Frame(FrameKind(kind), header, data)


# ------------------------------------------------- request two-part message

def encode_two_part(ctrl: RequestControlMessage, payload: bytes) -> bytes:
    """Request envelope pushed over the message bus: same [hlen][dlen] shape
    as stream frames but without the kind byte (requests are always data)."""
    h = ctrl.to_json()
    return struct.pack(">II", len(h), len(payload)) + h + payload


def decode_two_part(raw: bytes) -> Tuple[RequestControlMessage, bytes]:
    hlen, dlen = struct.unpack_from(">II", raw, 0)
    off = 8
    ctrl = RequestControlMessage.from_json(raw[off:off + hlen])
    payload = raw[off + hlen:off + hlen + dlen]
    return ctrl, payload
