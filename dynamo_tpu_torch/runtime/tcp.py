"""Response-plane TCP transport (a copy of ``dynamo_tpu.runtime.tcp``):
callers run a stream server; workers dial back and stream response frames,
through the C++ data-plane sender (``native_tcp``) unless
``DYN_NATIVE_DATAPLANE=0`` asks for the asyncio sender below.

Reference: lib/runtime/src/pipeline/network/tcp/{server,client}.rs — the
request travels over the message bus, but the response is a raw TCP stream
from worker to caller (``TcpStreamServer`` + ``StreamSender/StreamReceiver``),
so large token streams never transit the bus. The socket is bidirectional:
the caller can push ``STOP``/``KILL`` control frames upstream mid-stream
(network.rs ``ControlMessage``), which is how HTTP client disconnects reach
the engine's step loop.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import socket
import uuid
from typing import Callable, Dict, Optional

from .codec import Frame, FrameKind, Prologue, read_frame, write_frame
from .codec import ConnectionInfo

logger = logging.getLogger("dynamo_tpu_torch.runtime.tcp")

__all__ = ["TcpStreamServer", "StreamReceiver", "StreamSender",
           "open_stream_sender"]


async def open_stream_sender(info: "ConnectionInfo",
                             error: Optional[str] = None,
                             timeout: float = 10.0):
    """Sender factory: the C++ data-plane sender (``native_tcp``,
    ``csrc/host/data_plane.cpp``) unless ``DYN_NATIVE_DATAPLANE=0``, else
    the asyncio StreamSender below; both write the same frames. The JAX
    package falls back to the asyncio sender when its library does not
    load; here a library that does not build or load raises."""
    if os.environ.get("DYN_NATIVE_DATAPLANE", "1") != "0":
        from .native_tcp import NativeStreamSender
        return await NativeStreamSender.connect(info, error=error,
                                                timeout=timeout)
    return await StreamSender.connect(info, error=error, timeout=timeout)


class StreamReceiver:
    """Caller-side handle for one registered response stream."""

    def __init__(self, stream_id: str):
        self.stream_id = stream_id
        self.frames: asyncio.Queue = asyncio.Queue()
        self._writer: Optional[asyncio.StreamWriter] = None
        self._connected = asyncio.Event()
        self.prologue: Optional[Prologue] = None

    async def wait_connected(self, timeout: float = 30.0) -> Prologue:
        """Await the worker's dial-back + prologue frame."""
        await asyncio.wait_for(self._connected.wait(), timeout)
        assert self.prologue is not None
        return self.prologue

    async def next_frame(self, timeout: Optional[float] = None) -> Optional[Frame]:
        if timeout is None:
            return await self.frames.get()
        try:
            return await asyncio.wait_for(self.frames.get(), timeout)
        except asyncio.TimeoutError:
            return None

    async def send_control(self, frame: Frame) -> None:
        """Push STOP/KILL upstream to the sender."""
        if self._writer is not None and not self._writer.is_closing():
            try:
                await write_frame(self._writer, frame)
            except (ConnectionError, OSError):
                pass

    def close(self) -> None:
        if self._writer is not None and not self._writer.is_closing():
            self._writer.close()


class TcpStreamServer:
    """One per process (lazily started, like the reference's
    distributed.rs:110-120 lazy TCP server). Workers dial in, identify the
    stream via the prologue header, and frames flow to the registered
    receiver's queue."""

    def __init__(self, host: str = "127.0.0.1", advertise: Optional[str] = None):
        self.host = host
        self.advertise = advertise
        self._server: Optional[asyncio.base_events.Server] = None
        self._pending: Dict[str, StreamReceiver] = {}
        self.port: Optional[int] = None

    async def start(self) -> None:
        if self._server is not None:
            return
        self._server = await asyncio.start_server(
            self._on_connection, self.host, 0,
            family=socket.AF_INET)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.debug("tcp stream server listening on %s:%d", self.host, self.port)

    @property
    def address(self) -> str:
        return f"{self.advertise or self.host}:{self.port}"

    def register(self, stream_id: Optional[str] = None) -> StreamReceiver:
        sid = stream_id or uuid.uuid4().hex
        rx = StreamReceiver(sid)
        self._pending[sid] = rx
        return rx

    def unregister(self, stream_id: str) -> None:
        self._pending.pop(stream_id, None)

    def connection_info(self, rx: StreamReceiver) -> ConnectionInfo:
        return ConnectionInfo(address=self.address, stream_id=rx.stream_id)

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        first = await read_frame(reader)
        if first is None or first.kind != FrameKind.PROLOGUE:
            writer.close()
            return
        hdr = first.header_json()
        sid = hdr.get("stream_id", "")
        rx = self._pending.pop(sid, None)
        if rx is None:
            logger.warning("dial-back for unknown stream %s", sid)
            writer.close()
            return
        rx._writer = writer
        rx.prologue = Prologue(error=hdr.get("error"))
        rx._connected.set()
        try:
            while True:
                try:
                    f = await read_frame(reader)
                except Exception as e:  # malformed/oversized frame
                    logger.warning("stream %s read failed: %s", sid, e)
                    rx.frames.put_nowait(Frame(
                        FrameKind.ERROR,
                        json.dumps({"error": f"stream read failed: {e}"})
                        .encode()))
                    return
                if f is None:
                    rx.frames.put_nowait(Frame(FrameKind.ERROR,
                                               b'{"error": "connection lost"}'))
                    return
                rx.frames.put_nowait(f)
                if f.kind in (FrameKind.SENTINEL, FrameKind.ERROR):
                    return
        finally:
            if not writer.is_closing():
                writer.close()

    async def close(self) -> None:
        # claim before the await (DL008): double-close waits on a dead
        # server instead of racing the teardown
        server, self._server = self._server, None
        if server is not None:
            server.close()
            await server.wait_closed()


class StreamSender:
    """Worker-side handle: dial the caller, send prologue, stream frames,
    watch for upstream control frames."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self._reader = reader
        self._writer = writer
        self._control_task: Optional[asyncio.Task] = None
        self.on_stop: Optional[Callable[[], None]] = None
        self.on_kill: Optional[Callable[[], None]] = None
        self.killed = False

    @classmethod
    async def connect(cls, info: ConnectionInfo, error: Optional[str] = None,
                      timeout: float = 10.0) -> "StreamSender":
        host, port = info.address.rsplit(":", 1)
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, int(port)), timeout)
        sender = cls(reader, writer)
        hdr = {"stream_id": info.stream_id, "error": error}
        await write_frame(writer, Frame(FrameKind.PROLOGUE,
                                        json.dumps(hdr).encode()))
        sender._control_task = asyncio.get_running_loop().create_task(
            sender._watch_control(), name=f"stream-ctl-{info.stream_id[:8]}")
        return sender

    async def _watch_control(self) -> None:
        try:
            while True:
                f = await read_frame(self._reader)
                if f is None:
                    return
                if f.kind == FrameKind.STOP and self.on_stop is not None:
                    self.on_stop()
                elif f.kind == FrameKind.KILL:
                    self.killed = True
                    if self.on_kill is not None:
                        self.on_kill()
        except (ConnectionError, asyncio.CancelledError):
            pass

    async def send(self, data: bytes, header: bytes = b"") -> None:
        await write_frame(self._writer, Frame(FrameKind.DATA, header, data))

    async def finish(self, error: Optional[str] = None) -> None:
        try:
            if error is not None:
                await write_frame(self._writer, Frame(
                    FrameKind.ERROR, json.dumps({"error": error}).encode()))
            else:
                await write_frame(self._writer, Frame(FrameKind.SENTINEL))
        except (ConnectionError, OSError):
            pass
        finally:
            if self._control_task is not None:
                self._control_task.cancel()
            if not self._writer.is_closing():
                self._writer.close()
