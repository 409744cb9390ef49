"""NativeStreamSender: response-plane egress over the C++ data plane.

A copy of ``dynamo_tpu.runtime.native_tcp`` over the port's own copy of
the source (``csrc/host/data_plane.cpp``, built by ``utils/native.py`` with
``-pthread``). Same interface as ``tcp.StreamSender`` (connect / send /
finish / on_stop / on_kill / killed), but framing and socket writes happen
on a dedicated C++ thread instead of the asyncio loop: a frame send is one
lock-protected enqueue, and the loop never blocks in ``drain()``. STOP /
KILL control frames from the receiver surface as atomic flags; a light
asyncio task polls them every 20 ms into the same ``on_stop`` / ``on_kill``
callbacks the asyncio sender fires, and ends when the peer closes.

Unlike the JAX package's sender, a frame's bytes go to the library as a
pointer into the ``bytes`` object itself (the library copies them once,
into its queued frame), not through a ctypes array copy first. A library
that does not build or load raises: there is no quiet fallback to the
asyncio sender (``tcp.open_stream_sender`` picks one or the other by
``DYN_NATIVE_DATAPLANE`` alone).
"""

from __future__ import annotations

import asyncio
import ctypes
import json
from typing import Callable, Optional

from ..utils import native
from .codec import ConnectionInfo, FrameKind

__all__ = ["NativeStreamSender", "load_data_plane_lib"]

_CTRL_STOP = 1
_CTRL_KILL = 2
_CTRL_PEER_CLOSED = 4
_HIGH_WATER = 8 * 1024 * 1024     # backpressure threshold (queued bytes)
_POLL_S = 0.02                    # control-flag poll cadence


def load_data_plane_lib() -> ctypes.CDLL:
    """Build (once) and load the data plane's library; raises
    ``RuntimeError`` when it cannot."""
    lib = native.load("data_plane", ["data_plane.cpp"],
                      extra_flags=["-pthread"])
    if getattr(lib, "_dp_ready", False):
        return lib
    lib.dp_connect.restype = ctypes.c_int
    lib.dp_connect.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.dpsend_create.restype = ctypes.c_void_p
    lib.dpsend_create.argtypes = [ctypes.c_int]
    lib.dpsend_send.restype = ctypes.c_int
    # const uint8_t* on the C side: a bytes object passes its own buffer
    lib.dpsend_send.argtypes = [ctypes.c_void_p, ctypes.c_uint8,
                                ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_char_p, ctypes.c_int64]
    lib.dpsend_queued_bytes.restype = ctypes.c_int64
    lib.dpsend_queued_bytes.argtypes = [ctypes.c_void_p]
    lib.dpsend_flush.restype = ctypes.c_int
    lib.dpsend_flush.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dpsend_ctrl.restype = ctypes.c_uint32
    lib.dpsend_ctrl.argtypes = [ctypes.c_void_p]
    lib.dpsend_error.restype = ctypes.c_int
    lib.dpsend_error.argtypes = [ctypes.c_void_p]
    lib.dpsend_abort.argtypes = [ctypes.c_void_p]
    lib.dpsend_close.argtypes = [ctypes.c_void_p]
    lib._dp_ready = True
    return lib


def _as_bytes(b) -> bytes:
    return b if isinstance(b, bytes) else bytes(b)


class NativeStreamSender:
    """Worker-side response stream over the native data plane."""

    def __init__(self, lib: ctypes.CDLL, handle: int):
        self._lib = lib
        self._h = handle
        self._poll_task: Optional[asyncio.Task] = None
        self._fired = 0
        self.on_stop: Optional[Callable[[], None]] = None
        self.on_kill: Optional[Callable[[], None]] = None
        self.killed = False

    @classmethod
    async def connect(cls, info: ConnectionInfo,
                      error: Optional[str] = None,
                      timeout: float = 10.0) -> "NativeStreamSender":
        # the first call may compile the data plane: off the loop
        # (memoized afterwards)
        lib = await asyncio.to_thread(load_data_plane_lib)
        host, port = info.address.rsplit(":", 1)
        loop = asyncio.get_running_loop()
        fd = await loop.run_in_executor(
            None, lib.dp_connect, host.encode(), int(port),
            int(timeout * 1000))
        if fd < 0:
            raise ConnectionError(f"dp_connect {info.address}: errno {-fd}")
        sender = cls(lib, lib.dpsend_create(fd))
        hdr = json.dumps({"stream_id": info.stream_id,
                          "error": error}).encode()
        sender._raw_send(FrameKind.PROLOGUE, hdr, b"")
        sender._poll_task = loop.create_task(
            sender._poll_ctrl(), name=f"dp-ctl-{info.stream_id[:8]}")
        return sender

    def _raw_send(self, kind: FrameKind, header: bytes, data: bytes) -> None:
        header, data = _as_bytes(header), _as_bytes(data)
        rc = self._lib.dpsend_send(self._h, int(kind), header, len(header),
                                   data, len(data))
        if rc != 0:
            raise ConnectionError("native stream sender closed")

    def _check_ctrl(self) -> int:
        """Read the C++ control flags and fire callbacks exactly once."""
        flags = self._lib.dpsend_ctrl(self._h)
        if flags & _CTRL_KILL and not self._fired & _CTRL_KILL:
            self._fired |= _CTRL_KILL
            self.killed = True
            if self.on_kill is not None:
                self.on_kill()
        if flags & _CTRL_STOP and not self._fired & _CTRL_STOP:
            self._fired |= _CTRL_STOP
            if self.on_stop is not None:
                self.on_stop()
        return flags

    async def _poll_ctrl(self) -> None:
        while True:
            if self._check_ctrl() & _CTRL_PEER_CLOSED:
                return
            await asyncio.sleep(_POLL_S)

    async def send(self, data: bytes, header: bytes = b"") -> None:
        # a synchronous flag check keeps kill observation at send
        # granularity (the asyncio sender's reader task fires before the
        # next send; the 20 ms poll alone would lose that race and surface
        # a spurious ConnectionError instead of a cooperative stop)
        self._check_ctrl()
        if self.killed:
            return                     # dead stream: drop, as the other does
        try:
            self._raw_send(FrameKind.DATA, header, data)
        except ConnectionError:
            self._check_ctrl()
            if self.killed:
                return
            raise
        # backpressure: yield until the C++ queue drains below the mark, or
        # the writer died (an error, or a peer that closed: the writer
        # thread exits at its EOF with no error set, and the JAX sender's
        # loop would spin on its undrained queue; the next send raises)
        while (self._lib.dpsend_queued_bytes(self._h) > _HIGH_WATER
               and self._lib.dpsend_error(self._h) == 0
               and not self._lib.dpsend_ctrl(self._h) & _CTRL_PEER_CLOSED):
            await asyncio.sleep(0.001)

    async def finish(self, error: Optional[str] = None) -> None:
        try:
            if error is not None:
                self._raw_send(FrameKind.ERROR,
                               json.dumps({"error": error}).encode(), b"")
            else:
                self._raw_send(FrameKind.SENTINEL, b"", b"")
        except ConnectionError:
            pass
        finally:
            loop = asyncio.get_running_loop()
            rc = await loop.run_in_executor(
                None, self._lib.dpsend_flush, self._h, 10_000)
            if rc != 0:
                self._lib.dpsend_abort(self._h)
            if self._poll_task is not None:
                self._poll_task.cancel()
            h, self._h = self._h, None
            await loop.run_in_executor(None, self._lib.dpsend_close, h)
