"""Self-hosted discovery + message-bus daemon.

The reference delegates discovery to etcd and the request/event planes to
NATS (docker-compose externals, SURVEY.md layer 0). Neither exists in this
image, so the port ships its own daemon speaking a small length-prefixed
JSON protocol; the server-side state machine *is* the in-memory store/bus
(runtime/kvstore.py, runtime/bus.py), so semantics are identical between the
single-process and networked deployments — the reference gets the same
property from testing against real etcd/NATS in one process (SURVEY.md §4).

A copy of ``dynamo_tpu.runtime.server`` without persistence: the JAX
package's write-ahead log (``--data-dir``, ``runtime/wal.py``) is not
ported yet (ROADMAP A7), so this daemon's state lives in memory only and
``--data-dir`` raises. The wire protocol is the JAX daemon's, so either
package's clients talk to either daemon.

Run: ``python -m dynamo_tpu_torch.runtime.server --host 0.0.0.0 --port 6510``

Wire format: ``[u32 len][json]`` both ways. Client→server messages carry
``rid`` (request id) and ``op``; server replies ``{"rid", "ok", ...}`` and
pushes unsolicited events as ``{"push": "watch"|"msg", ...}``. Bytes travel
base64 (values, payloads).
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import logging
import struct
from typing import Dict, Optional

from .bus import MemoryBus
from .kvstore import MemoryKvStore, WatchEventType

logger = logging.getLogger("dynamo_tpu_torch.runtime.server")

_LEN = struct.Struct(">I")
MAX_MSG = 256 * 1024 * 1024


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


async def send_msg(writer: asyncio.StreamWriter, msg: dict) -> None:
    raw = json.dumps(msg).encode()
    writer.write(_LEN.pack(len(raw)) + raw)
    await writer.drain()


async def recv_msg(reader: asyncio.StreamReader) -> Optional[dict]:
    try:
        hdr = await reader.readexactly(_LEN.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (n,) = _LEN.unpack(hdr)
    if n > MAX_MSG:
        raise ValueError(f"message too large: {n}")
    raw = await reader.readexactly(n)
    return json.loads(raw)


class _ClientSession:
    """One connected client: demuxes ops onto the shared store/bus, tracks
    its watchers/subscriptions/served subjects for cleanup on disconnect."""

    def __init__(self, server: "DiscoveryServer",
                 reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.server = server
        self.reader = reader
        self.writer = writer
        self.watchers: Dict[int, object] = {}
        self.subs: Dict[int, object] = {}
        self.served: Dict[int, str] = {}
        self._next_handle = 1
        self._tasks: set = set()
        self._write_lock = asyncio.Lock()

    async def send(self, msg: dict) -> None:
        async with self._write_lock:
            try:
                await send_msg(self.writer, msg)
            except (ConnectionError, OSError):
                pass

    def _spawn(self, coro) -> None:
        t = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    async def run(self) -> None:
        try:
            while True:
                msg = await recv_msg(self.reader)
                if msg is None:
                    return
                # each op handled in its own task → a blocking dequeue never
                # stalls the connection; rid-matched replies may interleave
                self._spawn(self._dispatch(msg))
        except (ConnectionError, ValueError):
            pass
        finally:
            await self._cleanup()

    async def _dispatch(self, msg: dict) -> None:
        rid = msg.get("rid")
        op = msg.get("op", "")
        store, bus = self.server.store, self.server.bus
        try:
            if op == "kv_create":
                ok = await store.kv_create(msg["key"], _unb64(msg["value"]),
                                           msg.get("lease", 0))
                await self.send({"rid": rid, "ok": True, "result": ok})
            elif op == "kv_create_or_validate":
                ok = await store.kv_create_or_validate(
                    msg["key"], _unb64(msg["value"]), msg.get("lease", 0))
                await self.send({"rid": rid, "ok": True, "result": ok})
            elif op == "kv_put":
                await store.kv_put(msg["key"], _unb64(msg["value"]),
                                   msg.get("lease", 0))
                await self.send({"rid": rid, "ok": True})
            elif op == "kv_cas":
                exp = msg.get("expected")
                ok = await store.kv_cas(
                    msg["key"], _unb64(exp) if exp is not None else None,
                    _unb64(msg["value"]), msg.get("lease", 0))
                await self.send({"rid": rid, "ok": True, "result": ok})
            elif op == "kv_get":
                e = await store.kv_get(msg["key"])
                await self.send({
                    "rid": rid, "ok": True,
                    "entry": None if e is None else
                    {"key": e.key, "value": _b64(e.value), "lease": e.lease_id}})
            elif op == "kv_get_prefix":
                es = await store.kv_get_prefix(msg["prefix"])
                await self.send({
                    "rid": rid, "ok": True,
                    "entries": [{"key": e.key, "value": _b64(e.value),
                                 "lease": e.lease_id} for e in es]})
            elif op == "kv_delete":
                ok = await store.kv_delete(msg["key"])
                await self.send({"rid": rid, "ok": True, "result": ok})
            elif op == "watch_prefix":
                wid = msg["wid"]      # client-allocated: pushes are routable
                watcher = await store.watch_prefix(msg["prefix"])
                self.watchers[wid] = watcher
                await self.send({"rid": rid, "ok": True, "wid": wid})
                self._spawn(self._pump_watch(wid, watcher))
            elif op == "watch_close":
                w = self.watchers.pop(msg["wid"], None)
                if w is not None:
                    w.close()
                await self.send({"rid": rid, "ok": True})
            elif op == "lease_create":
                lease = await store.lease_create(msg["ttl"],
                                                 want_id=msg.get("want_id", 0))
                await self.send({"rid": rid, "ok": True, "lease_id": lease.id})
            elif op == "lease_refresh":
                ok = await store.lease_refresh(msg["lease_id"])
                await self.send({"rid": rid, "ok": True, "result": ok})
            elif op == "lease_revoke":
                await store.lease_revoke(msg["lease_id"])
                await self.send({"rid": rid, "ok": True})
            elif op == "publish":
                n = await bus.publish(msg["subject"], _unb64(msg["payload"]))
                await self.send({"rid": rid, "ok": True, "receivers": n})
            elif op == "subscribe":
                sid = msg["sid"]
                sub = await bus.subscribe(msg["pattern"])
                self.subs[sid] = sub
                await self.send({"rid": rid, "ok": True, "sid": sid})
                self._spawn(self._pump_sub(sid, sub))
            elif op == "serve":
                sid = msg["sid"]
                sub = await bus.serve(msg["subject"])
                self.subs[sid] = sub
                self.served[sid] = msg["subject"]
                await self.send({"rid": rid, "ok": True, "sid": sid})
                self._spawn(self._pump_sub(sid, sub))
            elif op == "unserve":
                await bus.unserve(msg["subject"])
                gone = [sid for sid, s in self.served.items()
                        if s == msg["subject"]]
                for sid in gone:
                    self.served.pop(sid, None)
                    self.subs.pop(sid, None)
                await self.send({"rid": rid, "ok": True})
            elif op == "sub_close":
                sub = self.subs.pop(msg["sid"], None)
                if sub is not None:
                    sub.close()
                self.served.pop(msg["sid"], None)
                await self.send({"rid": rid, "ok": True})
            elif op == "wq_enqueue":
                q = await bus.work_queue(msg["queue"])
                iid = await q.enqueue(_unb64(msg["payload"]))
                await self.send({"rid": rid, "ok": True, "id": iid})
            elif op == "wq_dequeue":
                q = await bus.work_queue(msg["queue"])
                item = await q.dequeue(timeout=msg.get("timeout"),
                                       ack_deadline=msg.get("ack_deadline", 30.0))
                await self.send({
                    "rid": rid, "ok": True,
                    "item": None if item is None else
                    {"id": item.id, "payload": _b64(item.payload),
                     "deliveries": item.deliveries}})
            elif op == "wq_ack":
                q = await bus.work_queue(msg["queue"])
                await q.ack(msg["id"])
                await self.send({"rid": rid, "ok": True})
            elif op == "wq_nack":
                q = await bus.work_queue(msg["queue"])
                await q.nack(msg["id"])
                await self.send({"rid": rid, "ok": True})
            elif op == "wq_depth":
                q = await bus.work_queue(msg["queue"])
                await self.send({"rid": rid, "ok": True,
                                 "depth": await q.depth()})
            elif op == "ping":
                await self.send({"rid": rid, "ok": True})
            else:
                await self.send({"rid": rid, "ok": False,
                                 "error": f"unknown op {op!r}"})
        except Exception as e:  # noqa: BLE001 — protocol boundary
            logger.exception("op %s failed", op)
            await self.send({"rid": rid, "ok": False, "error": str(e)})

    async def _pump_watch(self, wid: int, watcher) -> None:
        async for ev in watcher:
            await self.send({
                "push": "watch", "wid": wid,
                "type": "put" if ev.type == WatchEventType.PUT else "delete",
                "key": ev.entry.key, "value": _b64(ev.entry.value),
                "lease": ev.entry.lease_id})

    async def _pump_sub(self, sid: int, sub) -> None:
        async for m in sub:
            await self.send({"push": "msg", "sid": sid,
                             "subject": m.subject, "payload": _b64(m.payload)})

    async def _cleanup(self) -> None:
        for t in list(self._tasks):
            t.cancel()
        for w in self.watchers.values():
            w.close()
        for sub in self.subs.values():
            sub.close()
        # leases are NOT dropped here: liveness is TTL-based (a client that
        # reconnects within its TTL keeps its identity, exactly like etcd)
        if not self.writer.is_closing():
            self.writer.close()


class DiscoveryServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self.store = MemoryKvStore()
        self.bus = MemoryBus()
        self._server: Optional[asyncio.base_events.Server] = None
        self._sessions: set = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("discovery/bus daemon on %s:%d", self.host, self.port)

    async def _on_conn(self, reader, writer) -> None:
        session = _ClientSession(self, reader, writer)
        self._sessions.add(session)
        try:
            await session.run()
        finally:
            self._sessions.discard(session)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def close(self) -> None:
        server, self._server = self._server, None  # claim (DL008)
        if server is not None:
            server.close()
            # drop live client connections too: wait_closed() (3.12+)
            # otherwise blocks on them, and a killed daemon must look
            # KILLED to clients (their reconnect path takes over)
            for session in list(self._sessions):
                if not session.writer.is_closing():
                    session.writer.close()
            await server.wait_closed()
        await self.store.close()


async def _amain(host: str, port: int) -> None:
    srv = DiscoveryServer(host, port)
    await srv.start()
    print(f"dynamo-tpu-torch discovery/bus daemon listening on {srv.address}",
          flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await srv.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6510)
    ap.add_argument("--data-dir", default=None,
                    help="persistence (the JAX daemon's WAL + snapshot) is "
                         "not ported yet: giving it raises")
    args = ap.parse_args(argv)
    if args.data_dir:
        raise SystemExit("--data-dir: the daemon's write-ahead log is not "
                         "ported yet (ROADMAP A7)")
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    try:
        asyncio.run(_amain(args.host, args.port))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
