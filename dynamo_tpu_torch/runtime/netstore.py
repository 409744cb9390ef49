"""TCP clients for the discovery/bus daemon (runtime/server.py): NetKvStore
implements the KvStore interface, NetBus the MessageBus interface, over the
daemon's length-prefixed JSON protocol.

A copy of ``dynamo_tpu.runtime.netstore`` without its failpoint
(``netstore.call``) and its ``netstore.{op}`` trace spans, which wait for
the port's ``runtime/faults`` and ``runtime/tracing`` (ROADMAP A7, A10).

These are the reference's etcd-client / async-nats analogs
(lib/runtime/src/transports/{etcd,nats}.rs): a single multiplexed connection
each, a demux reader matching ``rid`` replies and routing ``push`` frames
(watch events, bus messages) to their handles.
"""

from __future__ import annotations

import asyncio
import base64
import logging
import os
import random
from typing import Dict, List, Optional

from .bus import BusMessage, MessageBus, Subscription, WorkItem, WorkQueue
from .kvstore import (KvEntry, KvStore, Lease, PrefixWatcher, WatchEvent,
                      WatchEventType)
from .server import recv_msg, send_msg

logger = logging.getLogger("dynamo_tpu_torch.runtime.netstore")

# process-wide retry counter across every daemon connection — the
# nv_llm_netstore_retries_total feed (a rising rate means the discovery
# daemon link is flapping; each worker's stats handler exports it via
# ForwardPassMetrics.netstore_retries_total)
_retries_total = 0
# process-wide deadline-exceeded counter (nv_llm_netstore_deadline_
# exceeded_total): calls that burned their whole per-call budget —
# rising means the daemon is partitioned/unresponsive, not just flapping
_deadline_exceeded_total = 0


class NetstoreDeadlineExceeded(ConnectionError):
    """A call()'s total per-call deadline elapsed — the typed signal
    that the daemon is partitioned (connected-but-unresponsive) rather
    than flapping. Subclasses ConnectionError so existing degradation
    paths (retry ladders, best-effort deregistration) keep engaging."""


def retries_total() -> int:
    return _retries_total


def deadline_exceeded_total() -> int:
    return _deadline_exceeded_total


def _count_retry() -> None:
    global _retries_total
    _retries_total += 1


def _count_deadline() -> None:
    global _deadline_exceeded_total
    _deadline_exceeded_total += 1


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


class _Conn:
    """One multiplexed daemon connection: request/reply + push routing,
    with transparent reconnection.

    Liveness contract (reference: transports/etcd/lease.rs — clients ride
    out etcd leader changes): if the daemon dies and comes back at the
    same address within RETRY_WINDOW, every pending/new call retries, and
    registered watches/subscriptions/served subjects are re-established on
    the fresh connection under their original client-allocated ids (the
    push-routing tables keep working untouched). Re-established prefix
    watches replay the server's CURRENT keys as synthetic PUTs — consumers
    are keyed/idempotent, so duplicates are harmless; keys whose owners
    died during the outage simply never reappear. Lease identity recovery
    lives in NetKvStore.lease_refresh (reclaim-by-id + leased-key replay).
    """

    RETRY_WINDOW = 30.0
    # bounded retry for one call(): whichever of the attempt budget and
    # the time window runs out first ends the retry loop — a partitioned
    # daemon fails callers in bounded time instead of spinning
    MAX_CALL_RETRIES = 8
    # TOTAL per-call deadline on top of the retry ladder: the window
    # above only binds BETWEEN attempts, so a connected-but-unresponsive
    # (partitioned) daemon could hold one attempt's reply future
    # forever. Every in-flight attempt is clipped to the remaining
    # budget and exhaustion raises NetstoreDeadlineExceeded (counted in
    # nv_llm_netstore_deadline_exceeded_total).
    CALL_DEADLINE = float(os.environ.get("DYN_NETSTORE_CALL_DEADLINE",
                                         "20.0"))
    # jitter factor range on every backoff sleep: N reconnecting clients
    # of a restarted daemon must not stampede it in lockstep
    RETRY_JITTER = (0.5, 1.5)

    def __init__(self, addr: str):
        self.addr = addr
        self.retries_total = 0
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self._next_rid = 1
        # rid → (future, connection epoch the request was written on).
        # Epoch tagging closes a reconnect race: a future written on
        # connection N must be failed when N dies, even if connection N+1
        # is already up by the time N's read loop unwinds — otherwise the
        # caller awaits a reply that can never arrive.
        self._pending: Dict[int, tuple] = {}
        self._epoch = 0
        self._push_watch: Dict[int, PrefixWatcher] = {}
        self._push_sub: Dict[int, Subscription] = {}
        # replay registries: wid → prefix; sid → (op, kwargs)
        self._watch_reg: Dict[int, str] = {}
        self._sub_reg: Dict[int, tuple] = {}
        self._reader_task: Optional[asyncio.Task] = None
        self._write_lock = asyncio.Lock()
        self._conn_lock = asyncio.Lock()
        self._connected = False
        self.closed = False            # permanent, client-initiated
        self.reconnects = 0

    @classmethod
    async def open(cls, addr: str, timeout: float = 10.0) -> "_Conn":
        conn = cls(addr)
        await conn._establish(timeout)   # initial connect fails fast
        return conn

    async def _establish(self, timeout: float = 5.0) -> None:
        host, port = self.addr.rsplit(":", 1)
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, int(port)), timeout)
        old_task = self._reader_task
        self._epoch += 1
        self.reader, self.writer = reader, writer
        self._connected = True
        self._reader_task = asyncio.get_running_loop().create_task(
            self._read_loop(reader, self._epoch), name="netstore-demux")
        # requests written to the replaced socket can never be answered —
        # fail them now rather than waiting for the old read loop to unwind
        self._fail_pending_epochs(self._epoch - 1)
        if old_task is not None:
            old_task.cancel()

    def _fail_pending_epochs(self, max_epoch: int) -> None:
        stale = [rid for rid, (_f, ep) in self._pending.items()
                 if ep <= max_epoch]
        for rid in stale:
            fut, _ep = self._pending.pop(rid)
            if not fut.done():
                fut.set_exception(ConnectionError("daemon connection lost"))

    async def _read_loop(self, reader: asyncio.StreamReader,
                         epoch: int) -> None:
        try:
            while True:
                msg = await recv_msg(reader)
                if msg is None:
                    break
                if "push" in msg:
                    self._route_push(msg)
                    continue
                entry = self._pending.pop(msg.get("rid"), None)
                if entry is not None and not entry[0].done():
                    entry[0].set_result(msg)
        except (ConnectionError, ValueError):
            pass
        finally:
            # fail exactly the requests written on THIS connection (or an
            # older one) — futures tagged with a newer epoch belong to the
            # replacement connection (replay calls) and must survive
            self._fail_pending_epochs(epoch)
            if reader is self.reader:    # a stale loop must not clobber a
                self._connected = False  # newer connection's state
                if not self.closed and (self._watch_reg or self._sub_reg):
                    # push consumers (watches/subscriptions) make no calls
                    # of their own — reconnect eagerly on their behalf
                    asyncio.get_running_loop().create_task(
                        self._auto_reconnect(), name="netstore-reconnect")

    async def _auto_reconnect(self) -> None:
        try:
            await self._ensure_connected()
        except ConnectionError:
            logger.warning("auto-reconnect to %s gave up after %.0fs; "
                           "watch/subscription streams stay dark until the "
                           "next call", self.addr, self.RETRY_WINDOW)

    def _route_push(self, msg: dict) -> None:
        if msg["push"] == "watch":
            w = self._push_watch.get(msg["wid"])
            if w is not None:
                typ = (WatchEventType.PUT if msg["type"] == "put"
                       else WatchEventType.DELETE)
                w._push(WatchEvent(typ, KvEntry(
                    msg["key"], _unb64(msg["value"]), msg.get("lease", 0))))
        elif msg["push"] == "msg":
            s = self._push_sub.get(msg["sid"])
            if s is not None:
                s._push(BusMessage(msg["subject"], _unb64(msg["payload"])))

    async def _ensure_connected(self) -> None:
        if self.closed:
            raise ConnectionError("connection closed")
        if self._connected:
            return
        async with self._conn_lock:
            if self._connected or self.closed:
                return
            loop = asyncio.get_running_loop()
            deadline = loop.time() + self.RETRY_WINDOW
            delay = 0.05
            while True:
                try:
                    await self._establish()
                    break
                except (OSError, asyncio.TimeoutError):
                    if self.closed or loop.time() + delay > deadline:
                        raise ConnectionError(
                            f"daemon unreachable at {self.addr}")
                    # jittered like call(): a fleet reconnecting to a
                    # restarted daemon must not arrive in lockstep
                    await asyncio.sleep(delay * random.uniform(
                        *self.RETRY_JITTER))
                    delay = min(delay * 2, 1.0)
            self.reconnects += 1
            logger.info("reconnected to daemon %s (attempt %d); replaying "
                        "%d watches, %d subscriptions", self.addr,
                        self.reconnects, len(self._watch_reg),
                        len(self._sub_reg))
            for wid, prefix in list(self._watch_reg.items()):
                await self._call_once("watch_prefix", prefix=prefix, wid=wid)
            for sid, (op, kw) in list(self._sub_reg.items()):
                await self._call_once(op, sid=sid, **kw)

    async def _call_once(self, op: str, **kwargs) -> dict:
        rid = self._next_rid
        self._next_rid += 1
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        try:
            async with self._write_lock:
                # snapshot writer+epoch with no await in between so the
                # future is tagged with the connection it is written on
                writer, epoch = self.writer, self._epoch
                self._pending[rid] = (fut, epoch)
                await send_msg(writer, {"rid": rid, "op": op, **kwargs})
        except (OSError, ConnectionError) as e:
            self._pending.pop(rid, None)
            if fut.done():
                fut.exception()   # consume — a racing epoch-fail set it
            self._connected = False
            raise ConnectionError(str(e))
        reply = await fut
        if not reply.get("ok"):
            raise RuntimeError(reply.get("error", f"{op} failed"))
        return reply

    async def call(self, op: str, **kwargs) -> dict:
        """One logical request with bounded, jittered retry: a transient
        daemon hiccup (restart, dropped socket) retries up to
        MAX_CALL_RETRIES times inside RETRY_WINDOW with exponential
        backoff × uniform jitter, counting each retry
        (``retries_total`` per connection + the module counter feeding
        nv_llm_netstore_retries_total) — instead of surfacing the first
        flap as a hard error to the caller.

        A TOTAL per-call deadline (CALL_DEADLINE) rides on top: each
        attempt's reply wait is clipped to the remaining budget, so a
        partitioned daemon — connected but never answering — fails the
        caller in bounded time with :class:`NetstoreDeadlineExceeded`
        instead of holding it for the full jittered retry ladder."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.RETRY_WINDOW
        call_deadline = loop.time() + self.CALL_DEADLINE
        delay = 0.05
        attempts = 0
        while True:
            remaining = call_deadline - loop.time()
            if remaining <= 0:
                _count_deadline()
                raise NetstoreDeadlineExceeded(
                    f"netstore call {op!r} exceeded its "
                    f"{self.CALL_DEADLINE:.0f}s deadline after "
                    f"{attempts} retries")
            try:
                await self._ensure_connected()
                return await asyncio.wait_for(
                    self._call_once(op, **kwargs), remaining)
            except (asyncio.TimeoutError, TimeoutError):
                _count_deadline()
                raise NetstoreDeadlineExceeded(
                    f"netstore call {op!r} exceeded its "
                    f"{self.CALL_DEADLINE:.0f}s deadline mid-attempt "
                    f"(daemon partitioned?)") from None
            except ConnectionError:
                attempts += 1
                if (self.closed or loop.time() >= deadline
                        or attempts >= self.MAX_CALL_RETRIES):
                    raise
                self.retries_total += 1
                _count_retry()
                await asyncio.sleep(min(
                    delay * random.uniform(*self.RETRY_JITTER),
                    max(call_deadline - loop.time(), 0.001)))
                delay = min(delay * 2, 1.0)

    async def close(self) -> None:
        self.closed = True
        self._connected = False
        if self._reader_task is not None:
            self._reader_task.cancel()
        if self.writer is not None and not self.writer.is_closing():
            self.writer.close()


class NetKvStore(KvStore):
    def __init__(self, conn: _Conn):
        self._conn = conn
        # lease-identity recovery state: ttl per lease + the keys written
        # under it, replayed after a daemon restart (lease_refresh)
        self._lease_ttl: Dict[int, float] = {}
        self._leased_keys: Dict[int, Dict[str, bytes]] = {}

    @classmethod
    async def connect(cls, addr: str) -> "NetKvStore":
        return cls(await _Conn.open(addr))

    def _record(self, key: str, value: bytes, lease_id: int) -> None:
        if lease_id:
            self._leased_keys.setdefault(lease_id, {})[key] = value

    async def kv_create(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        r = await self._conn.call("kv_create", key=key, value=_b64(value),
                                  lease=lease_id)
        if r["result"]:
            self._record(key, value, lease_id)
        return bool(r["result"])

    async def kv_create_or_validate(self, key: str, value: bytes,
                                    lease_id: int = 0) -> bool:
        r = await self._conn.call("kv_create_or_validate", key=key,
                                  value=_b64(value), lease=lease_id)
        if r["result"]:
            self._record(key, value, lease_id)
        return bool(r["result"])

    async def kv_put(self, key: str, value: bytes, lease_id: int = 0) -> None:
        await self._conn.call("kv_put", key=key, value=_b64(value),
                              lease=lease_id)
        self._record(key, value, lease_id)

    async def kv_cas(self, key: str, expected, value: bytes,
                     lease_id: int = 0) -> bool:
        r = await self._conn.call(
            "kv_cas", key=key,
            expected=None if expected is None else _b64(expected),
            value=_b64(value), lease=lease_id)
        if r["result"]:
            self._record(key, value, lease_id)
        return bool(r["result"])

    async def kv_get(self, key: str) -> Optional[KvEntry]:
        r = await self._conn.call("kv_get", key=key)
        e = r.get("entry")
        if e is None:
            return None
        return KvEntry(e["key"], _unb64(e["value"]), e.get("lease", 0))

    async def kv_get_prefix(self, prefix: str) -> List[KvEntry]:
        r = await self._conn.call("kv_get_prefix", prefix=prefix)
        return [KvEntry(e["key"], _unb64(e["value"]), e.get("lease", 0))
                for e in r["entries"]]

    async def kv_delete(self, key: str) -> bool:
        r = await self._conn.call("kv_delete", key=key)
        for keys in self._leased_keys.values():
            keys.pop(key, None)
        return bool(r["result"])

    async def watch_prefix(self, prefix: str) -> PrefixWatcher:
        # client-allocated handle, registered BEFORE the call so pushes that
        # race the reply are never dropped
        wid = self._conn._next_rid + 1_000_000

        def unsub(_w: PrefixWatcher) -> None:
            self._conn._push_watch.pop(wid, None)
            self._conn._watch_reg.pop(wid, None)
            if not self._conn.closed:
                asyncio.get_running_loop().create_task(
                    self._safe_call("watch_close", wid=wid))

        w = PrefixWatcher(prefix, [], unsub)
        self._conn._push_watch[wid] = w
        self._conn._watch_reg[wid] = prefix   # re-established on reconnect
        try:
            await self._conn.call("watch_prefix", prefix=prefix, wid=wid)
        except Exception:
            self._conn._push_watch.pop(wid, None)
            self._conn._watch_reg.pop(wid, None)
            raise
        return w

    async def _safe_call(self, op: str, **kw) -> None:
        try:
            await self._conn.call(op, **kw)
        except Exception:
            pass

    async def lease_create(self, ttl: float, want_id: int = 0) -> Lease:
        r = await self._conn.call("lease_create", ttl=ttl, want_id=want_id)
        self._lease_ttl[r["lease_id"]] = ttl
        return Lease(self, r["lease_id"], ttl)

    async def lease_refresh(self, lease_id: int) -> bool:
        r = await self._conn.call("lease_refresh", lease_id=lease_id)
        if r["result"]:
            return True
        # unknown lease: either it expired (we were gone too long) or the
        # daemon restarted with empty state. Reclaim the SAME id — it is
        # the worker's identity (subjects, discovery keys) — and replay
        # the keys registered under it, so routing recovers without the
        # worker noticing (reference liveness: transports/etcd/lease.rs).
        ttl = self._lease_ttl.get(lease_id)
        if ttl is None:
            return False
        try:
            await self._conn.call("lease_create", ttl=ttl, want_id=lease_id)
        except RuntimeError:
            return False       # id taken by someone else — truly lost
        for key, value in self._leased_keys.get(lease_id, {}).items():
            await self._conn.call("kv_put", key=key, value=_b64(value),
                                  lease=lease_id)
        logger.info("lease %x reclaimed after daemon restart (%d keys "
                    "replayed)", lease_id,
                    len(self._leased_keys.get(lease_id, {})))
        # derived state (router radix index of this worker's blocks) was
        # wiped by the expiry's DELETE events and is NOT in our key replay
        # — let the owner re-announce it (KNOWN_ISSUES kv-router staleness)
        if self.on_lease_reclaimed is not None:
            try:
                self.on_lease_reclaimed(lease_id)
            except Exception:  # noqa: BLE001 — observer must not kill
                logger.exception("on_lease_reclaimed hook failed")
        return True

    async def lease_revoke(self, lease_id: int) -> None:
        self._lease_ttl.pop(lease_id, None)
        self._leased_keys.pop(lease_id, None)
        await self._conn.call("lease_revoke", lease_id=lease_id)

    async def close(self) -> None:
        await self._conn.close()


class _NetWorkQueue(WorkQueue):
    def __init__(self, conn: _Conn, name: str):
        self._conn = conn
        self.name = name

    async def enqueue(self, payload: bytes) -> int:
        r = await self._conn.call("wq_enqueue", queue=self.name,
                                  payload=_b64(payload))
        return r["id"]

    async def dequeue(self, timeout: Optional[float] = None,
                      ack_deadline: float = 30.0) -> Optional[WorkItem]:
        r = await self._conn.call("wq_dequeue", queue=self.name,
                                  timeout=timeout, ack_deadline=ack_deadline)
        item = r.get("item")
        if item is None:
            return None
        return WorkItem(item["id"], _unb64(item["payload"]),
                        item.get("deliveries", 1))

    async def ack(self, item_id: int) -> None:
        await self._conn.call("wq_ack", queue=self.name, id=item_id)

    async def nack(self, item_id: int) -> None:
        await self._conn.call("wq_nack", queue=self.name, id=item_id)

    async def depth(self) -> int:
        r = await self._conn.call("wq_depth", queue=self.name)
        return r["depth"]


class NetBus(MessageBus):
    def __init__(self, conn: _Conn):
        self._conn = conn
        self._served: Dict[str, int] = {}

    @classmethod
    async def connect(cls, addr: str) -> "NetBus":
        return cls(await _Conn.open(addr))

    async def publish(self, subject: str, payload: bytes) -> int:
        r = await self._conn.call("publish", subject=subject,
                                  payload=_b64(payload))
        return int(r.get("receivers", 0))

    async def _make_sub(self, op: str, **kw) -> Subscription:
        sid = self._conn._next_rid + 2_000_000  # client-allocated (see watch)

        def unsub(_s: Subscription) -> None:
            self._conn._push_sub.pop(sid, None)
            self._conn._sub_reg.pop(sid, None)
            if not self._conn.closed:
                asyncio.get_running_loop().create_task(
                    self._safe_call("sub_close", sid=sid))

        sub = Subscription(kw.get("pattern") or kw.get("subject", ""), unsub)
        self._conn._push_sub[sid] = sub
        self._conn._sub_reg[sid] = (op, dict(kw))  # replayed on reconnect
        try:
            await self._conn.call(op, sid=sid, **kw)
        except Exception:
            self._conn._push_sub.pop(sid, None)
            self._conn._sub_reg.pop(sid, None)
            raise
        return sub, sid

    async def subscribe(self, pattern: str) -> Subscription:
        sub, _sid = await self._make_sub("subscribe", pattern=pattern)
        return sub

    async def serve(self, subject: str) -> Subscription:
        sub, sid = await self._make_sub("serve", subject=subject)
        self._served[subject] = sid
        return sub

    async def unserve(self, subject: str) -> None:
        sid = self._served.pop(subject, None)
        if sid is not None:
            self._conn._sub_reg.pop(sid, None)
        await self._conn.call("unserve", subject=subject)

    async def work_queue(self, name: str) -> WorkQueue:
        return _NetWorkQueue(self._conn, name)

    async def _safe_call(self, op: str, **kw) -> None:
        try:
            await self._conn.call(op, **kw)
        except Exception:
            pass

    async def close(self) -> None:
        await self._conn.close()
