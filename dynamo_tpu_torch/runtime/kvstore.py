"""Discovery KV store (a copy of ``dynamo_tpu.runtime.kvstore``): etcd-shaped
interface (kv ops + leases + prefix watches) with an in-process
implementation. The JAX package's state dump and restore for its
daemon's write-ahead log are not here (the log is not ported yet,
ROADMAP A7).

The reference binds discovery to etcd (lib/runtime/src/transports/etcd.rs:
``kv_create`` atomic txn, ``kv_create_or_validate``, ``kv_get_and_watch_prefix``
→ ``PrefixWatcher``/``WatchEvent::{Put,Delete}``; leases in etcd/lease.rs with
a keep-alive loop whose death shuts the runtime down). We keep that *shape* —
leases are the liveness primitive, watches drive client instance lists — but
behind an interface with two backends:

- :class:`MemoryKvStore` — single-process; also the server-side state of the
  network store (runtime/server.py), so semantics are tested once.
- ``NetKvStore`` (runtime/netstore.py) — TCP client to the self-hosted
  discovery daemon, filling etcd's role without an external dependency.

Liveness: a lease has a TTL and must be refreshed; expiry deletes every key
attached to it and fires Delete watch events — exactly how reference workers
vanish from routing when they die (SURVEY.md §5.3).
"""

from __future__ import annotations

import abc
import asyncio
import dataclasses
import time
from enum import Enum
from typing import AsyncIterator, Callable, Dict, List, Optional, Tuple

__all__ = [
    "WatchEventType",
    "WatchEvent",
    "KvEntry",
    "PrefixWatcher",
    "Lease",
    "KvStore",
    "MemoryKvStore",
]


class WatchEventType(Enum):
    PUT = "put"
    DELETE = "delete"


@dataclasses.dataclass
class KvEntry:
    key: str
    value: bytes
    lease_id: int = 0


@dataclasses.dataclass
class WatchEvent:
    type: WatchEventType
    entry: KvEntry


class PrefixWatcher:
    """Async stream of WatchEvents for one prefix; starts with a synthetic
    PUT per existing key (reference: kv_get_and_watch_prefix returns current
    kvs + watcher)."""

    def __init__(self, prefix: str, initial: List[KvEntry],
                 unsubscribe: Callable[["PrefixWatcher"], None]):
        self.prefix = prefix
        self._queue: asyncio.Queue = asyncio.Queue()
        self._unsubscribe = unsubscribe
        self._closed = False
        for e in initial:
            self._queue.put_nowait(WatchEvent(WatchEventType.PUT, e))

    def _push(self, ev: WatchEvent) -> None:
        if not self._closed:
            self._queue.put_nowait(ev)

    async def next(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        try:
            if timeout is None:
                return await self._queue.get()
            return await asyncio.wait_for(self._queue.get(), timeout)
        except asyncio.TimeoutError:
            return None

    def __aiter__(self) -> AsyncIterator[WatchEvent]:
        return self

    async def __anext__(self) -> WatchEvent:
        if self._closed and self._queue.empty():
            raise StopAsyncIteration
        return await self._queue.get()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._unsubscribe(self)


class Lease:
    """Client-side lease handle. ``keep_alive`` runs until revoked/cancelled;
    if refreshing fails (store gone) the ``on_lost`` callback fires — the
    reference's lease-death ⇒ runtime-shutdown contract."""

    def __init__(self, store: "KvStore", lease_id: int, ttl: float):
        self.store = store
        self.id = lease_id
        self.ttl = ttl
        self._task: Optional[asyncio.Task] = None
        self._revoked = False
        self.on_lost: Optional[Callable[[], None]] = None

    def start_keepalive(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._keepalive_loop(), name=f"lease-keepalive-{self.id:x}")

    async def _keepalive_loop(self) -> None:
        interval = max(self.ttl / 3.0, 0.05)
        while not self._revoked:
            await asyncio.sleep(interval)
            if self._revoked:
                return
            # transient-flap tolerance (chaos-hardening): a refresh that
            # RAISED (store link hiccup) is retried quickly inside the
            # remaining TTL window before the lease is declared lost —
            # one dropped RPC must not tear down a healthy worker. A
            # refresh that RETURNED False is authoritative (the store
            # says the lease is gone): give up immediately; NetKvStore's
            # lease_refresh already attempts reclaim-by-id internally.
            deadline = asyncio.get_running_loop().time() + (
                self.ttl - interval)
            ok = False
            while not self._revoked:
                try:
                    ok = await self.store.lease_refresh(self.id)
                    break
                except Exception:
                    if asyncio.get_running_loop().time() >= deadline:
                        break
                    await asyncio.sleep(min(interval / 4, 0.25))
            if self._revoked:
                return
            if not ok:
                self._revoked = True
                if self.on_lost is not None:
                    self.on_lost()
                return

    async def revoke(self) -> None:
        self._revoked = True
        if self._task is not None:
            self._task.cancel()
            self._task = None
        try:
            await self.store.lease_revoke(self.id)
        except Exception:
            pass


class KvStore(abc.ABC):
    """etcd-shaped discovery store interface.

    ``on_lease_reclaimed(lease_id)``: fired by backends that can reclaim a
    transiently-expired lease under the same id (NetKvStore after a daemon
    restart/liveness blip). The worker's discovery KEYS are replayed by the
    store itself, but derived state — e.g. the KV router's radix index of
    this worker's cached blocks — was wiped by the DELETE watch events and
    must be re-announced by whoever owns it (KNOWN_ISSUES kv-router
    staleness; see KvBlockPool.reannounce)."""

    on_lease_reclaimed: Optional[Callable[[int], None]] = None

    @abc.abstractmethod
    async def kv_create(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        """Atomic create; False if the key already exists."""

    @abc.abstractmethod
    async def kv_create_or_validate(self, key: str, value: bytes,
                                    lease_id: int = 0) -> bool:
        """Create, or succeed iff the existing value is identical."""

    @abc.abstractmethod
    async def kv_put(self, key: str, value: bytes, lease_id: int = 0) -> None: ...

    async def kv_cas(self, key: str, expected: Optional[bytes],
                     value: bytes, lease_id: int = 0) -> bool:
        """Write iff current value == expected (None = absent). Default
        raises — backends opt in (Memory + Net both do)."""
        raise NotImplementedError

    @abc.abstractmethod
    async def kv_get(self, key: str) -> Optional[KvEntry]: ...

    @abc.abstractmethod
    async def kv_get_prefix(self, prefix: str) -> List[KvEntry]: ...

    @abc.abstractmethod
    async def kv_delete(self, key: str) -> bool: ...

    @abc.abstractmethod
    async def watch_prefix(self, prefix: str) -> PrefixWatcher:
        """Current entries as synthetic PUTs, then live events."""

    @abc.abstractmethod
    async def lease_create(self, ttl: float) -> Lease: ...

    @abc.abstractmethod
    async def lease_refresh(self, lease_id: int) -> bool: ...

    @abc.abstractmethod
    async def lease_revoke(self, lease_id: int) -> None: ...

    async def close(self) -> None:
        pass


class MemoryKvStore(KvStore):
    """In-process store. Single event-loop actor discipline: every method
    runs on the owning loop, so no locks (the reference gets the same
    guarantee from etcd's serializability)."""

    def __init__(self, now: Callable[[], float] = time.monotonic):
        self._kv: Dict[str, KvEntry] = {}
        self._watchers: List[Tuple[str, PrefixWatcher]] = []
        self._leases: Dict[int, float] = {}      # id → expiry deadline
        self._lease_ttl: Dict[int, float] = {}
        self._lease_keys: Dict[int, set] = {}
        self._next_lease = 0xA0000001
        self._now = now
        self._reaper: Optional[asyncio.Task] = None

    # ------------------------------------------------------------- helpers
    def _notify(self, ev: WatchEvent) -> None:
        for prefix, w in list(self._watchers):
            if ev.entry.key.startswith(prefix):
                w._push(ev)

    def _attach(self, key: str, lease_id: int) -> None:
        if lease_id:
            self._lease_keys.setdefault(lease_id, set()).add(key)

    def _expire_due(self) -> None:
        now = self._now()
        dead = [lid for lid, dl in self._leases.items() if dl <= now]
        for lid in dead:
            self._drop_lease(lid)

    def _drop_lease(self, lease_id: int) -> None:
        self._leases.pop(lease_id, None)
        self._lease_ttl.pop(lease_id, None)
        for key in sorted(self._lease_keys.pop(lease_id, ())):
            entry = self._kv.pop(key, None)
            if entry is not None:
                self._notify(WatchEvent(WatchEventType.DELETE, entry))

    def _ensure_reaper(self) -> None:
        if self._reaper is None or self._reaper.done():
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return
            self._reaper = loop.create_task(self._reap_loop(),
                                            name="kvstore-lease-reaper")

    async def _reap_loop(self) -> None:
        while True:
            await asyncio.sleep(0.05)
            self._expire_due()
            if not self._leases:
                return

    # ---------------------------------------------------------------- kv
    async def kv_create(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        self._expire_due()
        if key in self._kv:
            return False
        e = KvEntry(key, value, lease_id)
        self._kv[key] = e
        self._attach(key, lease_id)
        self._notify(WatchEvent(WatchEventType.PUT, e))
        return True

    async def kv_create_or_validate(self, key: str, value: bytes,
                                    lease_id: int = 0) -> bool:
        self._expire_due()
        cur = self._kv.get(key)
        if cur is None:
            return await self.kv_create(key, value, lease_id)
        return cur.value == value

    async def kv_put(self, key: str, value: bytes, lease_id: int = 0) -> None:
        self._expire_due()
        e = KvEntry(key, value, lease_id)
        self._kv[key] = e
        self._attach(key, lease_id)
        self._notify(WatchEvent(WatchEventType.PUT, e))

    async def kv_cas(self, key: str, expected: Optional[bytes],
                     value: bytes, lease_id: int = 0) -> bool:
        """Compare-and-swap (etcd txn compare-put analog): write iff the
        current value equals ``expected`` (None = key absent). The store's
        only safe read-modify-write primitive — writers in DIFFERENT
        processes cannot serialize with local locks."""
        self._expire_due()
        cur = self._kv.get(key)
        if (cur.value if cur is not None else None) != expected:
            return False
        e = KvEntry(key, value, lease_id)
        self._kv[key] = e
        self._attach(key, lease_id)
        self._notify(WatchEvent(WatchEventType.PUT, e))
        return True

    async def kv_get(self, key: str) -> Optional[KvEntry]:
        self._expire_due()
        return self._kv.get(key)

    async def kv_get_prefix(self, prefix: str) -> List[KvEntry]:
        self._expire_due()
        return [e for k, e in sorted(self._kv.items())
                if k.startswith(prefix)]

    async def kv_delete(self, key: str) -> bool:
        entry = self._kv.pop(key, None)
        if entry is None:
            return False
        if entry.lease_id:
            self._lease_keys.get(entry.lease_id, set()).discard(key)
        self._notify(WatchEvent(WatchEventType.DELETE, entry))
        return True

    async def watch_prefix(self, prefix: str) -> PrefixWatcher:
        self._expire_due()
        initial = await self.kv_get_prefix(prefix)
        w = PrefixWatcher(prefix, initial, self._unsubscribe)
        self._watchers.append((prefix, w))
        return w

    def _unsubscribe(self, watcher: PrefixWatcher) -> None:
        self._watchers = [(p, w) for p, w in self._watchers if w is not watcher]

    # ------------------------------------------------------------- leases
    async def lease_create(self, ttl: float, want_id: int = 0) -> Lease:
        """``want_id``: reclaim a specific id after a store restart (the
        worker's identity — subjects, discovery keys — is the lease id, so
        reconnection must be able to keep it; etcd grants ids the same
        way via LeaseGrant with a client-chosen ID). Raises if taken."""
        self._expire_due()
        if want_id:
            if want_id in self._leases:
                raise RuntimeError(f"lease id {want_id:#x} already held")
            lid = want_id
            self._next_lease = max(self._next_lease, want_id + 1)
        else:
            lid = self._next_lease
            self._next_lease += 1
        self._leases[lid] = self._now() + ttl
        self._lease_ttl[lid] = ttl
        self._ensure_reaper()
        return Lease(self, lid, ttl)

    async def lease_refresh(self, lease_id: int) -> bool:
        self._expire_due()
        if lease_id not in self._leases:
            return False
        self._leases[lease_id] = self._now() + self._lease_ttl[lease_id]
        return True

    async def lease_revoke(self, lease_id: int) -> None:
        self._drop_lease(lease_id)

    async def close(self) -> None:
        if self._reaper is not None:
            self._reaper.cancel()
            self._reaper = None
