"""Message bus (a copy of ``dynamo_tpu.runtime.bus``): NATS-shaped interface
(core pub/sub + queue-group request plane + persistent work queue) with an
in-process implementation. The JAX package's state dump and restore for
its daemon's write-ahead log are not here (the log is not ported yet,
ROADMAP A7).

The reference's request plane is a NATS service endpoint per worker instance
(requests pushed to subject ``{ns}|{comp}.{ep}-{lease:x}``,
lib/runtime/src/component.rs:246-257), its event plane is NATS pub/sub
(traits/events.rs), and its prefill queue is a JetStream work-queue stream
(examples/llm/utils/nats_queue.py). This module keeps those three roles —

- ``publish/subscribe``: broadcast events (every subscriber sees every msg);
- ``serve``: exactly-one delivery to a subject's single server (each worker
  instance serves its own unique subject, so "queue group" degenerates to
  per-instance subjects, as in the reference);
- ``WorkQueue``: at-least-once pull queue with ack/nack + redelivery;

— behind an interface with a memory backend here and a TCP client backend in
runtime/netstore.py.
"""

from __future__ import annotations

import abc
import asyncio
import dataclasses
import fnmatch
import time
from typing import AsyncIterator, Callable, Dict, List, Optional, Tuple

__all__ = ["BusMessage", "Subscription", "WorkItem", "WorkQueue",
           "MessageBus", "MemoryBus"]


@dataclasses.dataclass
class BusMessage:
    subject: str
    payload: bytes


class Subscription:
    """Broadcast subscription handle (supports ``*`` fnmatch wildcards)."""

    def __init__(self, pattern: str, unsubscribe: Callable):
        self.pattern = pattern
        self._queue: asyncio.Queue = asyncio.Queue()
        self._unsubscribe = unsubscribe
        self._closed = False

    def _push(self, msg: BusMessage) -> None:
        if not self._closed:
            self._queue.put_nowait(msg)

    async def next(self, timeout: Optional[float] = None) -> Optional[BusMessage]:
        try:
            if timeout is None:
                return await self._queue.get()
            return await asyncio.wait_for(self._queue.get(), timeout)
        except asyncio.TimeoutError:
            return None

    def __aiter__(self) -> AsyncIterator[BusMessage]:
        return self

    async def __anext__(self) -> BusMessage:
        if self._closed and self._queue.empty():
            raise StopAsyncIteration
        return await self._queue.get()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._unsubscribe(self)


@dataclasses.dataclass
class WorkItem:
    id: int
    payload: bytes
    deliveries: int = 1


class WorkQueue(abc.ABC):
    """At-least-once pull work queue (JetStream work-queue stream analog)."""

    @abc.abstractmethod
    async def enqueue(self, payload: bytes) -> int: ...

    @abc.abstractmethod
    async def dequeue(self, timeout: Optional[float] = None,
                      ack_deadline: float = 30.0) -> Optional[WorkItem]:
        """Next unclaimed item; it must be ``ack``ed before *ack_deadline*
        or it is redelivered."""

    @abc.abstractmethod
    async def ack(self, item_id: int) -> None: ...

    @abc.abstractmethod
    async def nack(self, item_id: int) -> None:
        """Immediately return the item for redelivery."""

    @abc.abstractmethod
    async def depth(self) -> int: ...


class MessageBus(abc.ABC):
    @abc.abstractmethod
    async def publish(self, subject: str, payload: bytes) -> int:
        """Returns how many receivers got the message (0 = no responders,
        the NATS-style signal the request plane retries on)."""

    @abc.abstractmethod
    async def subscribe(self, pattern: str) -> Subscription: ...

    @abc.abstractmethod
    async def serve(self, subject: str) -> Subscription:
        """Claim *subject* as this instance's request inbox. Exactly one
        server per subject; messages published there go only to it."""

    @abc.abstractmethod
    async def unserve(self, subject: str) -> None: ...

    @abc.abstractmethod
    async def work_queue(self, name: str) -> WorkQueue: ...

    async def close(self) -> None:
        pass


class _MemoryWorkQueue(WorkQueue):
    def __init__(self) -> None:
        self._next_id = 1
        self._ready: List[WorkItem] = []
        self._pending: Dict[int, Tuple[WorkItem, float]] = {}  # id → (item, deadline)
        self._event = asyncio.Event()

    def _redeliver_due(self) -> None:
        now = time.monotonic()
        due = [iid for iid, (_, dl) in self._pending.items() if dl <= now]
        for iid in due:
            item, _ = self._pending.pop(iid)
            item.deliveries += 1
            self._ready.append(item)
        if due:
            self._event.set()

    async def enqueue(self, payload: bytes) -> int:
        item = WorkItem(self._next_id, payload)
        self._next_id += 1
        self._ready.append(item)
        self._event.set()
        return item.id

    async def dequeue(self, timeout: Optional[float] = None,
                      ack_deadline: float = 30.0) -> Optional[WorkItem]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self._redeliver_due()
            if self._ready:
                item = self._ready.pop(0)
                self._pending[item.id] = (item, time.monotonic() + ack_deadline)
                return item
            self._event.clear()
            wait = 0.1
            if deadline is not None:
                wait = min(wait, deadline - time.monotonic())
                if wait <= 0:
                    return None
            try:
                await asyncio.wait_for(self._event.wait(), wait)
            except asyncio.TimeoutError:
                pass

    async def ack(self, item_id: int) -> None:
        self._pending.pop(item_id, None)

    async def nack(self, item_id: int) -> None:
        got = self._pending.pop(item_id, None)
        if got is not None:
            item, _ = got
            item.deliveries += 1
            self._ready.insert(0, item)
            self._event.set()

    async def depth(self) -> int:
        self._redeliver_due()
        return len(self._ready)


class MemoryBus(MessageBus):
    """Single-process bus (also the server-side state of the network bus)."""

    def __init__(self) -> None:
        self._subs: List[Subscription] = []
        self._servers: Dict[str, Subscription] = {}
        self._queues: Dict[str, _MemoryWorkQueue] = {}

    async def publish(self, subject: str, payload: bytes) -> int:
        """Returns the receiver count — 0 is NATS's "no responders"
        signal; the request plane (Client.direct) retries on it so a
        request published while its server's subscription is being
        re-established (daemon restart) is never silently dropped."""
        msg = BusMessage(subject, payload)
        n = 0
        srv = self._servers.get(subject)
        if srv is not None:
            srv._push(msg)
            n += 1
        for sub in list(self._subs):
            if sub.pattern == subject or fnmatch.fnmatchcase(subject, sub.pattern):
                sub._push(msg)
                n += 1
        return n

    async def subscribe(self, pattern: str) -> Subscription:
        sub = Subscription(pattern, self._unsub)
        self._subs.append(sub)
        return sub

    def _unsub(self, sub: Subscription) -> None:
        self._subs = [s for s in self._subs if s is not sub]
        for subj, srv in list(self._servers.items()):
            if srv is sub:
                del self._servers[subj]

    async def serve(self, subject: str) -> Subscription:
        if subject in self._servers:
            raise RuntimeError(f"subject already served: {subject}")
        srv = Subscription(subject, self._unsub)
        self._servers[subject] = srv
        return srv

    async def unserve(self, subject: str) -> None:
        srv = self._servers.pop(subject, None)
        if srv is not None:
            srv.close()

    def served_subjects(self) -> List[str]:
        return sorted(self._servers)

    async def work_queue(self, name: str) -> WorkQueue:
        q = self._queues.get(name)
        if q is None:
            q = self._queues[name] = _MemoryWorkQueue()
        return q
