"""Worker-side publishers: KV cache events + load metrics (a copy of
``dynamo_tpu.llm.kv_router.publisher``).

Reference: lib/llm/src/kv_router/publisher.rs:33-137 (`KvEventPublisher`
mpsc → NATS `kv_events`; `KvMetricsPublisher` watch channel behind the
`load_metrics` endpoint) and the C ABI wrapper the reference exposes for
external engines (lib/bindings/c/src/lib.rs:51-297) — our engine is
in-process so the publisher hooks the block pool directly. The JAX
package's C ABI for out-of-process engines (``csrc/kv_event_abi.cpp``) is
not ported yet (ROADMAP A7).

Transport-agnostic: a `sink` async callable receives each RouterEvent; the
distributed runtime layer plugs in the message-bus publish, tests plug in a
list. Events are buffered through an asyncio queue so the engine loop never
blocks on the network.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable, Optional

from .protocols import (ForwardPassMetrics, KvRemovedEvent, KvStoredEvent,
                        RouterEvent)

logger = logging.getLogger("dynamo_tpu_torch.kv_publisher")

EventSink = Callable[[RouterEvent], Awaitable[None]]


class KvEventPublisher:
    def __init__(self, worker_id: int, sink: Optional[EventSink] = None,
                 max_buffer: int = 8192):
        self.worker_id = worker_id
        self.sink = sink
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=max_buffer)
        self._task: Optional[asyncio.Task] = None
        self._event_id = 0
        self.dropped = 0

    # engine-side hooks (called synchronously from the engine loop) ---------
    def publish_stored(self, block_id: int, seq_hash: int, tokens_hash: int,
                       parent_hash: Optional[int],
                       tier: str = "device") -> None:
        """``tier`` tags which rung of the KV ladder holds the block
        (device | host | disk) — the router discounts colder tiers'
        overlap depth (kv_router/scoring.py TIER_WEIGHTS)."""
        self._enqueue(RouterEvent(
            worker_id=self.worker_id, event_id=self._next_id(),
            stored=KvStoredEvent(parent_hash=parent_hash,
                                 block_hashes=[seq_hash],
                                 tokens_hashes=[tokens_hash]
                                 if tokens_hash is not None else [],
                                 tier=tier)))

    def publish_removed(self, seq_hashes: list) -> None:
        self._enqueue(RouterEvent(
            worker_id=self.worker_id, event_id=self._next_id(),
            removed=KvRemovedEvent(block_hashes=list(seq_hashes))))

    def _next_id(self) -> int:
        self._event_id += 1
        return self._event_id

    def _enqueue(self, ev: RouterEvent) -> None:
        try:
            self._queue.put_nowait(ev)
        except asyncio.QueueFull:
            self.dropped += 1
            return
        self._ensure_task()

    def _ensure_task(self) -> None:
        if self._task is None or self._task.done():
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return  # no loop (sync test context); events drain later
            self._task = loop.create_task(self._run(), name="kv-event-pub")

    async def _run(self) -> None:
        while True:
            ev = await self._queue.get()
            try:
                if self.sink is not None:
                    await self.sink(ev)
            except Exception:  # noqa: BLE001 — transport boundary
                logger.exception("kv event publish failed (event dropped)")
            finally:
                self._queue.task_done()

    async def drain(self) -> None:
        """Wait until every enqueued event has fully passed the sink (not
        merely left the queue — the last event may still be awaiting inside
        ``sink`` when the queue reads empty)."""
        self._ensure_task()
        await self._queue.join()


class KvMetricsPublisher:
    """Holds the latest ForwardPassMetrics snapshot; the endpoint stats
    handler (and scrapers) read it (reference: watch channel semantics —
    readers always see the newest value, never a backlog)."""

    def __init__(self) -> None:
        self._latest = ForwardPassMetrics()

    def publish(self, metrics: ForwardPassMetrics) -> None:
        self._latest = metrics

    @property
    def latest(self) -> ForwardPassMetrics:
        return self._latest

    def stats_handler(self) -> dict:
        return self._latest.to_dict()
