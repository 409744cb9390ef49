"""KV-aware routed engine: the processor-side client that picks the worker
whose KV cache best overlaps the request's prompt.

Reference: the Router component + KvRouter service (SURVEY.md §3.4,
examples/llm/components/kv_router.py:66-238, lib/llm/src/kv_router/
kv_router.rs:44-140): subscribe the component's ``kv_events`` subject into a
radix-tree indexer, scrape per-instance ForwardPassMetrics, and per request
combine prefix-overlap with load cost to choose an instance — then dispatch
with ``client.direct``. Speaks the token protocol (PreprocessedRequest →
Annotated[BackendOutput]) so it slots into the standard pipeline where a
local engine would sit.

A copy of ``dynamo_tpu.llm.engines.kv_routed`` without its tenant
fair-share admission (``llm/tenancy.py``, ROADMAP A10): placement is the
same, and no tenant waits in front of it."""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Set

from ...runtime.distributed import Client, Endpoint
from ...runtime.engine import AsyncEngine, ManyOut, SingleIn
from ..kv_router.protocols import (KV_EVENTS_SUBJECT, KV_HIT_RATE_SUBJECT,
                                   RouterEvent)
from ..kv_router.router import KvRouter
from ..protocols.annotated import decode_annotated_json
from ..protocols.common import BackendOutput

logger = logging.getLogger("dynamo_tpu_torch.llm.kv_routed")

__all__ = ["KvRoutedEngine"]


def _decode_backend_annotated(raw: bytes):
    ann = decode_annotated_json(raw)
    if isinstance(ann.data, dict):
        ann = ann.map_data(BackendOutput.from_dict)
    return ann


class KvRoutedEngine(AsyncEngine):
    def __init__(self, client: Client, router: KvRouter,
                 scrape_interval: float = 1.0):
        self.client = client
        self.router = router
        self.scrape_interval = scrape_interval
        self._tasks: list = []
        self._sub = None
        self._known_workers: Set[int] = set()
        self._hit_component = None
        self._pub_tasks: Set[asyncio.Task] = set()
        # observability
        self.kv_hits = 0
        self.kv_routed = 0
        self.fallback_routed = 0

    @classmethod
    async def start(cls, endpoint: Endpoint, block_size: int = 16,
                    scrape_interval: float = 1.0) -> "KvRoutedEngine":
        client = endpoint.client(decode_resp=_decode_backend_annotated)
        router = KvRouter(block_size)
        self = cls(client, router, scrape_interval)
        # per-decision KVHitRateEvents go out on the component's hit-rate
        # subject for the metrics aggregation service (reference
        # scheduler.rs:28-33 → components/metrics subscriber)
        self._hit_component = endpoint.parent_component()
        router.scheduler.on_hit_rate = self._publish_hit_rate
        # attach the membership callback BEFORE the watch starts so no
        # join/leave can slip between discovery replay and the hook
        client.on_instances_changed = self._instances_changed
        await client.start()
        self._known_workers |= set(client.instance_ids())
        self._sub = await self._hit_component.subscribe_event(
            KV_EVENTS_SUBJECT)
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(self._event_loop(self._sub), name="kvr-events"),
            loop.create_task(self._scrape_loop(), name="kvr-scrape"),
        ]
        return self

    def _publish_hit_rate(self, ev) -> None:
        # keep a strong ref so the loop can't GC the task mid-flight
        # (same discipline as EndpointServer._inflight)
        task = asyncio.get_running_loop().create_task(
            self._hit_component.publish_event(KV_HIT_RATE_SUBJECT,
                                              ev.__dict__),
            name="kvr-hit-rate-pub")
        self._pub_tasks.add(task)
        task.add_done_callback(self._pub_tasks.discard)

    # ---------------------------------------------------------------- feeds
    async def _event_loop(self, sub) -> None:
        async for msg in sub:
            try:
                self.router.on_kv_event(
                    RouterEvent.from_dict(json.loads(msg.payload)))
            except Exception:  # noqa: BLE001
                logger.exception("bad kv event dropped")

    async def _scrape_loop(self) -> None:
        while True:
            try:
                stats = await self.client.collect_stats()
                if stats:
                    self.router.on_metrics(stats)
            except Exception:  # noqa: BLE001
                logger.exception("metrics scrape failed")
            await asyncio.sleep(self.scrape_interval)

    def _instances_changed(self, present: Set[int]) -> None:
        for gone in self._known_workers - present:
            held = self.router.indexer.worker_blocks(gone)
            self.router.on_worker_gone(gone)
            logger.info("worker %x gone: pruned %d indexed blocks (%d "
                        "left)", gone, held,
                        self.router.indexer.worker_blocks(gone))
        self._known_workers = set(present)

    # ------------------------------------------------------------- dispatch
    async def generate(self, request: SingleIn) -> ManyOut:
        tokens = list(request.data.token_ids)
        # draining instances take no new admissions (docs/planner.md);
        # client.random below applies the same exclusion on fallback
        draining = set(self.client.draining_ids())
        pick = self.router.schedule(tokens, exclude=draining or None)
        if pick is None:
            self.fallback_routed += 1
            return await self.client.random(request)
        worker_id, overlap_blocks = pick
        request.data.estimated_prefix_hit_blocks = overlap_blocks
        request.data.prefix_hit_len = overlap_blocks * self.router.block_size
        if overlap_blocks:
            self.kv_hits += 1
        self.kv_routed += 1
        try:
            return await self.client.direct(request, worker_id)
        except Exception:  # noqa: BLE001 — instance raced away; fall back
            logger.warning("direct dispatch to %x failed; falling back",
                           worker_id)
            # the hints described the failed worker's cache, not the
            # fallback target's — reset so its disagg/prefill planning
            # doesn't skip work it actually has to do
            request.data.estimated_prefix_hit_blocks = 0
            request.data.prefix_hit_len = 0
            self.fallback_routed += 1
            return await self.client.random(request)

    async def close(self) -> None:
        if self._sub is not None:
            self._sub.close()
        if self._pub_tasks:  # flush in-flight hit-rate publishes
            await asyncio.gather(*self._pub_tasks, return_exceptions=True)
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        await self.client.close()
