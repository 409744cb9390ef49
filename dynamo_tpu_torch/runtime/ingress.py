"""Serving side of the request plane: bus inbox → engine → TCP dial-back.

A copy of ``dynamo_tpu.runtime.ingress`` without its failpoint
(``request.ingress``) and its request tracing (the worker trace and its
spans), which wait for the port's ``runtime/faults`` and
``runtime/tracing`` (ROADMAP A7, A10). Reference: ``PushEndpoint``
(lib/runtime/src/pipeline/network/ingress/push_endpoint.rs:36-84) +
``Ingress`` (network.rs:51-325); naming lives in runtime/component.py, the
calling side in runtime/egress.py.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from typing import Any, Callable, Optional

from .codec import decode_two_part
from .component import ComponentEndpointInfo, _default_encode
from .engine import AsyncEngine, Context, EngineContext
from .kvstore import Lease
from .tcp import StreamSender, open_stream_sender

logger = logging.getLogger("dynamo_tpu_torch.runtime.distributed")

__all__ = ["EndpointServer"]


class EndpointServer:
    """Serving side: bus inbox loop → engine → TCP dial-back stream.
    Reference: ``PushEndpoint`` (ingress/push_endpoint.rs:36-84) +
    ``Ingress`` (network.rs:51-325)."""

    def __init__(self, endpoint, engine: AsyncEngine,
                 decode_req: Callable[[bytes], Any],
                 encode_resp: Callable[[Any], bytes],
                 stats_handler: Optional[Callable[[], Any]] = None,
                 stats_interval: float = 1.0):
        self.endpoint = endpoint
        self.engine = engine
        self.decode_req = decode_req
        self.encode_resp = encode_resp
        self.stats_handler = stats_handler
        self.stats_interval = stats_interval
        self.lease: Optional[Lease] = None
        self._inbox = None
        self._loop_task: Optional[asyncio.Task] = None
        self._stats_task: Optional[asyncio.Task] = None
        self._drain_task: Optional[asyncio.Task] = None
        self._drain_watcher = None
        self._inflight: set = set()
        self._stopping = False
        # planner drain protocol (docs/planner.md): once draining, the
        # discovery entry carries draining=true (routers stop admitting),
        # in-flight requests run to completion, and `on_drained` fires the
        # moment the server is both draining and idle — the supervisor's
        # cue that the process can stop with zero dropped requests.
        self.draining = False
        self.on_drained: Optional[Callable[[], None]] = None
        # fire-and-forget dedup window (ADVICE r2): the client's dispatch
        # retry is at-least-once; for streaming requests duplicates are
        # harmless (the client consumes only the last dialed-back stream),
        # but a request WITHOUT connection info has no stream to
        # disambiguate and real side effects — drop repeats of its id.
        self._recent_ff_ids: "collections.OrderedDict[str, float]" = \
            collections.OrderedDict()

    RECENT_ID_WINDOW = 60.0
    RECENT_ID_MAX = 4096

    def _ff_duplicate(self, rid: str) -> bool:
        """Record rid; True if it was already accepted inside the window."""
        now = time.monotonic()
        while self._recent_ff_ids:     # expire by age BEFORE the check, so
            oldest_id, t = next(iter(self._recent_ff_ids.items()))
            if now - t <= self.RECENT_ID_WINDOW:
                break
            del self._recent_ff_ids[oldest_id]
        if rid in self._recent_ff_ids:
            return True
        self._recent_ff_ids[rid] = now
        while len(self._recent_ff_ids) > self.RECENT_ID_MAX:
            # capacity-evict AFTER inserting — evicting first could evict
            # rid's own prior entry and accept the duplicate as new
            self._recent_ff_ids.popitem(last=False)
        return False

    def _ff_forget(self, rid: str) -> None:
        """The request did NOT execute — let a redelivery run it (recording
        at accept time and forgetting on failure keeps concurrent in-flight
        duplicates deduped without turning transient failures into drops)."""
        self._recent_ff_ids.pop(rid, None)

    @property
    def lease_id(self) -> int:
        assert self.lease is not None
        return self.lease.id

    async def start(self) -> None:
        rt = self.endpoint.runtime
        await rt.tcp.start()
        self.lease = await rt.primary_lease()
        subject = self.endpoint.subject(self.lease.id)
        self._inbox = await rt.bus.serve(subject)
        self._info = ComponentEndpointInfo(
            subject=subject, worker_id=self.lease.id,
            component=self.endpoint.component, endpoint=self.endpoint.name,
            namespace=self.endpoint.namespace)
        created = await rt.store.kv_create(
            self.endpoint.discovery_key(self.lease.id), self._info.to_json(),
            lease_id=self.lease.id)
        if not created:
            raise RuntimeError(
                f"endpoint already registered: {self.endpoint.path}")
        self._drain_watcher = await rt.store.watch_prefix(
            self.endpoint.drain_key(self.lease.id))
        self._drain_task = asyncio.get_running_loop().create_task(
            self._drain_watch_loop(), name=f"drain-{self.endpoint.name}")
        self._loop_task = asyncio.get_running_loop().create_task(
            self._serve_loop(), name=f"endpoint-{self.endpoint.name}")
        if self.stats_handler is not None:
            self._stats_task = asyncio.get_running_loop().create_task(
                self._stats_loop(), name=f"stats-{self.endpoint.name}")
        logger.info("serving %s as instance %x", self.endpoint.path,
                    self.lease.id)

    async def _drain_watch_loop(self) -> None:
        from .kvstore import WatchEventType
        async for ev in self._drain_watcher:
            if ev.type == WatchEventType.PUT and not self.draining:
                await self.set_draining(True)

    async def set_draining(self, flag: bool) -> None:
        """Flip the discovery entry's draining flag (re-put under our own
        lease, so liveness semantics are untouched). Requests already in
        flight — and any that race in before routers see the update — are
        still served; only NEW router admissions stop."""
        if self.lease is None or self.draining == flag:
            return
        self.draining = flag
        self._info.draining = flag
        await self.endpoint.runtime.store.kv_put(
            self.endpoint.discovery_key(self.lease.id), self._info.to_json(),
            lease_id=self.lease.id)
        logger.info("endpoint %s instance %x draining=%s (%d in flight)",
                    self.endpoint.path, self.lease.id, flag,
                    len(self._inflight))
        self._maybe_drained()

    @property
    def idle(self) -> bool:
        return not self._inflight

    def _maybe_drained(self) -> None:
        # a message can race into the inbox before routers see the
        # draining flag — count it as in-flight, not as idle
        inbox_empty = (self._inbox is None
                       or getattr(self._inbox, "_queue", None) is None
                       or self._inbox._queue.empty())
        if (self.draining and self.idle and inbox_empty
                and self.on_drained is not None):
            self.on_drained()

    async def _serve_loop(self) -> None:
        while not self._stopping:
            msg = await self._inbox.next(timeout=0.5)
            if msg is None:
                self._maybe_drained()
                continue
            task = asyncio.get_running_loop().create_task(
                self._handle(msg.payload))
            self._inflight.add(task)
            task.add_done_callback(self._request_done)

    def _request_done(self, task: asyncio.Task) -> None:
        self._inflight.discard(task)
        self._maybe_drained()

    async def _handle(self, payload: bytes) -> None:
        try:
            ctrl, body = decode_two_part(payload)
        except Exception:
            logger.exception("undecodable request envelope")
            return
        info = ctrl.connection_info
        if info is None and self._ff_duplicate(ctrl.id):
            logger.warning("dropping duplicate fire-and-forget request %s "
                           "(at-least-once re-dispatch)", ctrl.id)
            return
        sender: Optional[StreamSender] = None
        try:
            request = self.decode_req(body)
        except Exception as e:
            if info is not None:
                sender = await open_stream_sender(info, error=str(e))
                await sender.finish()
            else:
                self._ff_forget(ctrl.id)
            return
        # deadline re-anchoring: the wire carries the REMAINING budget;
        # binding it to this side's monotonic clock here means engines
        # poll one absolute deadline with no cross-host clock coupling
        ctx = Context(request, ctx=EngineContext(
            ctrl.id, deadline_ms=ctrl.deadline_ms,
            tenant=ctrl.tenant, qos=ctrl.priority))
        try:
            stream = await self.engine.generate(ctx)
        except Exception as e:
            logger.exception("engine rejected request %s", ctrl.id)
            if info is not None:
                sender = await open_stream_sender(info, error=str(e))
                await sender.finish()
            else:
                self._ff_forget(ctrl.id)
            return
        if info is None:
            try:
                async for _ in stream:   # fire-and-forget request type
                    pass
            except Exception:
                self._ff_forget(ctrl.id)
                raise
            return
        sender = await open_stream_sender(info)
        sender.on_stop = ctx.ctx.stop_generating
        sender.on_kill = ctx.ctx.kill
        try:
            async for item in stream:
                if sender.killed:
                    break
                await sender.send(self.encode_resp(item))
            await sender.finish()
        except (ConnectionError, OSError):
            ctx.ctx.kill()
        except Exception as e:
            logger.exception("stream failed for %s", ctrl.id)
            await sender.finish(error=str(e))

    async def _stats_loop(self) -> None:
        rt = self.endpoint.runtime
        key = self.endpoint.stats_key(self.lease.id)
        while not self._stopping:
            try:
                data = self.stats_handler()
                await rt.store.kv_put(key, _default_encode(data),
                                      lease_id=self.lease.id)
            except Exception:
                logger.exception("stats publish failed")
            await asyncio.sleep(self.stats_interval)

    async def stop(self) -> None:
        self._stopping = True
        rt = self.endpoint.runtime
        if self._loop_task is not None:
            self._loop_task.cancel()
        if self._stats_task is not None:
            self._stats_task.cancel()
        if self._drain_task is not None:
            self._drain_task.cancel()
        if self._drain_watcher is not None:
            self._drain_watcher.close()
        for t in list(self._inflight):
            t.cancel()
        if self.lease is not None:
            # best-effort, bounded deregistration: if the daemon is gone,
            # lease expiry cleans these up anyway — shutdown must never
            # hang in the netstore reconnect window
            async def _deregister() -> None:
                await rt.bus.unserve(
                    self.endpoint.subject(self.lease.id))
                await rt.store.kv_delete(
                    self.endpoint.discovery_key(self.lease.id))
                if self._stats_task is not None:
                    await rt.store.kv_delete(
                        self.endpoint.stats_key(self.lease.id))

            try:
                # wait_for, not asyncio.timeout: 3.10-compatible
                await asyncio.wait_for(_deregister(), timeout=2.0)
            except (asyncio.TimeoutError, TimeoutError, ConnectionError,
                    OSError):
                logger.warning("endpoint %s deregistration skipped (daemon "
                               "unreachable); lease expiry will clean up",
                               self.endpoint.path)
        if self in rt._servers:
            rt._servers.remove(self)
