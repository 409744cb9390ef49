"""Calling side of the request plane: discovery watch, routing, dispatch.

A copy of ``dynamo_tpu.runtime.egress`` without its failpoint
(``request.egress``) and its request tracing (the egress span and the
propagated trace context), which wait for the port's ``runtime/faults``
and ``runtime/tracing`` (ROADMAP A7, A10): the request control message's
``trace`` stays empty. Reference: ``Client<T,U>``
(lib/runtime/src/component/client.rs:52-256) and the push-router send path
(pipeline/network/egress/push.rs:88-156); naming lives in
runtime/component.py, the serving side in runtime/ingress.py.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import random
from typing import Any, AsyncIterator, Callable, Dict, List, Optional

from .codec import (ControlMessage, FrameKind, RequestControlMessage,
                    encode_two_part)
from .component import ComponentEndpointInfo
from .engine import AsyncEngine, Context, ManyOut, ResponseStream, SingleIn
from .kvstore import WatchEventType
from .tcp import TcpStreamServer

logger = logging.getLogger("dynamo_tpu_torch.runtime.distributed")

__all__ = ["Client"]


class _RemoteStream(ResponseStream):
    """Client-side view of a worker's TCP response stream; forwards
    stop/kill from the local context as upstream control frames."""

    def __init__(self, ctx, rx, decode_resp, server: TcpStreamServer):
        self._rx = rx
        self._decode = decode_resp
        self._server = server
        self._ctx = ctx
        super().__init__(self._gen(), ctx)

    def _gen(self) -> AsyncIterator[Any]:
        async def gen():
            try:
                while True:
                    if self._ctx.is_killed:
                        await self._rx.send_control(ControlMessage.kill())
                        return
                    if self._ctx.is_stopped:
                        await self._rx.send_control(ControlMessage.stop())
                    f = await self._rx.next_frame(timeout=0.5)
                    if f is None:
                        continue
                    if f.kind == FrameKind.DATA:
                        yield self._decode(f.data)
                    elif f.kind == FrameKind.SENTINEL:
                        return
                    elif f.kind == FrameKind.ERROR:
                        err = f.header_json().get("error", "stream error")
                        raise RuntimeError(f"remote stream error: {err}")
            finally:
                self._rx.close()
                self._server.unregister(self._rx.stream_id)
        return gen()


class Client(AsyncEngine):
    """Watches discovery, routes requests. Reference ``Client<T,U>``
    (component/client.rs:52-256); default routing is random, like the
    reference's AsyncEngine impl for Client."""

    def __init__(self, endpoint,
                 encode_req: Callable[[Any], bytes],
                 decode_resp: Callable[[bytes], Any]):
        self.endpoint = endpoint
        self.encode_req = encode_req
        self.decode_resp = decode_resp
        self.instances: Dict[int, ComponentEndpointInfo] = {}
        self._watcher = None
        self._watch_task: Optional[asyncio.Task] = None
        self._rr = itertools.count()
        self._instances_event = asyncio.Event()
        self.on_instances_changed: Optional[Callable[[set], None]] = None

    async def start(self) -> "Client":
        rt = self.endpoint.runtime
        await rt.tcp.start()
        self._watcher = await rt.store.watch_prefix(
            self.endpoint.discovery_prefix())
        self._watch_task = asyncio.get_running_loop().create_task(
            self._watch_loop(), name=f"client-watch-{self.endpoint.name}")
        return self

    async def _watch_loop(self) -> None:
        async for ev in self._watcher:
            key = ev.entry.key
            lease_hex = key.rsplit(":", 1)[-1]
            try:
                lease_id = int(lease_hex, 16)
            except ValueError:
                continue
            if ev.type == WatchEventType.PUT:
                try:
                    self.instances[lease_id] = ComponentEndpointInfo.from_json(
                        ev.entry.value)
                except Exception:
                    continue
            else:
                self.instances.pop(lease_id, None)
            self._instances_event.set()
            if self.on_instances_changed is not None:
                self.on_instances_changed(set(self.instances))

    def instance_ids(self) -> List[int]:
        return sorted(self.instances)

    def draining_ids(self) -> List[int]:
        return sorted(i for i, info in self.instances.items()
                      if info.draining)

    def available_ids(self) -> List[int]:
        """Instances eligible for NEW work: the draining ones stay
        discoverable (their in-flight streams are still live) but take no
        new admissions (docs/planner.md). If the whole fleet is draining,
        fall back to all instances — a drain must shift load, never drop
        requests on the floor."""
        avail = [i for i, info in sorted(self.instances.items())
                 if not info.draining]
        return avail if avail else self.instance_ids()

    async def wait_for_instances(self, timeout: float = 30.0) -> List[int]:
        deadline = asyncio.get_running_loop().time() + timeout
        while not self.instances:
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                raise TimeoutError(
                    f"no instances for {self.endpoint.path} after {timeout}s")
            self._instances_event.clear()
            try:
                await asyncio.wait_for(self._instances_event.wait(),
                                       min(remaining, 1.0))
            except asyncio.TimeoutError:
                pass
        return self.instance_ids()

    # --------------------------------------------------------------- routes
    async def generate(self, request: SingleIn) -> ManyOut:
        return await self.random(request)

    async def random(self, request: SingleIn) -> ManyOut:
        ids = self.available_ids()
        if not ids:
            raise RuntimeError(f"no instances for {self.endpoint.path}")
        return await self.direct(request, random.choice(ids))

    async def round_robin(self, request: SingleIn) -> ManyOut:
        ids = self.available_ids()
        if not ids:
            raise RuntimeError(f"no instances for {self.endpoint.path}")
        return await self.direct(request, ids[next(self._rr) % len(ids)])

    async def direct(self, request: SingleIn, instance_id: int) -> ManyOut:
        """The push-router send path (egress/push.rs:88-156): register a
        response stream, publish the two-part request, await dial-back."""
        info = self.instances.get(instance_id)
        if info is None:
            raise RuntimeError(
                f"unknown instance {instance_id:x} for {self.endpoint.path}")
        rt = self.endpoint.runtime
        ctx = request if isinstance(request, Context) else Context(request)
        rx = rt.tcp.register()
        try:
            rx, prologue = await self._dispatch_with_retry(
                rt, rx, ctx, info, instance_id)
        except Exception:
            rt.tcp.unregister(rx.stream_id)
            raise
        if prologue.error is not None:
            rt.tcp.unregister(rx.stream_id)
            raise RuntimeError(f"remote rejected request: {prologue.error}")
        return _RemoteStream(ctx.ctx, rx, self.decode_resp, rt.tcp)

    DIAL_BACK_TIMEOUT = 10.0
    DISPATCH_ATTEMPTS = 3

    async def _dispatch_with_retry(self, rt, rx, ctx, info, instance_id):
        """Publish the two-part request and await the worker's dial-back,
        retrying the failure modes a daemon restart creates:

        - publish reaches ZERO receivers (the worker's serve subscription
          is mid-re-establishment) — NATS "no responders" semantics;
        - publish reached a receiver that died before dialing back (the
          message sat in a killed session's queue) — dial-back timeout,
          re-dispatch on a fresh stream.

        Re-dispatch is at-least-once: a slow-but-alive worker could end up
        serving the request twice, with the client consuming only the last
        stream — the same contract as the reference's NATS request plane.
        (Fire-and-forget requests are deduped worker-side by id —
        runtime/ingress.py.)"""
        loop = asyncio.get_running_loop()
        last_err: Exception = RuntimeError("dispatch failed")
        for attempt in range(self.DISPATCH_ATTEMPTS):
            conn = rt.tcp.connection_info(rx)
            # deadline propagation: put the REMAINING budget on the wire
            # (re-sampled per attempt — a retried dispatch must not
            # resurrect budget already burned waiting)
            ctrl = RequestControlMessage(id=ctx.id, connection_info=conn,
                                         deadline_ms=ctx.ctx.remaining_ms(),
                                         tenant=ctx.ctx.tenant,
                                         priority=ctx.ctx.qos)
            payload = encode_two_part(ctrl, self.encode_req(ctx.data))
            deadline = loop.time() + self.DIAL_BACK_TIMEOUT
            delay = 0.05
            try:
                while True:   # no-responders backoff within this attempt
                    n = await rt.bus.publish(info.subject, payload)
                    if n is None or n > 0:  # None: bus without counts
                        break
                    if loop.time() >= deadline:
                        raise RuntimeError(
                            f"no responders on {info.subject} "
                            f"(instance {instance_id:x})")
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, 0.5)
                prologue = await rx.wait_connected(
                    timeout=max(deadline - loop.time(), 1.0))
                return rx, prologue
            except (TimeoutError, asyncio.TimeoutError, RuntimeError) as e:
                last_err = e
                if attempt + 1 >= self.DISPATCH_ATTEMPTS:
                    # the caller's cleanup unregisters ITS original rx —
                    # the retry streams registered here must not leak
                    # (unregister is idempotent, double-pop is fine)
                    rt.tcp.unregister(rx.stream_id)
                    raise
                logger.warning(
                    "dispatch to %s attempt %d failed (%s); retrying on a "
                    "fresh stream", self.endpoint.path, attempt + 1, e)
                rt.tcp.unregister(rx.stream_id)
                rx = rt.tcp.register()
        raise last_err

    # -------------------------------------------------------------- scrape
    async def collect_stats(self) -> Dict[int, Any]:
        """Scrape per-instance stats records (reference ServiceClient
        ``collect_services`` via NATS $SRV.STATS; ours ride the KV store —
        same data, discovery-backed transport)."""
        rt = self.endpoint.runtime
        prefix = (f"{self.endpoint.namespace}/stats/"
                  f"{self.endpoint.component}/{self.endpoint.name}:")
        out: Dict[int, Any] = {}
        for e in await rt.store.kv_get_prefix(prefix):
            try:
                out[int(e.key.rsplit(":", 1)[-1], 16)] = json.loads(e.value)
            except Exception:
                continue
        return out

    async def close(self) -> None:
        if self._watch_task is not None:
            self._watch_task.cancel()
        if self._watcher is not None:
            self._watcher.close()
