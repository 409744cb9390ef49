"""PD disaggregation: conditional remote prefill, the prefill queue, the
decode-side engine wrapper, and the prefill worker.

Counterpart of ``dynamo_tpu.llm.disagg``, on the port's own runtime and
engine:

- ``DisaggregatedRouter`` (reference lib/llm/src/disagg_router.rs): remote
  iff ``(prefill_len - prefix_hit_len) > max_local_prefill_length``, the
  threshold live-reconfigurable through a watch of the runtime's KV store.
- ``PrefillQueue``: the bus work queue (at-least-once, ack / nack), the
  analog of the reference's NATS JetStream prefill queue.
- ``DisaggEngine``: the decode side. Per request it decides local or
  remote prefill; a remote one registers a KV sink stream, enqueues the
  prefill work and admits the request with the shipped KV.
- ``PrefillWorker``: pulls the queue, runs each prefill with a handoff on
  its own engine and sends the KV back to the decode worker's sink.

The KV crosses on one of three planes: the device plane
(``llm/kv_transport.py``: a prefill worker in the decode worker's process
hands over the gathered blocks as device tensors and sends a control frame
only), the wire with the whole payload, or the wire layer by layer
(``llm/kv/stream.py``; ``DYN_DISAGG_LAYER_STREAM=0`` forces the whole
payload). Remote prefill is an optimization: any failure (no prefill
worker, a timeout, a transfer error) falls back to a local prefill on the
decode engine, so disaggregation never loses a request. Request tracing
spans (``runtime/tracing``) are not ported (ROADMAP A10).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
import time
from typing import Optional

from ..engine.core import FINISH_SENTINEL, EngineCore, EngineRequest
from ..runtime.codec import ConnectionInfo, FrameKind
from ..runtime.distributed import DistributedRuntime
from ..runtime.engine import ManyOut, SingleIn
from ..runtime.kvstore import WatchEventType
from ..runtime.tcp import open_stream_sender
from .engines.torch_engine import TorchEngine
from .kv.blocks import TokenBlockSequence
from .kv.stream import (LAYER_KIND, MANIFEST_KIND, LayeredHarvest,
                        LayerStreamManifest, LayerStreamPayload,
                        decode_layer_frame, send_layer_stream,
                        send_monolithic_payload)
from .kv_transport import PROC_TOKEN, DeviceKvPayload, bridge
from .protocols.disagg import (KvPayload, RemotePrefillRequest,
                               decode_kv_payload)

logger = logging.getLogger("dynamo_tpu_torch.llm.disagg")

__all__ = ["DisaggregatedRouter", "PrefillQueue", "DisaggEngine",
           "PrefillWorker", "PREFILL_QUEUE", "disagg_config_key"]

PREFILL_QUEUE = "prefill_queue"


def disagg_config_key(model_name: str, kind: str = "chat") -> str:
    """The KV-store key of a model's threshold (the reference's etcd path,
    disagg_router.rs:38-140)."""
    return f"public/components/disagg_router/models/{kind}/{model_name}"


class DisaggregatedRouter:
    """Local-vs-remote prefill decision with a live-watched threshold."""

    def __init__(self, runtime: DistributedRuntime, model_name: str,
                 max_local_prefill_length: int = 512,
                 conditional: bool = True):
        self.runtime = runtime
        self.model_name = model_name
        self.max_local_prefill_length = max_local_prefill_length
        self.conditional = conditional
        # while the prefill fleet drains, every prefill runs local
        self.prefill_draining = False
        self._watch_task: Optional[asyncio.Task] = None
        self._watcher = None

    def prefill_remote(self, prefill_len: int, prefix_hit_len: int) -> bool:
        """Remote iff the un-cached prefill exceeds the local threshold."""
        if self.prefill_draining:
            return False
        if not self.conditional:
            return True
        return (prefill_len - prefix_hit_len) > self.max_local_prefill_length

    async def start(self) -> "DisaggregatedRouter":
        """Load the stored threshold and watch for live updates."""
        key = disagg_config_key(self.model_name)
        entry = await self.runtime.store.kv_get(key)
        if entry is not None:
            self._apply(entry.value)
        self._watcher = await self.runtime.store.watch_prefix(key)
        self._watch_task = asyncio.get_running_loop().create_task(
            self._watch_loop(), name="disagg-router-watch")
        return self

    def _apply(self, raw: bytes) -> None:
        try:
            cfg = json.loads(raw)
            self.max_local_prefill_length = int(
                cfg["max_local_prefill_length"])
            self.prefill_draining = bool(cfg.get("draining", False))
            logger.info("disagg threshold for %s → %d%s", self.model_name,
                        self.max_local_prefill_length,
                        " (prefill fleet draining)" if self.prefill_draining
                        else "")
        except (ValueError, KeyError, TypeError):
            logger.warning("bad disagg config update ignored: %r", raw)

    async def _watch_loop(self) -> None:
        async for ev in self._watcher:
            if ev.type == WatchEventType.PUT:
                self._apply(ev.entry.value)

    async def publish_threshold(self, value: int,
                                draining: bool = False) -> None:
        """The admin write of the live reconfiguration."""
        await self.runtime.store.kv_put(
            disagg_config_key(self.model_name),
            json.dumps({"max_local_prefill_length": value,
                        "draining": draining}).encode())

    async def stop(self) -> None:
        task, self._watch_task = self._watch_task, None
        if self._watcher is not None:
            self._watcher.close()
            self._watcher = None
        if task is not None:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)


class PrefillQueue:
    """A thin wrapper over the bus work queue."""

    def __init__(self, runtime: DistributedRuntime,
                 name: str = PREFILL_QUEUE):
        self.runtime = runtime
        self.name = name
        self._q = None

    async def _queue(self):
        if self._q is None:
            # racing first callers bind the SAME named queue (work_queue
            # is idempotent by name)
            self._q = await self.runtime.bus.work_queue(self.name)
        return self._q

    async def enqueue(self, req: RemotePrefillRequest) -> int:
        q = await self._queue()
        return await q.enqueue(req.to_json())

    async def dequeue(self, timeout: Optional[float] = None,
                      ack_deadline: float = 60.0):
        q = await self._queue()
        return await q.dequeue(timeout=timeout, ack_deadline=ack_deadline)

    async def ack(self, item_id: int) -> None:
        q = await self._queue()
        await q.ack(item_id)

    async def nack(self, item_id: int) -> None:
        q = await self._queue()
        await q.nack(item_id)

    async def depth(self) -> int:
        q = await self._queue()
        return await q.depth()


class DisaggEngine(TorchEngine):
    """Decode-side engine: per request, local or remote prefill; a remote
    one registers a KV sink stream, enqueues the prefill work, and admits
    the request with the shipped KV."""

    def __init__(self, core: EngineCore, runtime: DistributedRuntime,
                 disagg_router: DisaggregatedRouter,
                 queue: Optional[PrefillQueue] = None,
                 prefill_timeout: float = 30.0,
                 device_plane: bool = True,
                 layer_stream: Optional[bool] = None):
        super().__init__(core)
        self.runtime = runtime
        self.disagg_router = disagg_router
        self.queue = queue or PrefillQueue(runtime)
        self.prefill_timeout = prefill_timeout
        # advertise the in-process device plane to prefill workers; False
        # forces the wire even in one process
        self.device_plane = device_plane
        # consume layer streams on the wire plane (default on;
        # DYN_DISAGG_LAYER_STREAM=0 forces the monolithic payload)
        self.layer_stream = (layer_stream if layer_stream is not None
                             else os.environ.get(
                                 "DYN_DISAGG_LAYER_STREAM", "1") != "0")
        self.remote_prefills = 0
        self.local_prefills = 0
        self.remote_failures = 0
        self.device_transfers = 0   # handoffs over the device plane
        self.stream_transfers = 0   # handoffs that arrived layer-streamed
        # one frame pump per in-flight layer stream; each owns its
        # receiver's cleanup (see _spawn_stream_drain)
        self._drain_tasks: set = set()

    def _estimate_prefix_hit(self, req: EngineRequest) -> int:
        """Hold-free device-pool prefix estimate, in tokens. The hash chain
        stays on the request, so admission does not hash the prompt
        again."""
        bs = self.core.cfg.kv_block_size
        req.seq = TokenBlockSequence(bs, req.prompt)
        n = self.core.kv_manager.pool.peek_prefix(req.seq.sequence_hashes)
        return n * bs

    async def generate(self, request: SingleIn) -> ManyOut:
        req = self.build_request(request)
        hit = self._estimate_prefix_hit(req)
        if self.disagg_router.prefill_remote(len(req.prompt), hit):
            payload = await self._remote_prefill(req, hit)
            if payload is not None:
                req.precomputed = payload
                self.remote_prefills += 1
            else:
                self.remote_failures += 1
                self.local_prefills += 1
        else:
            self.local_prefills += 1
        await self.core.submit(req)
        return self.stream_response(req, request)

    async def _remote_prefill(self, req: EngineRequest, hit: int):
        rt = self.runtime
        await rt.tcp.start()
        rx = rt.tcp.register()
        sink = bridge().register(req.rid)   # the device plane's rendezvous
        rpr = RemotePrefillRequest(
            request_id=req.rid, token_ids=list(req.prompt),
            sampling=dataclasses.asdict(req.sampling),
            connection_info=rt.tcp.connection_info(rx).to_dict(),
            engine_id=rt.worker_uuid, prefix_hit_tokens=hit,
            device_bridge=PROC_TOKEN if self.device_plane else "",
            deadline_ms=(req.ctx.remaining_ms()
                         if req.ctx is not None
                         and hasattr(req.ctx, "remaining_ms") else None),
            layer_stream=self.layer_stream)
        handed_off = False
        try:
            await self.queue.enqueue(rpr)
            prologue = await rx.wait_connected(timeout=self.prefill_timeout)
            if prologue.error is not None:
                raise RuntimeError(prologue.error)
            loop = asyncio.get_running_loop()
            deadline = loop.time() + self.prefill_timeout
            meta_header: Optional[bytes] = None
            chunks: list = []
            while True:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    raise TimeoutError("kv payload timeout")
                f = await rx.next_frame(timeout=remaining)
                if f is None:
                    continue
                if f.kind == FrameKind.DATA:
                    if f.header:
                        h = json.loads(f.header)
                        if h.get("stream") == MANIFEST_KIND:
                            # a layer stream: admit against the manifest
                            # NOW; a drain task keeps consuming frames
                            # while the engine scatters them
                            payload = LayerStreamPayload(
                                LayerStreamManifest.from_header(h))
                            self._spawn_stream_drain(req.rid, rx, payload)
                            handed_off = True
                            self.stream_transfers += 1
                            return payload
                        meta_header = f.header
                    chunks.append(f.data)
                elif f.kind == FrameKind.ERROR:
                    raise RuntimeError(f.header_json().get("error", "remote"))
                elif f.kind == FrameKind.SENTINEL:
                    if meta_header is None:
                        raise RuntimeError("stream ended without payload")
                    meta = json.loads(meta_header)
                    if meta.get("device_deposit"):
                        # the blocks took the device plane; the deposit
                        # happened before this control frame
                        if not sink.done():
                            raise RuntimeError(
                                "device-deposit frame without deposit")
                        self.device_transfers += 1
                        return sink.result()
                    data = b"".join(chunks)
                    return await asyncio.to_thread(decode_kv_payload,
                                                   meta_header, data)
        except Exception as e:  # noqa: BLE001 — any failure → local fallback
            logger.warning("remote prefill failed for %s (%s); "
                           "falling back to local", req.rid, e)
            return None
        finally:
            if not handed_off:
                bridge().cancel(req.rid)
                rx.close()
                rt.tcp.unregister(rx.stream_id)

    def _spawn_stream_drain(self, rid: str, rx, payload) -> None:
        """The frame → payload pump of one layer stream; the stream's
        cleanup (bridge rendezvous, receiver, registration) moves here
        from _remote_prefill, since the stream outlives that call."""
        rt = self.runtime

        async def drain() -> None:
            mono_header: Optional[bytes] = None
            chunks: list = []
            try:
                while True:
                    f = await rx.next_frame(timeout=self.prefill_timeout)
                    if f is None:
                        continue
                    if f.kind == FrameKind.DATA:
                        h = json.loads(f.header) if f.header else None
                        if h is not None and h.get("stream") == LAYER_KIND:
                            payload.put_layer(
                                int(h["layer"]),
                                decode_layer_frame(payload.manifest,
                                                   f.data))
                        else:
                            # the producer tore a frame and degraded to
                            # the monolithic payload on this same stream
                            if f.header:
                                mono_header = f.header
                            chunks.append(f.data)
                    elif f.kind == FrameKind.ERROR:
                        payload.fail(f.header_json().get("error", "remote"))
                        return
                    elif f.kind == FrameKind.SENTINEL:
                        if mono_header is not None:
                            mono = decode_kv_payload(mono_header,
                                                     b"".join(chunks))
                            payload.put_all(mono.values)
                        payload.finish()
                        return
            except Exception as e:  # noqa: BLE001 — dead peer, short frame
                # → the engine's cold-recompute rung, never an error
                payload.fail(str(e))
            finally:
                bridge().cancel(rid)
                rx.close()
                rt.tcp.unregister(rx.stream_id)

        t = asyncio.get_running_loop().create_task(
            drain(), name=f"kv-stream-drain-{rid}")
        self._drain_tasks.add(t)
        t.add_done_callback(self._drain_tasks.discard)

    async def stop(self) -> None:
        """Cancel the frame pumps of layer streams still in flight (each
        closes its receiver) and stop the router's watch. The core is the
        caller's to stop."""
        tasks = list(self._drain_tasks)
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await self.disagg_router.stop()

    def stats(self) -> dict:
        return {"remote_prefills": self.remote_prefills,
                "local_prefills": self.local_prefills,
                "remote_failures": self.remote_failures,
                "device_transfers": self.device_transfers,
                "stream_transfers": self.stream_transfers,
                "max_local_prefill_length":
                    self.disagg_router.max_local_prefill_length}


class PrefillWorker:
    """Pulls the prefill queue, runs each prefill with a handoff on its own
    engine, sends the KV to the decode worker's sink, and acks.

    Reference: examples/llm/components/prefill_worker.py. No metadata store
    is needed: the decode worker's sink address travels in the request."""

    MAX_DELIVERIES = 3

    def __init__(self, core: EngineCore, runtime: DistributedRuntime,
                 queue: Optional[PrefillQueue] = None,
                 send_timeout: float = 30.0):
        self.core = core
        self.runtime = runtime
        self.queue = queue or PrefillQueue(runtime)
        self.send_timeout = send_timeout
        self._task: Optional[asyncio.Task] = None
        self._inflight: set = set()
        self._stopping = False
        self.prefills_done = 0
        self.prefills_failed = 0
        self.device_handoffs = 0    # handoffs over the device plane
        self.stream_handoffs = 0    # handoffs sent as layer streams
        self.stream_fallbacks = 0   # streams degraded to monolithic
        # wire handoffs: bytes sent and the seconds from the first
        # device→host fetch to the stream's end
        self.wire_bytes = 0
        self.wire_s = 0.0

    async def start(self) -> "PrefillWorker":
        self._stopping = False
        self._task = asyncio.get_running_loop().create_task(
            self._loop(), name="prefill-worker")
        return self

    async def _loop(self) -> None:
        backoff = 0.5
        while not self._stopping:
            try:
                item = await self.queue.dequeue(timeout=0.5)
                backoff = 0.5
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — transient bus errors
                logger.warning("prefill dequeue failed (%s); retrying in "
                               "%.1fs", e, backoff)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 10.0)
                continue
            if item is None:
                continue
            t = asyncio.get_running_loop().create_task(
                self._handle(item), name=f"prefill-item-{item.id}")
            self._inflight.add(t)
            t.add_done_callback(self._inflight.discard)

    async def _handle(self, item) -> None:
        try:
            rpr = RemotePrefillRequest.from_json(item.payload)
        except Exception:  # noqa: BLE001
            logger.exception("undecodable prefill work item %d", item.id)
            await self.queue.ack(item.id)
            return
        await self._run_prefill(item, rpr)

    async def _run_prefill(self, item, rpr: RemotePrefillRequest) -> None:
        conn = ConnectionInfo.from_dict(rpr.connection_info)
        try:
            sender = await open_stream_sender(conn, timeout=5.0)
        except Exception:  # noqa: BLE001
            # the decode worker is unreachable: retry a bounded number of
            # times, then drop (the decode side falls back on its timeout)
            if item.deliveries >= self.MAX_DELIVERIES:
                logger.warning("dropping prefill item %d after %d "
                               "deliveries", item.id, item.deliveries)
                await self.queue.ack(item.id)
            else:
                await self.queue.nack(item.id)
            return

        sent = asyncio.get_running_loop().create_future()
        # the failure path may abandon `sent`: consume a late exception
        sent.add_done_callback(
            lambda f: None if f.cancelled() else f.exception())
        use_device = rpr.device_bridge == PROC_TOKEN

        async def handoff_wire(tok, logprob, values, seq_hashes) -> None:
            t0 = time.monotonic()
            try:
                if isinstance(values, LayeredHarvest):
                    res = await send_layer_stream(
                        sender, rpr.request_id, tok, logprob, seq_hashes,
                        values)
                    self.stream_handoffs += 1
                    if res["fallback"]:
                        self.stream_fallbacks += 1
                    nbytes = res["bytes"]
                else:
                    nbytes = await send_monolithic_payload(sender, KvPayload(
                        request_id=rpr.request_id, first_token=tok,
                        first_logprob=logprob, seq_hashes=seq_hashes,
                        values=values))
                    await sender.finish()
                self.wire_bytes += nbytes
                self.wire_s += time.monotonic() - t0
                if not sent.done():
                    sent.set_result(True)
            except Exception as e:  # noqa: BLE001
                if not sent.done():
                    sent.set_exception(e)

        async def handoff_device(tok, logprob, dev, seq_hashes) -> None:
            # deposit the device tensors in the process bridge, then tell
            # the decode side over the response plane; if the sink is gone
            # (decode timed out), fall back to the wire
            try:
                stacked = dev["stacked"]
                payload = DeviceKvPayload(
                    request_id=rpr.request_id, first_token=tok,
                    first_logprob=logprob, seq_hashes=seq_hashes,
                    stacked=dict(stacked), n_blocks=dev["n_blocks"],
                    block_size=self.core.cfg.kv_block_size,
                    ready=getattr(stacked, "ready", None))
                if bridge().deposit(rpr.request_id, payload):
                    self.device_handoffs += 1
                    header = json.dumps(
                        {"device_deposit": True,
                         "request_id": rpr.request_id}).encode()
                    await sender.send(b"", header=header)
                    await sender.finish()
                    if not sent.done():
                        sent.set_result(True)
                    return
                from ..engine.block_copy import fetch_wire
                values = await asyncio.to_thread(
                    fetch_wire, stacked, dev["n_blocks"],
                    self.core.wire_kv_heads)
                first = await asyncio.to_thread(
                    lambda: (int(tok.reshape(-1)[0].cpu()),
                             float(logprob.reshape(-1)[0].cpu())))
                await handoff_wire(first[0], first[1], values, seq_hashes)
            except Exception as e:  # noqa: BLE001
                if not sent.done():
                    sent.set_exception(e)

        from ..engine.sampling import SlotSampling
        from ..runtime.engine import EngineContext
        # the decode side's remaining budget on OUR clock; a job whose
        # budget is already gone is dropped unstarted
        ctx = EngineContext(rpr.request_id, deadline_ms=rpr.deadline_ms)
        if ctx.deadline_exceeded:
            await sender.finish(error="deadline exceeded")
            await self.queue.ack(item.id)
            return
        req = EngineRequest(
            rid=rpr.request_id, prompt=list(rpr.token_ids),
            sampling=SlotSampling(**rpr.sampling), max_new_tokens=1,
            eos_ids=frozenset(), ctx=ctx,
            handoff=handoff_device if use_device else handoff_wire,
            handoff_device=use_device,
            handoff_layered=(rpr.layer_stream and not use_device))
        try:
            await self.core.submit(req)
            # drain the engine's signals, then await the send
            while True:
                out, _ = await asyncio.wait_for(req.out_queue.get(),
                                                self.send_timeout)
                if out is FINISH_SENTINEL:
                    break
            await asyncio.wait_for(sent, self.send_timeout)
            await self.queue.ack(item.id)
            self.prefills_done += 1
        except Exception as e:  # noqa: BLE001
            self.prefills_failed += 1
            logger.warning("prefill handoff failed for %s (%s)",
                           rpr.request_id, e)
            # a request still queued or admitted is cancelled: its sink
            # stream is gone, so its prefill would be wasted
            ctx.stop_generating()
            try:
                await sender.finish(error=str(e))
            except Exception:  # noqa: BLE001
                pass
            # the KV was computed but not delivered; the decode side falls
            # back — ack (the sink stream is gone)
            await self.queue.ack(item.id)

    def stats(self) -> dict:
        return {"prefills_done": self.prefills_done,
                "prefills_failed": self.prefills_failed,
                "device_handoffs": self.device_handoffs,
                "stream_handoffs": self.stream_handoffs,
                "stream_fallbacks": self.stream_fallbacks,
                "wire_bytes": self.wire_bytes,
                "wire_s": self.wire_s,
                "inflight": len(self._inflight)}

    async def drain(self) -> None:
        """Stop pulling NEW queue items and let every in-flight prefill
        finish its handoff."""
        self._stopping = True
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self._inflight:
            await asyncio.gather(*list(self._inflight),
                                 return_exceptions=True)

    async def stop(self) -> None:
        self._stopping = True
        if self._task is not None:
            self._task.cancel()
            self._task = None
        for t in list(self._inflight):
            t.cancel()
