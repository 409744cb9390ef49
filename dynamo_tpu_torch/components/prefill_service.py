"""Prefill-as-a-service: a prefill fleet that publishes prefix KV to the
object tier.

Counterpart of ``dynamo_tpu.components.prefill_service``. A ``--role
prefill-publish`` worker pulls :class:`PrefillPublishRequest` items from
the ``prefill_publish`` work queue (and answers the same op over a direct
endpoint RPC), prefills each prompt on its own engine and publishes the
prompt's full blocks to the object store under ``--kv-remote-dir``
(``EngineCore.publish_prefix_to_remote``). There is no decode sink and no
handoff stream: the handoff is the durable store, which any decode engine
on the same root admits from through its cascade, priced by its own
admission gate.

Unlike the disaggregated ``PrefillWorker`` (``llm/disagg.py``), which
serves one decode worker's request in flight, this role warms a shared
tier for whole fleets. The JAX service's request tracing is not here (a
request's ``trace`` is carried and ignored, ROADMAP A10).
"""

from __future__ import annotations

import asyncio
import logging
from collections import OrderedDict
from typing import Optional

from ..engine.core import FINISH_SENTINEL, EngineRequest
from ..engine.sampling import SlotSampling
from ..llm.disagg import PrefillQueue
from ..llm.protocols.disagg import PrefillPublishRequest
from ..runtime.engine import AsyncEngine, ManyOut, ResponseStream

logger = logging.getLogger("dynamo_tpu_torch.components.prefill_service")

__all__ = ["PrefillService", "PREFILL_PUBLISH_QUEUE",
           "PREFILL_PUBLISH_ENDPOINT"]

PREFILL_PUBLISH_QUEUE = "prefill_publish"
PREFILL_PUBLISH_ENDPOINT = "prefill_publish"


class PrefillService(AsyncEngine):
    """One prefill-publish worker: a queue consumer and a direct RPC
    server.

    Ops (a JSON dict in, a JSON dict out):
    - ``publish``: {"token_ids": [...], "sampling": {...}} → prefill,
      publish the prefix, reply {"hashes": [...], "published": n,
      "first_token": t, "prefix_hit_tokens": h}.
    - ``status``: the queue's depth and the publish counters.
    """

    MAX_DELIVERIES = 3
    # the prompt-sighting ledger's bound: past it the coldest entries age
    # out (their counts restart)
    MAX_TRACKED_PROMPTS = 4096

    def __init__(self, core, runtime,
                 queue: Optional[PrefillQueue] = None,
                 publish_min_hits: int = 2):
        if core.remote_store is None or core.remote_store.object is None:
            raise ValueError(
                "--role prefill-publish needs the durable object tier — "
                "start with --kv-remote-dir pointing at the fleet-shared "
                "root")
        self.core = core
        self.runtime = runtime
        self.queue = queue or PrefillQueue(runtime,
                                           name=PREFILL_PUBLISH_QUEUE)
        # the queue path's policy (a direct publish() or RPC always runs):
        # a prompt publishes on exactly its publish_min_hits-th sighting,
        # so one-shot prompts never churn the store, and an in-flight set
        # keeps a herd of equal enqueues to one prefill
        self.publish_min_hits = max(int(publish_min_hits), 1)
        self._prompt_hits: "OrderedDict[int, int]" = OrderedDict()
        self._publishing: set = set()
        self._task: Optional[asyncio.Task] = None
        self._inflight: set = set()
        self._stopping = False
        self.publishes_done = 0
        self.publishes_failed = 0
        self.blocks_published = 0
        self.publish_skips = 0

    async def publish(self, token_ids, sampling: Optional[dict] = None,
                      rid: str = "publish") -> dict:
        """Prefill ``token_ids`` on the local engine and publish the
        prompt's full blocks to the object tier. A warm chain is a device
        hit (no prefill) and its puts are skipped (content-addressed)."""
        req = EngineRequest(
            rid=rid, prompt=[int(t) for t in token_ids],
            sampling=SlotSampling(**(sampling or {})),
            max_new_tokens=1, eos_ids=frozenset())
        await self.core.submit(req)
        first_token = None
        while True:
            # bounded: a wedged engine fails the publish, not the worker
            out, _ = await asyncio.wait_for(req.out_queue.get(),
                                            timeout=600.0)
            if out is FINISH_SENTINEL:
                break
            first_token = out
        if req.seq is None:
            raise RuntimeError(f"publish request {rid} was never admitted")
        n = await self.core.publish_prefix_to_remote(req.seq)
        self.blocks_published += n
        return {"ok": True,
                "hashes": [int(h) for h in req.seq.sequence_hashes],
                "published": n,
                "first_token": first_token,
                "prefix_hit_tokens": req.prefix_hit_tokens}

    async def _handle(self, d: dict) -> dict:
        op = d.get("op", "publish")
        if op == "publish":
            try:
                r = await self.publish(d.get("token_ids", []),
                                       d.get("sampling"),
                                       rid=d.get("request_id", "publish"))
                self.publishes_done += 1
                return r
            except Exception as e:  # noqa: BLE001 — per-request isolation
                self.publishes_failed += 1
                logger.exception("prefill publish failed")
                return {"ok": False, "error": str(e)}
        if op == "status":
            try:
                depth = await self.queue.depth()
            except Exception:  # noqa: BLE001 — the queue may not exist yet
                depth = 0
            return {"ok": True, "queue_depth": depth, **self.stats()}
        return {"ok": False, "error": f"unknown prefill op {op!r}"}

    async def generate(self, request) -> ManyOut:
        resp = await self._handle(request.data)
        return ResponseStream.from_iterable([resp], request.ctx)

    async def start(self) -> "PrefillService":
        self._stopping = False
        self._task = asyncio.get_running_loop().create_task(
            self._loop(), name="prefill-publish")
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
                logger.warning("prefill-publish dequeue failed (%s); "
                               "retrying in %.1fs", e, backoff)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 10.0)
                continue
            if item is None:
                continue
            t = asyncio.get_running_loop().create_task(
                self._handle_item(item), name=f"prefill-publish-{item.id}")
            self._inflight.add(t)
            t.add_done_callback(self._inflight.discard)

    def _publish_decision(self, token_ids) -> tuple:
        """(publish?, key): the publish_min_hits-th sighting of a prompt
        publishes; earlier ones (too rare), later ones (already durable)
        and herd duplicates of one in flight skip."""
        key = hash(tuple(int(t) for t in token_ids))
        hits = self._prompt_hits.pop(key, 0) + 1
        self._prompt_hits[key] = hits
        while len(self._prompt_hits) > self.MAX_TRACKED_PROMPTS:
            self._prompt_hits.popitem(last=False)
        if key in self._publishing:
            return False, key
        return hits == self.publish_min_hits, key

    async def _handle_item(self, item) -> None:
        try:
            ppr = PrefillPublishRequest.from_json(item.payload)
        except Exception:  # noqa: BLE001
            logger.exception("undecodable prefill-publish item %d", item.id)
            await self.queue.ack(item.id)
            return
        publish, key = self._publish_decision(ppr.token_ids)
        if not publish:
            self.publish_skips += 1
            await self.queue.ack(item.id)
            return
        self._publishing.add(key)
        try:
            r = await self._handle({"op": "publish",
                                    "request_id": ppr.request_id,
                                    "token_ids": ppr.token_ids,
                                    "sampling": ppr.sampling})
            if not r["ok"]:
                raise RuntimeError(r["error"])
            await self.queue.ack(item.id)
        except Exception as e:  # noqa: BLE001 — an engine-level failure
            logger.warning("prefill-publish item %d failed (%s)", item.id, e)
            if item.deliveries >= self.MAX_DELIVERIES:
                await self.queue.ack(item.id)   # bounded: drop poison work
            else:
                # the redelivery is this sighting again, not a later one
                self._prompt_hits[key] = self.publish_min_hits - 1
                await self.queue.nack(item.id)
        finally:
            self._publishing.discard(key)

    def stats(self) -> dict:
        return {"prefill_publishes_done": self.publishes_done,
                "prefill_publishes_failed": self.publishes_failed,
                "prefill_published_blocks_total": self.blocks_published,
                "prefill_publish_skipped_total": self.publish_skips,
                "inflight": len(self._inflight)}

    async def drain(self) -> None:
        """Stop pulling new items and finish the publishes in flight (an
        object put is never cut: tmp → fsync → rename)."""
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
