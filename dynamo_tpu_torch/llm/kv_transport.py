"""Device-to-device KV plane for PD disaggregation.

Counterpart of ``dynamo_tpu.llm.kv_transport``. The reference moves KV
blocks engine to engine with NIXL RDMA so the handoff never touches host
Python. Here a prefill engine and a decode engine in ONE process share the
card (or sit on two cards of one host), so the handoff is the prefill
engine's gather output handed over as device tensors and copied into the
decode engine's pool in place (``scatter_blocks_device``), never staged
through the host. The TCP wire path (``llm/disagg.py``) remains the
cross-process fallback.

Ordering on the card: the gather runs on the prefill engine's compute
stream with an event recorded behind it (``block_copy.Gather.ready``); the
decode engine's stream waits on that event before its scatter, the payload
tensors are marked as used on that stream (``record_stream``), and the
decode engine drops the payload once the scatter is enqueued, so the
prefill engine's memory is not held for the request's life.

Rendezvous: the decode side registers a sink future keyed by request id
before enqueueing the prefill work and advertises this process's token in
``RemotePrefillRequest.device_bridge``; a prefill worker in the same
process deposits the device payload here and sends only a control frame
over the response plane (keeping the timeout and fallback control flow).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

logger = logging.getLogger("dynamo_tpu_torch.llm.kv_transport")

__all__ = ["PROC_TOKEN", "DeviceKvPayload", "DeviceKvBridge", "bridge",
           "scatter_blocks_device"]

# identity of this process's bridge: a prefill worker seeing this token in
# a request knows the decode engine shares its process
PROC_TOKEN = uuid.uuid4().hex


@dataclasses.dataclass
class DeviceKvPayload:
    """A KV handoff that never left the device: the block-major gather
    output straight from the prefill engine's pool."""

    request_id: str
    first_token: object             # a [1] tensor on the prefill engine's
    first_logprob: object           # device: never fetched on that side
    seq_hashes: List[int]
    stacked: Dict[str, torch.Tensor]  # {"k": [L, n, bs, C], "v": ...}
    n_blocks: int
    block_size: int
    ready: object = None            # CUDA event behind the gather (or None)


class DeviceKvBridge:
    """In-process rendezvous: decode registers a sink, prefill deposits.

    ``park`` / ``take_parked`` are the JAX package's follower-rank deposit
    for a multihost decode engine (ROADMAP A9); no port engine parks yet."""

    # parked payloads pin gathered KV on the card; entries whose admission
    # never arrives are evicted by age, far beyond any decode-side timeout
    PARK_TTL_S = 300.0

    def __init__(self) -> None:
        self._sinks: Dict[str, asyncio.Future] = {}
        self._parked: "OrderedDict[str, tuple]" = OrderedDict()
        self._park_lock = threading.Lock()
        self.deposits = 0
        self.misses = 0
        self.park_evictions = 0

    def register(self, request_id: str) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        self._sinks[request_id] = fut
        return fut

    def deposit(self, request_id: str, payload: DeviceKvPayload) -> bool:
        """True if a sink was waiting (decode takes the device path)."""
        fut = self._sinks.pop(request_id, None)
        if fut is None or fut.done():
            self.misses += 1
            return False
        fut.set_result(payload)
        self.deposits += 1
        return True

    def cancel(self, request_id: str) -> None:
        fut = self._sinks.pop(request_id, None)
        if fut is not None and not fut.done():
            fut.cancel()

    def park(self, request_id: str, payload: DeviceKvPayload) -> None:
        """Hold a payload until an admission claims it; entries older than
        ``PARK_TTL_S`` are evicted."""
        now = time.monotonic()
        with self._park_lock:
            self._parked[request_id] = (payload, now)
            self.deposits += 1
            while self._parked:
                rid, (_, t) = next(iter(self._parked.items()))
                if now - t <= self.PARK_TTL_S:
                    break
                self._parked.popitem(last=False)
                self.park_evictions += 1
                logger.warning(
                    "evicting parked device payload rid=%s (unclaimed "
                    "for >%ss)", rid, self.PARK_TTL_S)

    def take_parked(self, request_id: str) -> Optional[DeviceKvPayload]:
        with self._park_lock:
            got = self._parked.pop(request_id, None)
        return got[0] if got is not None else None


# constructed at import: one bridge a process
_BRIDGE: DeviceKvBridge = DeviceKvBridge()


def bridge() -> DeviceKvBridge:
    return _BRIDGE


def scatter_blocks_device(kv, target_ids, payload: DeviceKvPayload,
                          skip_blocks: int, n_needed: int) -> None:
    """Copy a device payload's blocks ``[skip_blocks:n_needed]`` into this
    engine's pool at ``target_ids``, device to device and in place (the
    decode programs' CUDA graphs hold the pool tensors' addresses). On the
    card the current stream first waits for the payload's gather."""
    from ..engine.block_copy import scatter_blocks
    vals = {k: v[:, skip_blocks:n_needed] for k, v in payload.stacked.items()}
    pool = next(iter(kv.values()))
    if pool.is_cuda:
        stream = torch.cuda.current_stream(pool.device)
        if payload.ready is not None:
            stream.wait_event(payload.ready)
        for v in payload.stacked.values():
            if v.device == pool.device:
                v.record_stream(stream)
        vals = {k: v.to(pool.device, non_blocking=True)
                for k, v in vals.items()}
    scatter_blocks(kv, target_ids, vals, payload.block_size)
