"""Distributed runtime: Namespace → Component → Endpoint naming, discovery
via the KV store, a bus request plane, and a TCP response plane.

A copy of ``dynamo_tpu.runtime.distributed``, the analog of the
reference's ``DistributedRuntime``
(lib/runtime/src/distributed.rs) and component model
(lib/runtime/src/component.rs, component/{endpoint,client,service}.rs):

- Every process owns one ``DistributedRuntime``: a KV store client (etcd
  analog), a message-bus client (NATS analog), and a lazily-started TCP
  stream server for the response plane.
- Serving an endpoint = claim bus subject ``{ns}|{comp}.{ep}-{lease:x}`` and
  write discovery key ``{ns}/components/{comp}/{ep}:{lease:x}`` under the
  process's primary lease (component/endpoint.rs:110-137). Lease expiry
  deletes the key → clients drop the instance (SURVEY.md §5.3).
- Calling an endpoint = watch the discovery prefix for live instances,
  pick one (random / round-robin / direct, component/client.rs:181-244),
  register a local response stream, push the two-part request over the bus,
  and await the worker's TCP dial-back (egress/push.rs:88-156).

Requests/responses are serialized with pluggable serde callables so the LLM
protocol layer (dataclasses) and tests (plain dicts) share the same plane.

Module layout (mirroring the reference's component/*.rs): naming +
discovery records in :mod:`.component`, the serving side in
:mod:`.ingress`, the calling side in :mod:`.egress`. This module holds the
per-process runtime and re-exports the public surface.
"""

from __future__ import annotations

import asyncio
import logging
import os
import uuid
from typing import Callable, List, Optional

from .bus import MemoryBus, MessageBus
from .component import (Component, ComponentEndpointInfo, Endpoint,
                        Namespace, json_serde)
from .egress import Client
from .ingress import EndpointServer
from .kvstore import KvStore, Lease, MemoryKvStore
from .tcp import TcpStreamServer

logger = logging.getLogger("dynamo_tpu_torch.runtime.distributed")

__all__ = [
    "DistributedRuntime",
    "Namespace",
    "Component",
    "Endpoint",
    "EndpointServer",
    "Client",
    "ComponentEndpointInfo",
    "json_serde",
]


class DistributedRuntime:
    """One per process. Owns transports + the primary lease."""

    # etcd-style liveness TTL; generous enough that a long first-use kernel
    # build or graph capture on the same event loop can't starve the
    # keepalive (refresh runs every TTL/3)
    LEASE_TTL = float(os.environ.get("DYN_LEASE_TTL", "10.0"))

    def __init__(self, store: KvStore, bus: MessageBus,
                 tcp_host: str = "127.0.0.1",
                 advertise: Optional[str] = None):
        self.store = store
        self.bus = bus
        self.tcp = TcpStreamServer(tcp_host, advertise)
        self.worker_uuid = uuid.uuid4().hex
        self._primary_lease: Optional[Lease] = None
        self._lease_lock = asyncio.Lock()
        self._servers: List[EndpointServer] = []
        self.on_lease_lost: Optional[Callable[[], None]] = None
        self._closed = False

    @classmethod
    def in_process(cls) -> "DistributedRuntime":
        """Single-process runtime: memory store + bus (the test/devel mode;
        also what a one-host aggregated deployment uses)."""
        return cls(MemoryKvStore(), MemoryBus())

    @classmethod
    async def connect(cls, server_addr: str,
                      advertise: Optional[str] = None) -> "DistributedRuntime":
        """Multi-process runtime: TCP clients to the discovery/bus daemon
        (runtime/server.py)."""
        from .netstore import NetBus, NetKvStore
        store = await NetKvStore.connect(server_addr)
        bus = await NetBus.connect(server_addr)
        return cls(store, bus, advertise=advertise)

    async def primary_lease(self) -> Lease:
        # double-checked lock (DL008): two concurrent first callers would
        # otherwise BOTH mint a lease — one becomes an orphan with a live
        # keepalive and the worker's identity is whichever won the write
        if self._primary_lease is None:
            async with self._lease_lock:
                if self._primary_lease is None:
                    lease = await self.store.lease_create(self.LEASE_TTL)
                    lease.on_lost = self._lease_lost
                    lease.start_keepalive()
                    self._primary_lease = lease
        return self._primary_lease

    def _lease_lost(self) -> None:
        logger.error("primary lease lost — shutting down runtime")
        if self.on_lease_lost is not None:
            self.on_lease_lost()

    @property
    def worker_id(self) -> int:
        """Numeric instance id = primary lease id (the reference uses the
        etcd lease id as the instance identity everywhere)."""
        if self._primary_lease is None:
            raise RuntimeError("no primary lease yet (serve an endpoint first)")
        return self._primary_lease.id

    def namespace(self, name: str) -> Namespace:
        return Namespace(self, name)

    async def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        for srv in list(self._servers):
            await srv.stop()
        lease, self._primary_lease = self._primary_lease, None
        if lease is not None:   # claimed before the await (DL008)
            await lease.revoke()
        await self.tcp.close()
        await self.bus.close()
        await self.store.close()
