"""Fleet KV fabric: peer-to-peer block transfer and latency-aware
admission.

Counterpart of ``dynamo_tpu.llm.kv.fabric``, the transport half of the
remote tier (``remotestore.py``): every worker serves its own host- and
disk-resident blocks at a ``kv_fabric`` endpoint beside its serving
endpoint, and a worker whose cascade bottoms out locally fetches a prefix
from whichever peer announced it (the tier-tagged ``kv_events`` the router
reads feed the hash → holder index), onboards it through the engine's
off-loop onboard, and decodes as a local recompute would.

- :class:`PeerLinkTable`: measured link costs, probed at attach (RTT and
  bandwidth) and refined by every transfer (decay average), with a
  :class:`CircuitBreaker` a peer.
- :class:`AdmissionGate`: a remote hit is promoted only when the modeled
  fetch (RTT + bytes / bandwidth) beats the modeled recompute (depth /
  the engine's measured prefill rate, :class:`PrefillRateEstimator`).
- :class:`KvFabricServer` / :class:`KvFabric`: the RPC plane. Blocks
  travel as ``remotestore.pack_block_bytes`` npz bytes over the data
  plane: the request names the hashes and a dial-back address, and the
  serving peer streams one two-part frame a block through
  ``runtime/tcp.open_stream_sender`` (the C++ sender unless
  ``DYN_NATIVE_DATAPLANE=0``). ``DYN_KV_FABRIC_DATAPLANE=0`` makes the
  serving side decline that op, and the fetching side then takes the
  base64-over-JSON ``fetch`` op, counted in ``dataplane_fallbacks_total``:
  a protocol choice between two paths with byte-identical payloads.

What differs from the JAX package: a fetch returns per-block dicts
(``fetch_blocks_async``; ``fetch_async`` stacks them into the JAX wire
layout); ``fetch_sync`` refuses to run on the loop it would wait on; the
data plane's library raises where it does not build (no quiet fallback);
the failpoints and request tracing (the JAX fetches' ``trace_ctx``) wait
for ROADMAP A7.7 and A10; the gate's layer-stream variants
(``modeled_fetch_overlap_s``, ``crossover_blocks_overlap``), which only
the JAX package's fleet simulator reads, are not here.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

from ...runtime.codec import ConnectionInfo, FrameKind
from ...runtime.engine import AsyncEngine, Context, ManyOut, ResponseStream
from .remotestore import (RemoteKvStore, pack_block_bytes, stack_wire,
                          unpack_block_bytes)

logger = logging.getLogger("dynamo_tpu_torch.kv.fabric")

__all__ = ["FABRIC_ENDPOINT", "LinkStats", "PeerLinkTable", "AdmissionGate",
           "PrefillRateEstimator", "KvFabricServer", "KvFabric",
           "CircuitBreaker", "dataplane_serving_available"]

FABRIC_ENDPOINT = "kv_fabric"
PROBE_BYTES = 256 * 1024
# DYN_KV_FABRIC_DATAPLANE=0 makes a serving peer decline fetch_native and
# probe_native (the fetching side then rides the JSON op)
DATAPLANE_ENV = "DYN_KV_FABRIC_DATAPLANE"


def dataplane_serving_available() -> bool:
    """Whether this process serves data-plane fetches: the env gate alone
    decides. With the C++ sender selected its library must build (it
    raises otherwise; the JAX package declines instead)."""
    if os.environ.get(DATAPLANE_ENV, "1") == "0":
        return False
    if os.environ.get("DYN_NATIVE_DATAPLANE", "1") != "0":
        from ...runtime.native_tcp import load_data_plane_lib
        load_data_plane_lib()
    return True


# ---------------------------------------------------------------------------
# Link-cost model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LinkStats:
    """Decay-averaged link estimate for one peer (or the object store)."""

    rtt_s: float = 1e-3
    gbps: float = 1.0
    samples: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class CircuitBreaker:
    """A peer's circuit breaker: consecutive failures (or, with
    ``latency_slo_s``, consecutive transfers slower than it) trip it open
    (no fetch traffic, no admission credit); after ``cooldown_s`` it is
    half-open (one trial fetch); the trial's success closes it, its
    failure re-opens it. ``now`` is injectable."""

    def __init__(self, failure_threshold: int = 3,
                 cooldown_s: float = 30.0,
                 latency_slo_s: Optional[float] = None,
                 now=time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.latency_slo_s = latency_slo_s
        self._now = now
        self.state = "closed"             # closed | open | half_open
        self.consecutive_failures = 0
        self.slow_streak = 0
        self.trips_total = 0
        self._opened_at = 0.0
        self._trial_inflight = False

    def _trip(self) -> None:
        if self.state != "open":
            self.trips_total += 1
        self.state = "open"
        self._opened_at = self._now()
        self._trial_inflight = False

    def _refresh(self) -> None:
        if (self.state == "open"
                and self._now() - self._opened_at >= self.cooldown_s):
            self.state = "half_open"
            self._trial_inflight = False

    def would_allow(self) -> bool:
        """Could a fetch go here now? Never takes the half-open trial."""
        self._refresh()
        if self.state == "closed":
            return True
        if self.state == "open":
            return False
        return not self._trial_inflight

    def allow(self) -> bool:
        """As :meth:`would_allow`, but a half-open True claims the one
        trial, released by record_success / record_failure."""
        if not self.would_allow():
            return False
        if self.state == "half_open":
            self._trial_inflight = True
        return True

    def record_success(self, latency_s: Optional[float] = None) -> None:
        self._trial_inflight = False
        self.consecutive_failures = 0
        if (self.latency_slo_s is not None and latency_s is not None
                and latency_s > self.latency_slo_s):
            # slower than the SLO: a brownout sample, not a recovery
            self.slow_streak += 1
            if self.state == "half_open":
                self._trip()
            elif self.slow_streak >= self.failure_threshold:
                self._trip()
            return
        self.slow_streak = 0
        if self.state in ("half_open", "open"):
            self.state = "closed"

    def record_failure(self) -> None:
        self._trial_inflight = False
        self.consecutive_failures += 1
        if self.state == "half_open":
            self._trip()
        elif self.consecutive_failures >= self.failure_threshold:
            self._trip()

    def describe(self) -> dict:
        return {"state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "slow_streak": self.slow_streak,
                "trips_total": self.trips_total}


class PeerLinkTable:
    """Measured per-peer link costs: probed at attach, then each transfer
    folds into an exponential moving average (alpha 0.3). A tripped
    peer's holdings price as a dead link (the gate rejects)."""

    ALPHA = 0.3

    def __init__(self, default_gbps: float = 1.0,
                 default_rtt_s: float = 1e-3,
                 breaker_failure_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 breaker_latency_slo_s: Optional[float] = None,
                 now=time.monotonic):
        self.default = LinkStats(rtt_s=default_rtt_s, gbps=default_gbps)
        self._links: Dict[int, LinkStats] = {}
        self._now = now
        self._breaker_kw = dict(
            failure_threshold=breaker_failure_threshold,
            cooldown_s=breaker_cooldown_s,
            latency_slo_s=breaker_latency_slo_s)
        self._breakers: Dict[int, CircuitBreaker] = {}
        # what a fully tripped holder set prices as
        self._dead = LinkStats(rtt_s=float("inf"), gbps=0.0)

    def get(self, worker_id: Optional[int]) -> LinkStats:
        if worker_id is None:
            return self.default
        return self._links.get(worker_id, self.default)

    def _entry(self, worker_id: int) -> LinkStats:
        link = self._links.get(worker_id)
        if link is None:
            link = LinkStats(rtt_s=self.default.rtt_s,
                             gbps=self.default.gbps)
            self._links[worker_id] = link
        return link

    def observe_rtt(self, worker_id: int, rtt_s: float) -> None:
        link = self._entry(worker_id)
        if link.samples == 0:
            link.rtt_s = rtt_s
        else:
            link.rtt_s += self.ALPHA * (rtt_s - link.rtt_s)
        link.samples += 1

    def observe_transfer(self, worker_id: int, nbytes: int,
                         seconds: float) -> None:
        if seconds <= 0 or nbytes <= 0:
            return
        link = self._entry(worker_id)
        gbps = nbytes / seconds / 1e9
        if link.samples == 0:
            link.gbps = gbps
        else:
            link.gbps += self.ALPHA * (gbps - link.gbps)
        link.samples += 1

    def drop(self, worker_id: int) -> None:
        self._links.pop(worker_id, None)
        self._breakers.pop(worker_id, None)

    def breaker(self, worker_id: int) -> CircuitBreaker:
        b = self._breakers.get(worker_id)
        if b is None:
            b = CircuitBreaker(now=self._now, **self._breaker_kw)
            self._breakers[worker_id] = b
        return b

    def usable(self, worker_id: int) -> bool:
        """False while the peer's breaker is open (the RemoteKvStore
        ``peer_usable`` plug); never claims the half-open trial."""
        return self.breaker(worker_id).would_allow()

    def record_success(self, worker_id: int,
                       latency_s: Optional[float] = None) -> None:
        self.breaker(worker_id).record_success(latency_s)

    def record_failure(self, worker_id: int) -> None:
        self.breaker(worker_id).record_failure()

    def open_breaker_count(self) -> int:
        return sum(1 for b in self._breakers.values()
                   if b.state != "closed")

    def breaker_trips_total(self) -> int:
        return sum(b.trips_total for b in self._breakers.values())

    def breaker_snapshot(self) -> Dict[int, dict]:
        return {wid: b.describe() for wid, b in self._breakers.items()}

    def link_for_holders(self, holders: Sequence[Sequence[int]]) -> LinkStats:
        """The link a matched run's fetch would ride: the first untripped
        peer holder's, the object store's default when every block is
        object-held, a dead link when every holder is tripped."""
        any_peer = False
        for hs in holders:
            for wid in hs:
                any_peer = True
                b = self._breakers.get(wid)
                if b is None or b.would_allow():
                    return self.get(wid)
        return self._dead if any_peer else self.default

    def avg_gbps(self) -> float:
        if not self._links:
            return self.default.gbps
        return sum(lk.gbps for lk in self._links.values()) / len(self._links)

    def avg_rtt_s(self) -> float:
        if not self._links:
            return self.default.rtt_s
        return sum(lk.rtt_s for lk in self._links.values()) / len(self._links)

    def snapshot(self) -> Dict[int, dict]:
        return {wid: lk.to_dict() for wid, lk in self._links.items()}


# ---------------------------------------------------------------------------
# Latency-aware admission
# ---------------------------------------------------------------------------


class PrefillRateEstimator:
    """The gate's recompute side: an age-weighted measured prefill rate.
    The first ``warmup_samples`` admissions (a young engine's: kernel
    builds, graph captures) are left out and the rate reads 0.0, unknown,
    which the gate admits on; later admissions decay-average (EMA)."""

    def __init__(self, warmup_samples: int = 2, alpha: float = 0.3):
        self.warmup_samples = int(warmup_samples)
        self.alpha = float(alpha)
        self.samples = 0
        self.warmup_skipped = 0
        self._rate = 0.0

    def observe(self, tokens: int, wall_s: float) -> None:
        if tokens <= 0 or wall_s <= 0:
            return
        self.samples += 1
        if self.samples <= self.warmup_samples:
            self.warmup_skipped += 1
            return
        r = tokens / wall_s
        if self._rate <= 0:
            self._rate = r
        else:
            self._rate += self.alpha * (r - self._rate)

    def rate(self) -> float:
        """tok/s; 0.0 until the warm-up has passed."""
        return self._rate


class AdmissionGate:
    """Promote a remote hit only when the modeled fetch beats the modeled
    recompute at that depth:

    - fetch(n)     = rtt + n · bytes_per_block / bandwidth
    - recompute(n) = n · block_size / prefill_tok_per_s

    ``prefill_tok_per_s`` may be a callable (the engine's measured rate);
    an unknown rate (0) admits. ``mode``: "auto" (the model), "always" /
    "never" (overrides)."""

    def __init__(self, bytes_per_block: int, block_size: int,
                 prefill_tok_per_s, mode: str = "auto"):
        if mode not in ("auto", "always", "never"):
            raise ValueError(f"unknown admission mode {mode!r}")
        self.bytes_per_block = int(bytes_per_block)
        self.block_size = int(block_size)
        self._prefill_rate = prefill_tok_per_s
        self.mode = mode
        self.accepts_total = 0
        self.rejects_total = 0

    def prefill_tok_per_s(self) -> float:
        rate = self._prefill_rate
        return float(rate() if callable(rate) else rate)

    def modeled_fetch_s(self, n_blocks: int, link: LinkStats) -> float:
        if link.gbps <= 0:
            return float("inf")
        return link.rtt_s + n_blocks * self.bytes_per_block / (link.gbps
                                                               * 1e9)

    def modeled_recompute_s(self, n_blocks: int) -> float:
        rate = self.prefill_tok_per_s()
        if rate <= 0:
            return float("inf")          # unknown rate: admit
        return n_blocks * self.block_size / rate

    def admit(self, n_blocks: int, link: LinkStats) -> bool:
        if self.mode == "always":
            self.accepts_total += 1
            return True
        if self.mode == "never":
            self.rejects_total += 1
            return False
        ok = (self.modeled_fetch_s(n_blocks, link)
              < self.modeled_recompute_s(n_blocks))
        if ok:
            self.accepts_total += 1
        else:
            self.rejects_total += 1
        return ok

    def crossover_blocks(self, link: LinkStats) -> float:
        """The hit depth (blocks) from which the fetch pays: rtt /
        (per-block recompute − per-block transfer); inf when it never
        does."""
        rate = self.prefill_tok_per_s()
        if rate <= 0:
            return 0.0
        if link.gbps <= 0:
            return float("inf")
        per_block_gain = (self.block_size / rate
                          - self.bytes_per_block / (link.gbps * 1e9))
        if per_block_gain <= 0:
            return float("inf")
        return link.rtt_s / per_block_gain


# ---------------------------------------------------------------------------
# RPC plane: a worker's kv_fabric endpoint
# ---------------------------------------------------------------------------


class KvFabricServer(AsyncEngine):
    """Serves this worker's host- and disk-resident blocks to the fleet.

    Ops (a JSON dict in, a JSON dict out):
    - ``probe``: echo ``nbytes`` of payload (RTT with 0, bandwidth with a
      large one); ``probe_native``: stream ``nbytes`` over the data plane.
    - ``match``: which of ``hashes`` this worker can serve.
    - ``fetch_native``: stream one DATA frame a block (the hash in the
      header, the npz bytes as data) to the caller's dial-back ``conn``;
      declined with ``fallback`` under ``DYN_KV_FABRIC_DATAPLANE=0``.
    - ``fetch``: the same npz bytes, base64 in the reply.

    Missing hashes are reported, never fatal (the caller recomputes).
    File reads, packing and base64 run off the loop."""

    def __init__(self, core):
        self.core = core
        self.fetches_served = 0
        self.blocks_served = 0
        self.probes_served = 0
        self.dataplane_fetches_served = 0

    def _pin_host(self, hashes: Sequence[int]) -> Dict[int, tuple]:
        """On the loop: ``{hash: (slot, tokens_hash, parent_hash)}`` of the
        host-resident ``hashes``, their slots pinned. The write-back pump
        stores (and evicts) on the loop, so a slot resolved and pinned
        here keeps its hash's rows until ``_unpin_host``."""
        host = self.core.kv_manager.host_pool
        if host is None:
            return {}
        held = {}
        for h in hashes:
            slot = host.slot_of(h)
            if slot is not None:
                held[h] = (slot, *host.meta_for(h))
        host.pin([s for s, _th, _ph in held.values()])
        return held

    def _unpin_host(self, held: Dict[int, tuple]) -> None:
        if held:
            self.core.kv_manager.host_pool.unpin(
                [s for s, _th, _ph in held.values()])

    def _read_block(self, seq_hash: int,
                    held: Dict[int, tuple]) -> Optional[bytes]:
        """One packed block from the local tiers, disk first, else the
        host slot ``held`` pinned for it (a worker thread)."""
        disk = self.core.disk_store
        if disk is not None and disk.contains(seq_hash):
            disk.pin([seq_hash])
            try:
                values = disk.read_block(seq_hash)
                th, ph = disk.meta_for(seq_hash)
            except KeyError:
                values = None
            finally:
                disk.unpin([seq_hash])
            if values is not None:
                return pack_block_bytes(values, th, ph)
        if seq_hash not in held:
            return None
        slot, th, ph = held[seq_hash]
        return pack_block_bytes(
            self.core.kv_manager.host_pool.row_copy(slot), th, ph)

    def _serveable(self, seq_hash: int) -> bool:
        disk = self.core.disk_store
        host = self.core.kv_manager.host_pool
        return ((disk is not None and disk.contains(seq_hash))
                or (host is not None and host.contains(seq_hash)))

    def _read_all(self, hashes: Sequence[int], held: Dict[int, tuple]):
        """({hash: bytes}, [missing]), shared by both transports."""
        blocks, missing = {}, []
        for h in hashes:
            data = self._read_block(h, held)
            if data is None:
                missing.append(h)
            else:
                blocks[h] = data
        return blocks, missing

    async def _dial(self, conn: dict):
        from ...runtime.tcp import open_stream_sender
        try:
            return await open_stream_sender(ConnectionInfo.from_dict(conn),
                                            timeout=5.0)
        except (OSError, asyncio.TimeoutError):
            # the caller's server is unreachable: it falls back to JSON
            logger.warning("fabric dial-back to %s failed",
                           conn.get("address"), exc_info=True)
            return None

    async def _stream_native(self, conn: dict, hashes: Sequence[int],
                             blocks: Dict[int, bytes]) -> bool:
        """Dial the caller back and stream a frame a block. False when the
        dial-back failed (the caller rides JSON); a failure mid-stream
        reaches the caller as a torn stream (it recomputes)."""
        sender = await self._dial(conn)
        if sender is None:
            return False
        try:
            for h in hashes:
                await sender.send(blocks[h],
                                  header=json.dumps({"h": int(h)}).encode())
            await sender.finish()
        except Exception as e:  # noqa: BLE001 — torn stream: caller recomputes
            logger.warning("fabric data-plane stream failed mid-fetch: %s", e)
            try:
                await sender.finish(error=str(e))
            except Exception:  # noqa: BLE001
                pass
        return True

    async def _probe_stream(self, conn: dict, nbytes: int) -> bool:
        """Stream ``nbytes`` to the prober over the data plane, the path
        fetches ride. False when the dial-back failed."""
        sender = await self._dial(conn)
        if sender is None:
            return False
        chunk = bytes(min(max(nbytes, 1), 1 << 18))
        sent = 0
        try:
            while sent < nbytes:
                part = chunk[:nbytes - sent]
                await sender.send(part, header=b"{}")
                sent += len(part)
            await sender.finish()
        except Exception as e:  # noqa: BLE001 — torn probe: prober times out
            logger.warning("fabric probe stream failed: %s", e)
            try:
                await sender.finish(error=str(e))
            except Exception:  # noqa: BLE001
                pass
        return True

    async def _handle(self, d: dict) -> dict:
        op = d.get("op")
        if op == "probe":
            self.probes_served += 1
            return {"ok": True, "payload": "0" * int(d.get("nbytes", 0))}
        if op == "probe_native":
            self.probes_served += 1
            if not await asyncio.to_thread(dataplane_serving_available):
                return {"ok": True, "fallback": "json"}
            n = int(d.get("nbytes", 0))
            if not await self._probe_stream(d.get("conn") or {}, n):
                return {"ok": True, "fallback": "json"}
            return {"ok": True, "dataplane": True, "nbytes": n}
        if op == "match":
            hashes = [int(h) for h in d.get("hashes", [])]
            return {"ok": True,
                    "resident": [self._serveable(h) for h in hashes]}
        if op in ("fetch", "fetch_native"):
            hashes = [int(h) for h in d.get("hashes", [])]
            native = op == "fetch_native"
            if native and not await asyncio.to_thread(
                    dataplane_serving_available):
                return {"ok": True, "fallback": "json"}
            held = self._pin_host(hashes)
            try:
                blocks, missing = await asyncio.to_thread(self._read_all,
                                                          hashes, held)
            finally:
                self._unpin_host(held)
            if missing:
                return {"ok": True, "blocks": {}, "missing": missing}
            if native:
                if not await self._stream_native(d.get("conn") or {},
                                                 hashes, blocks):
                    return {"ok": True, "fallback": "json"}
                self.fetches_served += 1
                self.dataplane_fetches_served += 1
                self.blocks_served += len(blocks)
                return {"ok": True, "dataplane": True,
                        "blocks": len(blocks), "missing": []}
            self.fetches_served += 1
            self.blocks_served += len(blocks)
            enc = await asyncio.to_thread(
                lambda: {str(h): base64.b64encode(b).decode()
                         for h, b in blocks.items()})
            return {"ok": True, "blocks": enc, "missing": []}
        return {"ok": False, "error": f"unknown fabric op {op!r}"}

    async def generate(self, request) -> ManyOut:
        resp = await self._handle(request.data)
        return ResponseStream.from_iterable([resp], request.ctx)

    def stats(self) -> dict:
        return {"fabric_fetches_served": self.fetches_served,
                "fabric_blocks_served": self.blocks_served}


# ---------------------------------------------------------------------------
# One worker's view of the fabric
# ---------------------------------------------------------------------------


class KvFabric:
    """``attach`` serves the worker's ``kv_fabric`` endpoint, starts the
    peer client (discovery-watched), subscribes the component's
    ``kv_events`` to feed the hash → holder index, probes every live
    peer, and hands the engine a :class:`RemoteKvStore` behind its
    cascade."""

    FETCH_TIMEOUT_S = 60.0
    RPC_TIMEOUT_S = 15.0

    def __init__(self, store: RemoteKvStore, links: PeerLinkTable,
                 gate: AdmissionGate, worker_id: Optional[int] = None,
                 runtime=None):
        self.store = store
        self.links = links
        self.gate = gate
        self.worker_id = worker_id
        self.server: Optional[KvFabricServer] = None
        self.client = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[int] = None
        self._runtime = runtime       # its stream server takes dial-backs
        self._sub = None
        self._tasks: List[asyncio.Task] = []
        self._known_peers: set = set()
        self.peer_fetches_total = 0
        self.peer_fetched_bytes_total = 0
        self.peer_fetch_seconds_total = 0.0
        self.dataplane_fetches_total = 0
        self.dataplane_fallbacks_total = 0
        self.probe_fallbacks_total = 0
        self.use_dataplane = os.environ.get(DATAPLANE_ENV, "1") != "0"
        store.peer_fetch = self.fetch_sync
        store.admission = self._admit
        store.peer_usable = links.usable

    def bind_loop(self) -> None:
        """Take the running loop as the one ``fetch_sync`` submits to."""
        self._loop = asyncio.get_running_loop()
        self._loop_thread = threading.get_ident()

    @classmethod
    async def attach(cls, core, runtime, endpoint,
                     default_gbps: float = 1.0,
                     probe_peers: bool = True) -> "KvFabric":
        """Build and wire a fabric for ``core`` beside its serving
        ``endpoint`` (the fabric's is ``dyn://{ns}/{comp}/kv_fabric``)."""
        component = runtime.namespace(endpoint.namespace).component(
            endpoint.component)
        fabric_ep = component.endpoint(FABRIC_ENDPOINT)
        store = core.remote_store
        if store is None:
            store = RemoteKvStore()       # peer-only fabric: no object dir
        gate = AdmissionGate(
            bytes_per_block=core.kv_bytes_per_block(),
            block_size=core.cfg.kv_block_size,
            prefill_tok_per_s=core.measured_prefill_tok_per_s,
            mode=core.cfg.kv_remote_admission)
        self = cls(store, PeerLinkTable(default_gbps=default_gbps), gate,
                   runtime=runtime)
        self.bind_loop()
        self.server = KvFabricServer(core)
        await fabric_ep.serve(self.server, decode_req=json.loads)
        self.worker_id = (await runtime.primary_lease()).id
        self.client = fabric_ep.client()
        self.client.on_instances_changed = self._instances_changed
        await self.client.start()
        self._known_peers = {wid for wid in self.client.instance_ids()
                             if wid != self.worker_id}
        self._sub = await component.subscribe_event("kv_events")
        self._tasks.append(asyncio.get_running_loop().create_task(
            self._event_loop(), name="kv-fabric-events"))
        core.attach_kv_fabric(self)
        if probe_peers:
            for wid in list(self._known_peers):
                await self._probe_safe(wid)
        logger.info("kv fabric attached: worker %x, %d live peer(s)",
                    self.worker_id, len(self._known_peers))
        return self

    def _instances_changed(self, present: set) -> None:
        present = {wid for wid in present if wid != self.worker_id}
        for gone in self._known_peers - present:
            self.store.forget_peer(gone)
            self.links.drop(gone)
        new = present - self._known_peers
        self._known_peers = present
        for wid in new:
            self._tasks.append(asyncio.get_running_loop().create_task(
                self._probe_safe(wid), name=f"kv-fabric-probe-{wid:x}"))

    async def _probe_safe(self, wid: int) -> None:
        try:
            await self.probe(wid)
        except Exception:  # noqa: BLE001 — a dark peer is not fatal
            logger.warning("fabric probe of peer %x failed", wid)

    async def _event_loop(self) -> None:
        from ..kv_router.protocols import RouterEvent
        async for msg in self._sub:
            try:
                ev = RouterEvent.from_dict(json.loads(msg.payload))
            except Exception:  # noqa: BLE001
                continue
            if ev.worker_id == self.worker_id or ev.worker_id < 0:
                continue
            # only the tiers a peer's fabric server can serve
            if ev.stored is not None and getattr(
                    ev.stored, "tier", "device") in ("host", "disk"):
                self.store.note_peer_stored(ev.worker_id,
                                            ev.stored.block_hashes)
            if ev.removed is not None:
                self.store.note_peer_removed(ev.worker_id,
                                             ev.removed.block_hashes)

    # -------------------------------------------------------------- probes
    async def _call(self, worker_id: int, payload: dict) -> dict:
        async def call_once() -> dict:
            stream = await self.client.direct(Context(payload), worker_id)
            async for item in stream:
                if not item.get("ok"):
                    raise RuntimeError(item.get("error",
                                                "fabric call failed"))
                return item
            raise RuntimeError(
                "fabric peer closed the stream without a reply")

        # bounded: a partitioned peer fails this admission in
        # RPC_TIMEOUT_S, not in the transport's worst case
        try:
            return await asyncio.wait_for(call_once(), self.RPC_TIMEOUT_S)
        except (asyncio.TimeoutError, TimeoutError):
            raise RuntimeError(
                f"fabric call to peer {worker_id:x} timed out after "
                f"{self.RPC_TIMEOUT_S:.0f}s (partitioned?)") from None

    async def _drain_frames(self, rx, worker_id: int, timeout: float,
                            what: str):
        """Yield the DATA frames of a dial-back stream to its SENTINEL;
        KeyError on a timeout or an ERROR frame (a torn stream)."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while True:
            f = await rx.next_frame(
                timeout=max(deadline - loop.time(), 0.001))
            if f is None:
                raise KeyError(f"data-plane {what} from peer {worker_id:x} "
                               f"timed out after {timeout:.0f}s")
            if f.kind == FrameKind.DATA:
                yield f
            elif f.kind == FrameKind.SENTINEL:
                return
            elif f.kind == FrameKind.ERROR:
                raise KeyError(
                    f"data-plane {what} from peer {worker_id:x} tore "
                    f"mid-stream: "
                    f"{f.header_json().get('error', 'stream error')}")

    async def _probe_native(self, worker_id: int,
                            nbytes: int) -> Optional[tuple]:
        """Bandwidth probe over the data plane, the path fetches ride:
        (bytes received, wall s), or None when the peer declined."""
        rt = self._runtime
        if rt is None or not self.use_dataplane:
            return None
        await rt.tcp.start()
        rx = rt.tcp.register()
        try:
            t0 = time.monotonic()
            r = await self._call(worker_id, {
                "op": "probe_native", "nbytes": int(nbytes),
                "conn": rt.tcp.connection_info(rx).to_dict()})
            if not r.get("dataplane"):
                return None
            got = 0
            async for f in self._drain_frames(rx, worker_id,
                                              self.RPC_TIMEOUT_S, "probe"):
                got += len(f.data)
            return got, time.monotonic() - t0
        finally:
            rx.close()
            rt.tcp.unregister(rx.stream_id)

    async def probe(self, worker_id: int,
                    nbytes: int = PROBE_BYTES) -> LinkStats:
        """A zero-payload round trip (RTT), then a bulk transfer
        (bandwidth) over the data plane, or over the request plane's echo
        when the peer declines; both decay-averaged into the table."""
        t0 = time.monotonic()
        await self._call(worker_id, {"op": "probe", "nbytes": 0})
        rtt = time.monotonic() - t0
        self.links.observe_rtt(worker_id, rtt)
        native = None
        try:
            native = await self._probe_native(worker_id, nbytes)
        except (KeyError, RuntimeError, OSError):
            logger.warning("data-plane probe of peer %x failed; falling "
                           "back to the request-plane echo", worker_id,
                           exc_info=True)
        if native is not None:
            got, dt = native
            # the control RPC's round trip rides inside dt
            self.links.observe_transfer(worker_id, got,
                                        max(dt - rtt, 1e-6))
            return self.links.get(worker_id)
        self.probe_fallbacks_total += 1
        t0 = time.monotonic()
        r = await self._call(worker_id, {"op": "probe", "nbytes": nbytes})
        self.links.observe_transfer(worker_id, len(r.get("payload", "")),
                                    time.monotonic() - t0)
        return self.links.get(worker_id)

    # ------------------------------------------------------------- fetches
    async def _fetch_blobs_native(self, worker_id: int,
                                  seq_hashes: Sequence[int]) -> Optional[List[bytes]]:
        """Data-plane fetch: the packed bytes in request order; None when
        the peer declined (the caller rides JSON); KeyError on missing
        hashes or a torn or timed-out stream (the caller recomputes)."""
        rt = self._runtime
        if rt is None:
            return None
        await rt.tcp.start()
        rx = rt.tcp.register()
        try:
            r = await self._call(worker_id, {
                "op": "fetch_native",
                "hashes": [int(h) for h in seq_hashes],
                "conn": rt.tcp.connection_info(rx).to_dict()})
            if r.get("missing"):
                raise KeyError(f"peer {worker_id:x} no longer holds "
                               f"{len(r['missing'])} requested block(s)")
            if not r.get("dataplane"):
                return None
            by_hash: Dict[int, bytes] = {}
            async for f in self._drain_frames(rx, worker_id,
                                              self.FETCH_TIMEOUT_S, "fetch"):
                by_hash[int(f.header_json()["h"])] = f.data
            try:
                blobs = [by_hash[int(h)] for h in seq_hashes]
            except KeyError:
                raise KeyError(
                    f"data-plane fetch from peer {worker_id:x} ended with "
                    f"{len(by_hash)}/{len(seq_hashes)} block frames")
            self.dataplane_fetches_total += 1
            return blobs
        finally:
            rx.close()
            rt.tcp.unregister(rx.stream_id)

    async def _fetch_blobs_json(self, worker_id: int,
                                seq_hashes: Sequence[int]) -> List[bytes]:
        """The request-plane fetch: base64 in the reply."""
        r = await self._call(worker_id, {
            "op": "fetch", "hashes": [int(h) for h in seq_hashes]})
        if r.get("missing"):
            raise KeyError(f"peer {worker_id:x} no longer holds "
                           f"{len(r['missing'])} requested block(s)")
        blocks = r["blocks"]
        return await asyncio.to_thread(
            lambda: [base64.b64decode(blocks[str(int(h))])
                     for h in seq_hashes])

    async def fetch_blocks_async(self, worker_id: int,
                                 seq_hashes: Sequence[int]) -> List[dict]:
        """One peer fetch for a run of blocks → per-block dicts ``{key:
        [L, H, bs, D]}``. KeyError when the peer cannot serve every hash
        or the stream tears (the caller recomputes). Every outcome feeds
        the peer's circuit breaker; a success its link estimate."""
        t0 = time.monotonic()
        if not self.links.breaker(worker_id).allow():
            raise KeyError(f"peer {worker_id:x} circuit breaker is open")
        try:
            blobs = None
            if self.use_dataplane:
                blobs = await self._fetch_blobs_native(worker_id, seq_hashes)
                if blobs is None:
                    self.dataplane_fallbacks_total += 1
            if blobs is None:
                blobs = await self._fetch_blobs_json(worker_id, seq_hashes)
            # npz decode is bulk CPU work: off the loop
            blocks = await asyncio.to_thread(
                lambda: [unpack_block_bytes(b)[0] for b in blobs])
        except Exception:
            # a torn payload is a peer-quality signal too
            self.links.record_failure(worker_id)
            raise
        elapsed = time.monotonic() - t0
        nbytes = sum(len(b) for b in blobs)
        self.links.record_success(worker_id, elapsed)
        self.links.observe_transfer(worker_id, nbytes, elapsed)
        self.peer_fetches_total += 1
        self.peer_fetched_bytes_total += nbytes
        self.peer_fetch_seconds_total += elapsed
        return blocks

    async def fetch_async(self, worker_id: int,
                          seq_hashes: Sequence[int]) -> dict:
        """``fetch_blocks_async`` stacked into the wire layout ``{key:
        [L, H, n, bs, D]}`` (the JAX package's return)."""
        return stack_wire(await self.fetch_blocks_async(worker_id,
                                                        seq_hashes))

    def fetch_sync(self, worker_id: int,
                   seq_hashes: Sequence[int]) -> List[dict]:
        """The RemoteKvStore ``peer_fetch`` plug, called from the
        onboard's thread: it submits the fetch to the fabric's loop and
        waits. Called on that loop's own thread it would wait on itself,
        so it raises there."""
        if self._loop is None:
            raise KeyError("fabric not attached")
        if threading.get_ident() == self._loop_thread:
            raise RuntimeError("KvFabric.fetch_sync called on the loop it "
                               "waits on")
        fut = asyncio.run_coroutine_threadsafe(
            self.fetch_blocks_async(worker_id, seq_hashes),
            self._loop)
        try:
            return fut.result(timeout=self.FETCH_TIMEOUT_S)
        except Exception as e:
            fut.cancel()
            if isinstance(e, KeyError):
                raise
            raise KeyError(f"fabric fetch from peer {worker_id:x} "
                           f"failed: {e}") from e

    def _admit(self, n_blocks: int,
               holders: Sequence[Sequence[int]]) -> bool:
        return self.gate.admit(n_blocks,
                               self.links.link_for_holders(holders))

    # --------------------------------------------------------------- stats
    def metrics(self) -> dict:
        """The ``remote_*`` ForwardPassMetrics slice."""
        s = self.store
        return {
            "remote_used_blocks": s.used_blocks,
            "remote_capacity_blocks": s.capacity,
            "remote_peer_blocks": s.peer_block_count(),
            "remote_stored_total": s.stored_blocks_total,
            "remote_hit_rate": s.hit_rate(),
            "remote_fetch_failures_total": s.fetch_failures_total,
            "remote_admission_rejects_total": s.admission_rejects_total,
            "remote_link_gbps": self.links.avg_gbps(),
            "remote_link_rtt_s": self.links.avg_rtt_s(),
            "remote_dataplane_fetches_total": self.dataplane_fetches_total,
            "remote_dataplane_fallbacks_total":
                self.dataplane_fallbacks_total,
            "remote_breaker_open_peers": self.links.open_breaker_count(),
            "remote_breaker_trips_total": self.links.breaker_trips_total(),
        }

    def stats(self) -> dict:
        """The launcher's stop-time summary: the metrics slice, the served
        side's counters, the peer fetches' bytes and seconds, the probe
        fallbacks and the link table."""
        d = dict(self.metrics())
        if self.server is not None:
            d.update(self.server.stats())
        d.update(peer_fetches_total=self.peer_fetches_total,
                 peer_fetched_bytes_total=self.peer_fetched_bytes_total,
                 peer_fetch_seconds_total=self.peer_fetch_seconds_total,
                 probe_fallbacks_total=self.probe_fallbacks_total,
                 links={f"{w:x}": v for w, v in self.links.snapshot().items()})
        return d

    async def close(self) -> None:
        if self._sub is not None:
            self._sub.close()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        if self.client is not None:
            await self.client.close()
