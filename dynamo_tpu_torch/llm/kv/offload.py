"""Host-memory KV tier: offloaded prefix blocks in host memory.

Counterpart of ``dynamo_tpu.llm.kv.offload`` (the reference's "KV cache
offload to system memory" pillar: kv/storage.rs ``StorageType::Pinned``
and ``KvStorageManager::prepare_prefill_offload``). Two pieces:

- :class:`HostKvPool`, the arena: one preallocated host tensor per pool key
  of ``[capacity, L, H, bs, D]`` (each block's wire rows, contiguous),
  slots keyed by chained sequence hash, LRU eviction that parks pinned
  candidates, the ``on_evict`` spill hook, and the literal store
  decisions a mirror replays (``apply_store``). With ``pin_memory`` (the
  engine on the card) the arena is pinned, allocated at the first store,
  and the seconds pinning took are logged and kept (``pin_s``).
- :class:`KvOffloadEngine`, the write-back pump: it batches finished
  sequences' full blocks, gathers them on the compute stream, copies them
  into pinned memory on a side stream behind an event
  (``engine/block_copy.start_d2h``), waits for the event in a thread, and
  only then commits them to the pool (``store``); the device holds drop in
  ``_run``'s ``finally``, once the batch has committed or failed.

The arena and every value it takes or returns are torch tensors on the CPU
(bf16 has no numpy dtype here). ``store`` takes JAX's stacked wire values
``[L, H, n, bs, D]`` (a view of rows works); ``fetch`` returns them;
``fetch_rows`` returns (or fills) the rows layout ``[n, L, H, bs, D]``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

logger = logging.getLogger("dynamo_tpu_torch.kv.offload")

__all__ = ["HostKvPool", "KvOffloadEngine", "KvStoreEmitError", "OffloadJob",
           "make_host_pool"]


class HostKvPool:
    """Preallocated host arena of KV blocks keyed by sequence hash.

    Per block the head-major wire rows ``[L, H_kv, bs, D]`` for k and v
    (one ``"kv"`` entry for an MLA latent pool); the device pool is
    block-major, so values are converted before storing
    (``engine/block_copy.py``)."""

    def __init__(self, capacity_blocks: int, num_layers: int,
                 num_kv_heads: int, block_size: int, head_dim: int,
                 dtype=torch.float32, opaque_rows: bool = False,
                 pin_memory: bool = False):
        self.capacity = capacity_blocks
        self.num_kv_heads = num_kv_heads
        self._shape_tail = (num_layers, num_kv_heads, block_size, head_dim)
        self._dtype = dtype
        # opaque_rows (int8 and MLA pools): blocks are whole pool rows
        # shipped as ONE wire "head" whose width is the row width
        self.opaque_rows = opaque_rows
        self.pin_memory = pin_memory
        self.pin_s = 0.0                  # seconds the arena took to pin
        self._arena: Optional[Dict[str, torch.Tensor]] = None
        self._free: List[int] = list(range(capacity_blocks - 1, -1, -1))
        self._by_hash: Dict[int, int] = {}       # seq_hash → slot
        self._lru: Dict[int, None] = {}          # EVICTABLE hashes, LRU order
        # hashes parked out of the eviction queue because their slot was
        # pinned when an eviction considered them; unpin re-queues them
        # (victim selection stays O(1) amortized)
        self._lru_parked: Dict[int, None] = {}
        self._hash_by_slot: Dict[int, int] = {}
        self._pins: Dict[int, int] = {}          # slot → pin count
        # per-hash (tokens_hash, parent_hash), carried to the disk tier
        self._meta: Dict[int, tuple] = {}
        # write-behind spill hook: called with (evicted_hash, tokens_hash,
        # parent_hash, values_copy) BEFORE the arena row is overwritten;
        # values_copy is a fresh per-block dict the callee owns
        self.on_evict: Optional[Callable] = None
        # stats
        self.stored_blocks_total = 0
        self.evicted_blocks_total = 0
        self.match_queries = 0
        self.match_hits = 0
        self.evict_scan_steps = 0   # pinned-candidate requeues

    def __len__(self) -> int:
        return len(self._by_hash)

    def _touch(self, seq_hash: int) -> None:
        """Freshen a resident hash's LRU position. Parked hashes stay
        parked: unpin re-queues them."""
        if seq_hash in self._lru_parked:
            return
        self._lru.pop(seq_hash, None)
        self._lru[seq_hash] = None

    def _place(self, seq_hash: int, slot: int) -> None:
        self._by_hash[seq_hash] = slot
        self._hash_by_slot[slot] = seq_hash
        self._lru_parked.pop(seq_hash, None)
        self._lru[seq_hash] = None

    def _slot_for(self, seq_hash: int):
        """(slot, evicted_hash): the existing slot, else a free or evicted
        one; (None, None) when nothing is placeable (capacity 0, or every
        candidate pinned). A pinned candidate is parked out of the LRU
        queue (re-queued by unpin) instead of being skipped in place."""
        slot = self._by_hash.get(seq_hash)
        if slot is not None:
            self._touch(seq_hash)
            return slot, None
        evicted = None
        if not self._free:
            victim = None
            while self._lru:
                h = next(iter(self._lru))
                if self._pins.get(self._by_hash[h]):
                    self._lru.pop(h)
                    self._lru_parked[h] = None   # park pinned candidate
                    self.evict_scan_steps += 1
                    continue
                victim = h
                break
            if victim is None:       # empty, or everything pinned mid-fetch
                return None, None
            self._lru.pop(victim)
            vslot = self._by_hash.pop(victim)
            self._hash_by_slot.pop(vslot, None)
            self.evicted_blocks_total += 1
            if self.on_evict is not None and self._arena is not None:
                th, ph = self._meta.get(victim, (None, None))
                try:
                    self.on_evict(victim, th, ph, self.row_copy(vslot))
                except Exception:  # noqa: BLE001 — spill is best-effort
                    logger.exception("host-tier evict hook failed")
            self._meta.pop(victim, None)
            self._free.append(vslot)
            evicted = victim
        slot = self._free.pop()
        self._place(seq_hash, slot)
        return slot, evicted

    def store(self, seq_hashes: Sequence[int], values: dict,
              tokens_hashes: Optional[Sequence[int]] = None,
              parent_hashes: Optional[Sequence[Optional[int]]] = None
              ) -> list:
        """Write stacked blocks (``{"k": [L, H, n, bs, D], "v": ...}``; an
        MLA pool ships one ``"kv"`` entry) under their hashes. Returns the
        literal placement decisions ``[(hash, slot, evicted_hash | None)]``
        (capacity may stop early); a mirror replays them with
        ``apply_store``. ``tokens_hashes`` / ``parent_hashes`` ride along
        so a later disk spill keeps the block's chain."""
        decisions = []
        for i, h in enumerate(seq_hashes):
            slot, evicted = self._slot_for(h)
            if slot is None:
                break
            if tokens_hashes is not None:
                self._meta[h] = (tokens_hashes[i],
                                 parent_hashes[i] if parent_hashes
                                 is not None else None)
            self._ensure_arena(values)
            for key, arena in self._arena.items():
                arena[slot].copy_(values[key][:, :, i])
            self.stored_blocks_total += 1
            decisions.append((h, slot, evicted))
        return decisions

    def _ensure_arena(self, values: dict) -> None:
        if self._arena is not None:
            return
        first = next(iter(values.values()))
        # per-block shape: stacked values drop the n axis (store),
        # per-block dicts arrive without it (apply_store)
        blk = (tuple(first.shape[:2]) + tuple(first.shape[3:])
               if first.dim() == 5 else tuple(first.shape))
        L, _h, bs, d = self._shape_tail
        got_d = blk[3]
        d_ok = (d % got_d == 0 if self.opaque_rows else got_d == d)
        if (blk[0], blk[2]) != (L, bs) or not d_ok:
            raise ValueError(
                f"host-tier block shape {tuple(blk)} does not match config "
                f"{self._shape_tail} (heads, and for opaque rows the row "
                f"width, may differ; layers and block size may not)")
        shape = (self.capacity,) + tuple(blk)
        t0 = time.monotonic()
        self._arena = {key: torch.empty(shape, dtype=self._dtype,
                                        pin_memory=self.pin_memory)
                       for key in values}
        self.pin_s = time.monotonic() - t0
        if self.pin_memory:
            nbytes = sum(a.numel() * a.element_size()
                         for a in self._arena.values())
            logger.info("host KV arena: %d blocks, %.1f MiB pinned in "
                        "%.3f s", self.capacity, nbytes / 2**20, self.pin_s)

    def apply_store(self, seq_hash: int, slot: int,
                    evicted_hash: Optional[int],
                    block_values: dict) -> None:
        """Apply one of a leader's literal store decisions to a mirror
        pool: the same hash→slot placement and eviction, the bytes from
        ``block_values`` (key → ONE block ``[L, H, bs, D]``)."""
        if evicted_hash is not None:
            old = self._by_hash.pop(evicted_hash, None)
            self._lru.pop(evicted_hash, None)
            self._lru_parked.pop(evicted_hash, None)
            self._meta.pop(evicted_hash, None)
            if old is not None:
                self._hash_by_slot.pop(old, None)
                if old != slot:
                    self._free.append(old)
            self.evicted_blocks_total += 1
        if self._by_hash.get(seq_hash) != slot:
            try:
                self._free.remove(slot)
            except ValueError:
                pass
        self._place(seq_hash, slot)
        self._ensure_arena(block_values)
        for key, arena in self._arena.items():
            arena[slot].copy_(block_values[key])
        self.stored_blocks_total += 1

    def match_prefix(self, seq_hashes: Sequence[int]) -> List[int]:
        """Longest leading run of hashes present. Returns their slots and
        freshens LRU order."""
        out: List[int] = []
        for h in seq_hashes:
            self.match_queries += 1
            slot = self._by_hash.get(h)
            if slot is None:
                break
            self.match_hits += 1
            self._touch(h)
            out.append(slot)
        return out

    def fetch_rows(self, slots: Sequence[int],
                   out: Optional[dict] = None) -> dict:
        """Rows ``{key: [n, L, H, bs, D]}`` of ``slots`` (into ``out``'s
        tensors where given: a pinned staging buffer on the card)."""
        idx = torch.as_tensor(list(slots), dtype=torch.long)
        if out is None:
            return {key: arena.index_select(0, idx)
                    for key, arena in self._arena.items()}
        for key, arena in self._arena.items():
            torch.index_select(arena, 0, idx, out=out[key])
        return out

    def fetch(self, slots: Sequence[int]) -> dict:
        """Stacked wire values for ``slots``, keyed like the device pool:
        ``{key: [L, H, n, bs, D]}``."""
        return {key: v.permute(1, 2, 0, 3, 4).contiguous()
                for key, v in self.fetch_rows(slots).items()}

    def pin(self, slots: Sequence[int]) -> None:
        """Exclude ``slots`` from LRU eviction while an onboard reads them
        (the pump's stores could otherwise evict and reuse a row
        mid-copy)."""
        for s in slots:
            self._pins[s] = self._pins.get(s, 0) + 1

    def unpin(self, slots: Sequence[int]) -> None:
        for s in slots:
            n = self._pins.get(s, 0) - 1
            if n <= 0:
                self._pins.pop(s, None)
                # re-queue a candidate parked while this slot was pinned
                # (to the LRU back)
                h = self._hash_by_slot.get(s)
                if h is not None and h in self._lru_parked:
                    self._lru_parked.pop(h)
                    self._lru[h] = None
            else:
                self._pins[s] = n

    def contains(self, seq_hash: int) -> bool:
        return seq_hash in self._by_hash

    def meta_for(self, seq_hash: int) -> tuple:
        """(tokens_hash, parent_hash) recorded at store time (None, None
        when the storer carried no chain info)."""
        return self._meta.get(seq_hash, (None, None))

    def hit_rate(self) -> float:
        return self.match_hits / max(self.match_queries, 1)

    def resident_entries(self) -> List[tuple]:
        """Every resident block as (seq_hash, tokens_hash, parent_hash,
        slot): the flush-to-disk inventory."""
        return [(h, *self._meta.get(h, (None, None)), slot)
                for h, slot in self._by_hash.items()]

    def row_copy(self, slot: int) -> dict:
        """A fresh copy of one arena row (``{key: [L, H, bs, D]}``): what a
        spill job owns."""
        return {key: arena[slot].clone()
                for key, arena in self._arena.items()}


def make_host_pool(capacity_blocks: int, model_cfg, block_size: int,
                   kv_quantization: str, pool_row_lanes: int, dtype,
                   pin_memory: bool = False) -> HostKvPool:
    """The one way to build a host pool matched to an engine's device pool
    (the engine and the replayer share it). A full-precision llama pool
    uses the head-major wire layout ``[L, KVH, bs, Dh]``; an int8 pool and
    an MLA latent pool ship whole rows (``pool_row_lanes`` wide) as one
    opaque wire "head": a bit-exact round trip."""
    if kv_quantization != "none":
        return HostKvPool(capacity_blocks, model_cfg.num_layers, 1,
                          block_size, pool_row_lanes, dtype=torch.int8,
                          opaque_rows=True, pin_memory=pin_memory)
    if model_cfg.kv_lora_rank > 0:
        return HostKvPool(capacity_blocks, model_cfg.num_layers, 1,
                          block_size, pool_row_lanes, dtype=dtype,
                          opaque_rows=True, pin_memory=pin_memory)
    return HostKvPool(capacity_blocks, model_cfg.num_layers,
                      model_cfg.num_kv_heads, block_size,
                      model_cfg.head_dim, dtype=dtype, pin_memory=pin_memory)


def requeue(queue: asyncio.Queue) -> asyncio.Queue:
    """A fresh queue holding ``queue``'s items: a pump whose engine is
    restarted on another event loop (another ``asyncio.run``) cannot wait
    on a queue bound to the old one."""
    fresh: asyncio.Queue = asyncio.Queue()
    while not queue.empty():
        fresh.put_nowait(queue.get_nowait())
    return fresh


class KvStoreEmitError(RuntimeError):
    """The ``on_store`` (recorder) emission failed AFTER the host pool
    committed a store: a mirror can no longer be proven identical. Never
    swallowed by the pump's best-effort handler."""


@dataclasses.dataclass
class OffloadJob:
    """Device blocks to write back to the host. The enqueuer pre-holds
    ``block_ids`` in the device pool (an extra refcount) so they cannot be
    reused mid-copy; the pump releases that hold through its
    ``release_holds`` callback once the batch has committed or failed.
    Jobs start at a sequence's block 0, so parent hashes derive as
    [None, seq_hashes[0], seq_hashes[1], ...]."""

    block_ids: List[int]
    seq_hashes: List[int]
    tokens_hashes: Optional[List[int]] = None


class KvOffloadEngine:
    """Asynchronous device→host write-back pump.

    The engine enqueues jobs when sequences finish; the pump batches them,
    gathers once on the compute stream, copies once into pinned memory on
    ``stream`` (the engine's tier stream on the card), waits for the copy
    in a thread, commits, and releases the device holds."""

    def __init__(self, host_pool: HostKvPool, block_size: int,
                 get_kv: Callable[[], dict], num_heads: int,
                 release_holds: Optional[Callable[[List[int]], None]] = None,
                 max_batch_blocks: int = 64,
                 on_store: Optional[Callable[[list], None]] = None,
                 max_queue_jobs: int = 512, stream=None):
        self.host_pool = host_pool
        self.block_size = block_size
        self.get_kv = get_kv
        self.num_heads = num_heads
        self.release_holds = release_holds
        # called with [(hash, slot, evicted_hash, device_block)] after each
        # committed batch, BEFORE the device holds are released (the
        # recorder's kv_store event)
        self.on_store = on_store
        self.max_batch_blocks = max_batch_blocks
        # bounded queue: saturation DROPS the job (its holds released, a
        # counter bumped) rather than pin device blocks without bound
        self.max_queue_jobs = max_queue_jobs
        self.stream = stream
        self._queue: asyncio.Queue = asyncio.Queue()
        self._loop = None
        self._task: Optional[asyncio.Task] = None
        self.offloaded_blocks_total = 0
        self.dropped_jobs_total = 0
        # the device→host batches: (blocks, bytes, seconds from the
        # gather's dispatch to the commit, the copy's own seconds on the
        # card or None), the newest last
        self.transfers: List[tuple] = []

    def enqueue(self, job: OffloadJob) -> None:
        if self._queue.qsize() >= self.max_queue_jobs:
            self.dropped_jobs_total += 1
            if self.release_holds is not None:
                self.release_holds(job.block_ids)
            return
        self._queue.put_nowait(job)
        self._ensure_task()

    def _ensure_task(self) -> None:
        if self._task is None or self._task.done():
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return
            if loop is not self._loop:
                self._queue, self._loop = requeue(self._queue), loop
            self._task = loop.create_task(self._run(), name="kv-offload")

    async def _run(self) -> None:
        while True:
            job: OffloadJob = await self._queue.get()
            jobs = [job]
            total = len(job.block_ids)
            while total < self.max_batch_blocks and not self._queue.empty():
                j = self._queue.get_nowait()
                jobs.append(j)
                total += len(j.block_ids)
            try:
                await self._process(jobs)
            except KvStoreEmitError:
                logger.critical("kv_store emission failed after the pool "
                                "committed; stopping the offload pump")
                raise
            except Exception:  # noqa: BLE001 — write-back is best-effort
                logger.exception("kv offload batch failed")
            finally:
                if self.release_holds is not None:
                    for j in jobs:
                        self.release_holds(j.block_ids)
                for _ in jobs:
                    self._queue.task_done()
            await asyncio.sleep(0)  # yield to the engine loop

    async def _process(self, jobs: List[OffloadJob]) -> None:
        from ...engine.block_copy import rows_as_wire, start_d2h

        block_ids = [b for j in jobs for b in j.block_ids]
        seq_hashes = [h for j in jobs for h in j.seq_hashes]
        tok_hashes = [th for j in jobs
                      for th in (j.tokens_hashes
                                 or [None] * len(j.seq_hashes))]
        parents = [p for j in jobs
                   for p in ([None] + list(j.seq_hashes[:-1]))]
        # skip blocks already resident on host (multi-turn re-offload)
        keep = [i for i, h in enumerate(seq_hashes)
                if not self.host_pool.contains(h)]
        if not keep:
            return
        ids = [block_ids[i] for i in keep]
        hashes = [seq_hashes[i] for i in keep]
        toks = [tok_hashes[i] for i in keep]
        pars = [parents[i] for i in keep]
        # the gather is dispatched HERE, on the loop thread and the
        # compute stream: it reads the blocks before any later dispatch
        # could overwrite them once their holds drop
        t0 = time.monotonic()
        xfer = start_d2h(self.get_kv(), ids, self.block_size,
                         self.num_heads, stream=self.stream)
        # ...and the wait for the copy into pinned memory runs off-thread,
        # so the loop keeps dispatching while the copy engine works
        rows = await asyncio.to_thread(xfer.wait)
        self.transfers.append((len(ids), xfer.nbytes, time.monotonic() - t0,
                               xfer.copy_s()))
        del self.transfers[:-64]
        decisions = self.host_pool.store(
            hashes, {k: rows_as_wire(v) for k, v in rows.items()},
            tokens_hashes=toks, parent_hashes=pars)
        self.offloaded_blocks_total += len(decisions)
        if self.on_store is not None and decisions:
            try:
                self.on_store([(h, slot, evicted, ids[i])
                               for i, (h, slot, evicted)
                               in enumerate(decisions)])
            except Exception as e:  # noqa: BLE001
                raise KvStoreEmitError(str(e)) from e

    async def drain(self) -> None:
        self._ensure_task()
        await self._queue.join()

    async def stop(self) -> None:
        """Flush pending write-backs, then cancel the pump."""
        try:
            await asyncio.wait_for(self.drain(), timeout=30)
        except asyncio.TimeoutError:
            logger.warning("kv offload drain timed out; dropping queue")
            while not self._queue.empty():
                job = self._queue.get_nowait()
                if self.release_holds is not None:
                    self.release_holds(job.block_ids)
                self._queue.task_done()
        if self._task is not None:
            self._task.cancel()
            self._task = None
