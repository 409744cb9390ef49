"""Persistent disk KV tier: a content-addressed block store with
write-behind spill and cross-restart prefix reuse.

Counterpart of ``dynamo_tpu.llm.kv.diskstore`` (the reference's ladder
Device → Pinned-Host → Disk), with the same on-disk format, so a directory
written by either package warm-starts the other:

- one ``blk-<hash:016x>.npz`` file a block, written tmp → fsync → rename:
  each key's bytes as a flat uint8 array plus a ``__meta__`` entry, the
  JSON of each array's dtype name (``"bfloat16"``, ``"int8"``, ...) and
  shape;
- ``manifest.jsonl``, whose fsync'd ``put`` line after the durable data
  file acknowledges a block (``del`` lines before an unlink), compacted
  to pure puts at every open;
- ``meta.json``: the block size and the per-key layout (shape, dtype);
  a block-size mismatch starts cold, a layout change drops the cache.

Recovery at open: a torn manifest tail was never acknowledged and is
ignored; a manifest entry whose payload is missing or shorter than
acknowledged is reaped (counted); data files nobody acknowledged are
removed. Values are torch tensors on the CPU: bf16 decodes from its raw
bytes through a torch view, with no ``ml_dtypes``.

- :class:`DiskKvStore`: the store. Index mutations lock (the spill pump
  writes from a worker thread while the engine loop matches and pins);
  capacity eviction skips pinned entries (requeue), so the read of a
  pinned block is safe against a concurrent put.
- :class:`DiskSpillEngine`: the write-behind pump. Host-tier evictions
  become bounded-queue spill jobs whose file I/O runs off-thread;
  saturation drops the job with a counter, a refused write sheds it.
"""

from __future__ import annotations

import asyncio
import dataclasses
import io
import json
import logging
import os
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .offload import requeue

logger = logging.getLogger("dynamo_tpu_torch.kv.diskstore")

__all__ = ["DiskKvStore", "DiskSpillEngine", "SpillJob"]

_MANIFEST = "manifest.jsonl"
_META = "meta.json"

# torch dtypes by the numpy name the files carry, and back
_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64}
_NAMES = {v: k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class _Entry:
    seq_hash: int
    tokens_hash: Optional[int]
    parent_hash: Optional[int]
    fname: str
    nbytes: int


def _blk_fname(seq_hash: int) -> str:
    return f"blk-{seq_hash & 0xFFFFFFFFFFFFFFFF:016x}.npz"


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype, as the files record it."""
    return _NAMES[dtype]


def _pack_block(values: dict) -> dict:
    """Per-block dict → npz payload: raw uint8 bytes per key plus a JSON
    ``__meta__`` entry with each array's dtype name and shape. Byte-exact
    for any dtype (bfloat16, int8 opaque rows)."""
    meta = {}
    out = {}
    for k, v in values.items():
        v = v.contiguous()
        meta[k] = {"dtype": dtype_name(v.dtype), "shape": list(v.shape)}
        out[k] = v.reshape(-1).view(torch.uint8).numpy()
    out["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    return out


def _unpack_block(z) -> dict:
    meta = json.loads(z["__meta__"].tobytes().decode())
    out = {}
    for k, m in meta.items():
        out[k] = torch.from_numpy(z[k]).view(_DTYPES[m["dtype"]]).reshape(
            m["shape"])
    return out


class DiskKvStore:
    """Content-addressed on-disk KV block store.

    Keys are the chained sequence hashes (``blocks.py``), the identity the
    device pool and the host tier use; values are per-block dicts of the
    host arena's rows (``{"k": [L, H, bs, D], "v": ...}``; int8 and MLA
    pools one opaque entry). Durability: a block is acknowledged iff its
    manifest ``put`` line is fsync'd, after its data file was fsync'd and
    renamed; deletes append ``del`` before the unlink.

    Two locks: ``_lock`` guards the in-memory index and is all the engine
    loop takes (``contains``, ``match_prefix``, pins); ``_io_lock``
    serialises the writers' file and manifest I/O, so a slow fsync never
    holds ``_lock``."""

    def __init__(self, root: str, capacity_blocks: int,
                 expect_block_size: Optional[int] = None):
        self.root = root
        self.capacity = int(capacity_blocks)
        os.makedirs(root, exist_ok=True)
        self._lock = threading.RLock()
        self._io_lock = threading.Lock()
        # insertion order IS the LRU order (match_prefix re-inserts)
        self._entries: "OrderedDict[int, _Entry]" = OrderedDict()
        self._pins: Dict[int, int] = {}
        self._manifest_f = None
        self.meta: dict = {}
        # stats
        self.stored_blocks_total = 0
        self.evicted_blocks_total = 0
        self.match_queries = 0
        self.match_hits = 0
        self.restored_blocks = 0        # entries recovered at open
        self.reaped_corrupt_blocks = 0  # missing/truncated payloads reaped
        self.bytes_used = 0
        self._recover(expect_block_size)

    # ------------------------------------------------------------- recovery
    def _recover(self, expect_block_size: Optional[int]) -> None:
        meta_path = os.path.join(self.root, _META)
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    self.meta = json.load(f)
            except (OSError, ValueError):
                self.meta = {}
        if (expect_block_size is not None and self.meta
                and self.meta.get("block_size") not in (None,
                                                        expect_block_size)):
            logger.warning(
                "disk KV store at %s was written with block_size=%s but "
                "this engine runs block_size=%d — starting cold",
                self.root, self.meta.get("block_size"), expect_block_size)
            self._wipe()
        man_path = os.path.join(self.root, _MANIFEST)
        live: "OrderedDict[int, _Entry]" = OrderedDict()
        try:
            if os.path.exists(man_path):
                with open(man_path) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            break        # torn tail: never acknowledged
                        if rec.get("op") == "put":
                            h = int(rec["h"])
                            live.pop(h, None)
                            live[h] = _Entry(
                                seq_hash=h, tokens_hash=rec.get("th"),
                                parent_hash=rec.get("ph"),
                                fname=rec.get("f", _blk_fname(h)),
                                nbytes=int(rec.get("n", 0)))
                        elif rec.get("op") == "del":
                            live.pop(int(rec["h"]), None)
        except OSError:
            # an unreadable manifest must not refuse serving: start cold
            logger.exception("disk KV manifest unreadable at %s — "
                             "starting cold", man_path)
            live = OrderedDict()
        # only entries whose data file exists with the acknowledged byte
        # count can serve reads; a short file is external damage: reap it
        for h in list(live):
            e = live[h]
            try:
                size = os.path.getsize(os.path.join(self.root, e.fname))
            except OSError:
                live.pop(h)
                continue
            if e.nbytes and size < e.nbytes:
                live.pop(h)
                self.reaped_corrupt_blocks += 1
                logger.warning("disk KV block %x payload truncated (%d < "
                               "%d bytes) — reaped",
                               h & 0xFFFFFFFFFFFFFFFF, size, e.nbytes)
        self._entries = live
        self.restored_blocks = len(live)
        self.bytes_used = sum(e.nbytes for e in live.values())
        # orphan data files: renamed but never acknowledged, or deleted in
        # the manifest but not yet unlinked
        keep = {e.fname for e in live.values()}
        for fn in os.listdir(self.root):
            if fn in (_MANIFEST, _META) or fn in keep:
                continue
            if fn.startswith(("blk-", "tmp-")):
                try:
                    os.unlink(os.path.join(self.root, fn))
                except OSError:
                    pass
        self._rewrite_manifest()       # compact: pure puts of the live set
        if expect_block_size is not None:
            self.meta.setdefault("block_size", expect_block_size)
            self._write_meta()
        if live:
            logger.info("disk KV store warm start: %d blocks (%.1f MB) "
                        "recovered from %s", len(live),
                        self.bytes_used / 1e6, self.root)

    def _wipe(self) -> None:
        for fn in os.listdir(self.root):
            try:
                os.unlink(os.path.join(self.root, fn))
            except OSError:
                pass
        self.meta = {}
        self._entries = OrderedDict()
        self.bytes_used = 0

    def _write_meta(self) -> None:
        tmp = os.path.join(self.root, _META + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self.meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, _META))

    def _rewrite_manifest(self) -> None:
        if self._manifest_f is not None:
            self._manifest_f.close()
            self._manifest_f = None
        tmp = os.path.join(self.root, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            for e in self._entries.values():
                f.write(json.dumps({"op": "put", "h": e.seq_hash,
                                    "th": e.tokens_hash,
                                    "ph": e.parent_hash,
                                    "f": e.fname, "n": e.nbytes}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, _MANIFEST))
        self._fsync_dir()
        self._manifest_f = open(os.path.join(self.root, _MANIFEST), "a")

    def _fsync_dir(self) -> None:
        try:
            fd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass                        # not all filesystems support it

    def _append_manifest(self, recs: List[dict]) -> None:
        if self._manifest_f is None:
            self._manifest_f = open(os.path.join(self.root, _MANIFEST), "a")
        for rec in recs:
            self._manifest_f.write(json.dumps(rec) + "\n")
        self._manifest_f.flush()
        os.fsync(self._manifest_f.fileno())

    # -------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def used_blocks(self) -> int:
        return len(self._entries)

    def contains(self, seq_hash: int) -> bool:
        with self._lock:
            return seq_hash in self._entries

    def hit_rate(self) -> float:
        return self.match_hits / max(self.match_queries, 1)

    def match_prefix(self, seq_hashes: Sequence[int],
                     pin: bool = False) -> List[int]:
        """Longest leading run of hashes present; returns the matched
        HASHES and freshens LRU order. ``pin=True`` pins them under the
        lock, so the spill pump's capacity evictions cannot delete them
        before the onboard's read."""
        out: List[int] = []
        with self._lock:
            for h in seq_hashes:
                self.match_queries += 1
                if h not in self._entries:
                    break
                self.match_hits += 1
                self._entries.move_to_end(h)
                if pin:
                    self._pins[h] = self._pins.get(h, 0) + 1
                out.append(h)
        return out

    def pin(self, seq_hashes: Sequence[int]) -> None:
        with self._lock:
            for h in seq_hashes:
                self._pins[h] = self._pins.get(h, 0) + 1

    def unpin(self, seq_hashes: Sequence[int]) -> None:
        with self._lock:
            for h in seq_hashes:
                n = self._pins.get(h, 0) - 1
                if n <= 0:
                    self._pins.pop(h, None)
                else:
                    self._pins[h] = n

    def registered_entries(self) -> List[tuple]:
        """Every resident block as (seq_hash, tokens_hash, parent_hash)."""
        with self._lock:
            return [(e.seq_hash, e.tokens_hash, e.parent_hash)
                    for e in self._entries.values()]

    # ---------------------------------------------------------------- reads
    def read_block(self, seq_hash: int) -> dict:
        """One resident block's values ``{key: [L, H, bs, D]}``."""
        with self._lock:
            e = self._entries.get(seq_hash)
        if e is None:
            raise KeyError(f"disk KV block {seq_hash:#x} is not resident")
        with np.load(os.path.join(self.root, e.fname)) as z:
            return _unpack_block(z)

    def fetch_rows(self, seq_hashes: Sequence[int],
                   out: Optional[dict] = None, offset: int = 0) -> dict:
        """Rows ``{key: [n, L, H, bs, D]}`` of ``seq_hashes`` (into
        ``out``'s tensors from block ``offset`` where given). Callers pin
        first: an unpinned entry may be evicted mid-read."""
        blocks = [self.read_block(h) for h in seq_hashes]
        if out is None:
            return {k: torch.stack([b[k] for b in blocks])
                    for k in blocks[0]}
        for i, b in enumerate(blocks):
            for k, v in b.items():
                out[k][offset + i].copy_(v)
        return out

    def fetch(self, seq_hashes: Sequence[int]) -> dict:
        """Stacked wire values ``{key: [L, H, n, bs, D]}``."""
        return {k: v.permute(1, 2, 0, 3, 4).contiguous()
                for k, v in self.fetch_rows(seq_hashes).items()}

    # --------------------------------------------------------------- writes
    def _validate_layout(self, values: dict) -> None:
        layout = {k: [list(v.shape), dtype_name(v.dtype)]
                  for k, v in values.items()}
        known = self.meta.get("layout")
        if known is None:
            self.meta["layout"] = layout
            self._write_meta()
        elif known != layout:
            logger.warning("disk KV store layout changed (%s -> %s) — "
                           "dropping the stale cache", known, layout)
            with self._lock:
                self._wipe()
            self.meta = {"layout": layout,
                         "block_size": self.meta.get("block_size")}
            self._write_meta()
            self._rewrite_manifest()

    def _evict_for_capacity(self) -> List["_Entry"]:
        """Under ``_lock``: pick LRU victims (skipping pinned, which
        requeue) until one slot is free and drop them from the index.
        Returns their entries, whose files ``_delete_files`` removes;
        raises BlockingIOError when everything is pinned."""
        evicted: List[_Entry] = []
        scanned = 0
        while len(self._entries) >= self.capacity:
            if scanned >= len(self._entries):
                raise BlockingIOError("disk KV store full and all pinned")
            h = next(iter(self._entries))
            if self._pins.get(h):
                self._entries.move_to_end(h)   # requeue pinned candidate
                scanned += 1
                continue
            e = self._entries.pop(h)
            self.bytes_used -= e.nbytes
            self.evicted_blocks_total += 1
            evicted.append(e)
        return evicted

    def _delete_files(self, evicted: List["_Entry"]) -> None:
        """Under ``_io_lock``: the manifest ``del`` lines BEFORE the
        unlinks, so a crash between them leaves an orphan the next open
        removes, never a live entry without bytes."""
        if not evicted:
            return
        self._append_manifest([{"op": "del", "h": e.seq_hash}
                               for e in evicted])
        for e in evicted:
            try:
                os.unlink(os.path.join(self.root, e.fname))
            except OSError:
                pass

    def put(self, seq_hash: int, values: dict,
            tokens_hash: Optional[int] = None,
            parent_hash: Optional[int] = None) -> Optional[List[int]]:
        """Store one block under its chained hash. Returns the hashes
        evicted to make room (usually []), or None when the block was
        skipped (already resident, zero capacity, or everything pinned).
        Durable on return. The block becomes visible to ``contains`` and
        ``match_prefix`` only once acknowledged."""
        if self.capacity <= 0:
            return None
        with self._io_lock:
            with self._lock:
                if seq_hash in self._entries:
                    self._entries.move_to_end(seq_hash)
                    return None
                try:
                    evicted = self._evict_for_capacity()
                except BlockingIOError:
                    return None
            self._delete_files(evicted)
            self._validate_layout(values)
            nbytes = self._write_block(seq_hash, values, tokens_hash,
                                       parent_hash)
            with self._lock:
                self._entries[seq_hash] = _Entry(seq_hash, tokens_hash,
                                                 parent_hash,
                                                 _blk_fname(seq_hash),
                                                 nbytes)
                self.bytes_used += nbytes
                self.stored_blocks_total += 1
            return [e.seq_hash for e in evicted]

    def _write_block(self, seq_hash: int, values: dict,
                     tokens_hash, parent_hash) -> int:
        fname = _blk_fname(seq_hash)
        tmp = os.path.join(self.root, "tmp-" + fname)
        buf = io.BytesIO()
        np.savez(buf, **_pack_block(values))
        data = buf.getvalue()
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, fname))
        self._fsync_dir()
        # the acknowledgement: the manifest line AFTER the durable file
        self._append_manifest([{"op": "put", "h": seq_hash,
                                "th": tokens_hash, "ph": parent_hash,
                                "f": fname, "n": len(data)}])
        return len(data)

    def close(self) -> None:
        with self._io_lock:
            if self._manifest_f is not None:
                self._manifest_f.close()
                self._manifest_f = None


@dataclasses.dataclass
class SpillJob:
    """One evicted host-tier block headed for disk. ``values`` is a copy
    of the arena row taken before the eviction's overwrite, so the job
    owns its bytes outright."""

    seq_hash: int
    tokens_hash: Optional[int]
    parent_hash: Optional[int]
    values: dict


class DiskSpillEngine:
    """Asynchronous host→disk write-behind pump: the host pool's eviction
    hook offers jobs on the engine loop, the pump batches them and runs the
    fsync-heavy writes off-thread, so a spill never blocks the loop.
    Bounded queue: saturation drops the job (``dropped_jobs_total``); a
    write the disk refuses sheds it (``shed_writes_total``)."""

    def __init__(self, store: DiskKvStore, max_queue_jobs: int = 256,
                 max_batch_jobs: int = 32,
                 on_commit: Optional[Callable[[list], None]] = None):
        self.store = store
        self.max_queue_jobs = max_queue_jobs
        self.max_batch_jobs = max_batch_jobs
        # called on the loop with [(hash, tokens_hash, parent, evicted)]
        # after each committed batch (the recorder's kv_disk_store)
        self.on_commit = on_commit
        self._queue: asyncio.Queue = asyncio.Queue()
        self._loop = None
        self._task: Optional[asyncio.Task] = None
        self.spilled_blocks_total = 0
        self.dropped_jobs_total = 0
        self.shed_writes_total = 0

    def room(self) -> int:
        """Jobs the queue takes before it drops."""
        return self.max_queue_jobs - self._queue.qsize()

    def offer(self, job: SpillJob) -> bool:
        """Non-blocking enqueue; False (counted) when the queue is
        saturated or the block is already resident on disk."""
        if self.store.contains(job.seq_hash):
            return False
        if self._queue.qsize() >= self.max_queue_jobs:
            self.dropped_jobs_total += 1
            return False
        self._queue.put_nowait(job)
        self._ensure_task()
        return True

    def _ensure_task(self) -> None:
        if self._task is None or self._task.done():
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return
            if loop is not self._loop:
                self._queue, self._loop = requeue(self._queue), loop
            self._task = loop.create_task(self._run(), name="kv-disk-spill")

    async def _run(self) -> None:
        while True:
            job: SpillJob = await self._queue.get()
            jobs = [job]
            while (len(jobs) < self.max_batch_jobs
                   and not self._queue.empty()):
                jobs.append(self._queue.get_nowait())
            try:
                await self._process(jobs)
            except Exception:  # noqa: BLE001 — spill is best-effort
                logger.exception("disk spill batch failed")
            finally:
                for _ in jobs:
                    self._queue.task_done()
            await asyncio.sleep(0)      # yield to the engine loop

    async def _process(self, jobs: List[SpillJob]) -> None:
        def write_batch():
            out = []
            shed = 0
            for j in jobs:
                try:
                    evicted = self.store.put(j.seq_hash, j.values,
                                             j.tokens_hash, j.parent_hash)
                except OSError as e:
                    # a full or failing disk sheds the job (the block is
                    # re-creatable) and the pump goes on
                    shed += 1
                    logger.warning("disk spill shed block %x: %s",
                                   j.seq_hash & 0xFFFFFFFFFFFFFFFF, e)
                    continue
                if evicted is not None:
                    out.append((j.seq_hash, j.tokens_hash, j.parent_hash,
                                list(evicted)))
            return out, shed

        committed, shed = await asyncio.to_thread(write_batch)
        self.shed_writes_total += shed
        self.spilled_blocks_total += len(committed)
        if self.on_commit is not None and committed:
            self.on_commit(committed)

    async def drain(self) -> None:
        self._ensure_task()
        await self._queue.join()

    async def stop(self) -> None:
        try:
            await asyncio.wait_for(self.drain(), timeout=60)
        except asyncio.TimeoutError:
            logger.warning("disk spill drain timed out; dropping queue")
            while not self._queue.empty():
                self._queue.get_nowait()
                self._queue.task_done()
        if self._task is not None:
            self._task.cancel()
            self._task = None
