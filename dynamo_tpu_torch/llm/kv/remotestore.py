"""Remote (G4) KV tier: the fleet fabric's storage rung.

Counterpart of ``dynamo_tpu.llm.kv.remotestore``, over the port's disk
block packing (``diskstore._pack_block``), so an object written by either
package is the other's: the same key (``blocks/blk-<hash:016x>.npz``) and
the same npz bytes (each key's raw bytes as a flat uint8 array, a
``__meta__`` entry with dtype names and shapes, a ``__chain__`` entry with
the block's tokens and parent hashes). Values are torch tensors on the
CPU; bf16 goes through a torch view, with no ``ml_dtypes``.

The rung below disk in the ladder Device → Host → Disk → Remote: it keeps
the disk store's contract (``contains / match_prefix(pin) / fetch / put /
apply_put``), so it sits behind the same ``KvBlockManager`` cascade and a
``DiskSpillEngine`` pump promotes disk evictions into it.

- :class:`FsObjectStore`: a filesystem-rooted object store with an S3 /
  GCS-shaped API (put / get / head / delete / list under string keys).
  ``put_object`` writes tmp → fsync → atomic rename → directory fsync, so
  an acknowledged object is whole and a reader never sees a torn one.
- :class:`ObjectKvBackend`: content-addressed blocks over an object store,
  with capacity reaping (oldest mtime first, pins skipped) and corrupt
  objects reaped as misses.
- :class:`RemoteKvStore`: the tier itself. Residency is the union of the
  shared object store and a hash → holder index of peer workers (fed by
  the fabric from the tier-tagged ``kv_events``); ``match_prefix`` asks
  the fabric's admission gate and reports no hit when the modeled fetch
  loses to the modeled recompute.

Unlike the JAX package's, a peer fetch here returns a list of per-block
dicts (``peer_fetch(worker_id, hashes) -> [{key: [L, H, bs, D]}, ...]``)
that the engine copies straight into its staging rows; ``fetch`` stacks
them into the JAX package's wire layout for its callers. The JAX store's
failpoints, request tracing and tenancy ledger are not here (ROADMAP
A7.7, A10).
"""

from __future__ import annotations

import io
import json
import logging
import os
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .diskstore import _blk_fname, _pack_block, _unpack_block

logger = logging.getLogger("dynamo_tpu_torch.kv.remotestore")

__all__ = ["FsObjectStore", "ObjectKvBackend", "RemoteKvStore",
           "pack_block_bytes", "unpack_block_bytes", "stack_wire"]


def pack_block_bytes(values: dict, tokens_hash: Optional[int] = None,
                     parent_hash: Optional[int] = None) -> bytes:
    """One per-block dict (``{key: [L, H, bs, D]}`` torch tensors) → the
    self-describing npz bytes the object store and the fabric carry."""
    payload = _pack_block(values)
    payload["__chain__"] = np.frombuffer(
        json.dumps({"th": tokens_hash, "ph": parent_hash}).encode(),
        np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    return buf.getvalue()


def unpack_block_bytes(data: bytes) -> Tuple[dict, Optional[int],
                                             Optional[int]]:
    """npz bytes → (values, tokens_hash, parent_hash). Raises ValueError
    on a torn or truncated payload (callers treat that as a miss)."""
    try:
        with np.load(io.BytesIO(data)) as z:
            chain = {}
            if "__chain__" in z.files:
                chain = json.loads(z["__chain__"].tobytes().decode())
            values = _unpack_block(z)
    except Exception as e:  # noqa: BLE001 — any corruption is a miss
        raise ValueError(f"torn KV block payload: {e}") from e
    return values, chain.get("th"), chain.get("ph")


def stack_wire(blocks: Sequence[dict]) -> dict:
    """Per-block dicts → the stacked wire layout ``{key: [L, H, n, bs,
    D]}`` (the JAX package's ``fetch`` result)."""
    return {k: torch.stack([b[k] for b in blocks], dim=2)
            for k in blocks[0]}


class FsObjectStore:
    """Filesystem-rooted object store speaking the S3 / GCS verb set:
    ``put_object / get_object / head_object / delete_object /
    list_objects``. The root is the bucket (a mount or export shared by
    the fleet); keys may contain ``/`` and map to subdirectories.

    ``put_object`` writes tmp → fsync → atomic rename → directory fsync:
    an acknowledged object always has whole bytes, and a crashed writer
    leaves only an unlisted ``.tmp-`` dropping."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.put_objects_total = 0
        self.get_objects_total = 0
        self.put_bytes_total = 0
        self.get_bytes_total = 0
        self.put_seconds_total = 0.0
        self.get_seconds_total = 0.0

    def _path(self, key: str) -> str:
        if key.startswith("/") or ".." in key.split("/"):
            raise ValueError(f"invalid object key {key!r}")
        return os.path.join(self.root, key)

    def put_object(self, key: str, data: bytes) -> int:
        t0 = time.monotonic()
        path = self._path(key)
        d = os.path.dirname(path)
        os.makedirs(d, exist_ok=True)
        # one temporary file per writer: two writers of one key (a shared
        # prompt's publishers, a publisher beside a promotion pump) never
        # share a half-written file; the last rename wins with whole bytes
        tmp = os.path.join(d, f".tmp-{os.path.basename(path)}."
                              f"{os.getpid()}.{threading.get_ident()}."
                              f"{uuid.uuid4().hex}")
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        try:
            fd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass                          # not every filesystem supports it
        self.put_objects_total += 1
        self.put_bytes_total += len(data)
        self.put_seconds_total += time.monotonic() - t0
        return len(data)

    def get_object(self, key: str) -> Optional[bytes]:
        t0 = time.monotonic()
        try:
            with open(self._path(key), "rb") as f:
                data = f.read()
        except OSError:
            return None
        self.get_objects_total += 1
        self.get_bytes_total += len(data)
        self.get_seconds_total += time.monotonic() - t0
        return data

    def head_object(self, key: str) -> Optional[int]:
        """The object's size, or None when absent (the S3 HEAD)."""
        try:
            return os.path.getsize(self._path(key))
        except OSError:
            return None

    def delete_object(self, key: str) -> bool:
        try:
            os.unlink(self._path(key))
            return True
        except OSError:
            return False

    def list_objects(self, prefix: str = "") -> List[Tuple[str, int, float]]:
        """[(key, size, mtime)] under ``prefix``, ``.tmp-`` droppings
        excluded (they were never acknowledged)."""
        out: List[Tuple[str, int, float]] = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                if fn.startswith(".tmp-"):
                    continue
                full = os.path.join(dirpath, fn)
                key = os.path.relpath(full, self.root).replace(os.sep, "/")
                if not key.startswith(prefix):
                    continue
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                out.append((key, st.st_size, st.st_mtime))
        return sorted(out)


class ObjectKvBackend:
    """KV blocks over an object store: content-addressed objects at
    ``blocks/blk-<hash>.npz``, keyed by the chained sequence hashes every
    tier uses, so any worker's put serves every other worker's get.

    A torn or truncated object (external corruption: the writes are
    atomic) reads as absent, is reaped and counted
    (``reaped_corrupt_total``). With ``capacity_blocks`` > 0 the oldest
    objects are reaped past the capacity, pinned ones skipped."""

    _PREFIX = "blocks/"

    def __init__(self, root_or_store, capacity_blocks: int = 0):
        self.store = (root_or_store if not isinstance(root_or_store, str)
                      else FsObjectStore(root_or_store))
        self.capacity = int(capacity_blocks)
        self._lock = threading.RLock()
        # hash → size: listed at open, extended on a put and on a
        # contains miss that finds the object (another worker put it)
        self._index: Dict[int, int] = {}
        self._pins: Dict[int, int] = {}
        self.stored_blocks_total = 0
        self.evicted_blocks_total = 0
        self.reaped_corrupt_total = 0
        self._refresh_index()

    def _key(self, seq_hash: int) -> str:
        return self._PREFIX + _blk_fname(seq_hash)

    @staticmethod
    def _hash_of_key(key: str) -> Optional[int]:
        name = key.rsplit("/", 1)[-1]
        if not (name.startswith("blk-") and name.endswith(".npz")):
            return None
        try:
            h = int(name[4:-4], 16)
        except ValueError:
            return None
        # the signed view the rest of the ladder uses
        return h - (1 << 64) if h >= (1 << 63) else h

    def _refresh_index(self) -> None:
        with self._lock:
            self._index = {}
            for key, size, _mtime in self.store.list_objects(self._PREFIX):
                h = self._hash_of_key(key)
                if h is not None:
                    self._index[h] = size

    @property
    def used_blocks(self) -> int:
        return len(self._index)

    def contains(self, seq_hash: int) -> bool:
        with self._lock:
            if seq_hash in self._index:
                return True
        # shared store: another worker may have put it since the last look
        size = self.store.head_object(self._key(seq_hash))
        if size is None:
            return False
        with self._lock:
            self._index[seq_hash] = size
        return True

    def registered_entries(self) -> List[tuple]:
        """Every resident block as (seq_hash, tokens_hash, parent_hash);
        the chain meta is read from each object."""
        out = []
        with self._lock:
            hashes = list(self._index)
        for h in hashes:
            data = self.store.get_object(self._key(h))
            if data is None:
                continue
            try:
                _values, th, ph = unpack_block_bytes(data)
            except ValueError:
                self._reap_corrupt(h)
                continue
            out.append((h, th, ph))
        return out

    def _reap_corrupt(self, seq_hash: int) -> None:
        self.store.delete_object(self._key(seq_hash))
        with self._lock:
            self._index.pop(seq_hash, None)
        self.reaped_corrupt_total += 1
        logger.warning("reaped torn remote KV object %x",
                       seq_hash & 0xFFFFFFFFFFFFFFFF)

    def fetch_blocks(self, seq_hashes: Sequence[int]) -> List[dict]:
        """Per-block value dicts in order; KeyError on any miss (callers
        fall back to recompute)."""
        blocks = []
        for h in seq_hashes:
            data = self.store.get_object(self._key(h))
            if data is None:
                raise KeyError(f"remote KV object {h:#x} is not resident")
            try:
                values, _th, _ph = unpack_block_bytes(data)
            except ValueError:
                self._reap_corrupt(h)
                raise KeyError(f"remote KV object {h:#x} was torn")
            blocks.append(values)
        return blocks

    def put(self, seq_hash: int, values: dict,
            tokens_hash: Optional[int] = None,
            parent_hash: Optional[int] = None) -> Optional[List[int]]:
        """Durable on return; returns the reaped hashes ([] usually), or
        None when skipped (already resident)."""
        if self.contains(seq_hash):
            return None
        data = pack_block_bytes(values, tokens_hash, parent_hash)
        self.store.put_object(self._key(seq_hash), data)
        with self._lock:
            self._index[seq_hash] = len(data)
            self.stored_blocks_total += 1
        return self._reap_for_capacity()

    def _reap_for_capacity(self) -> List[int]:
        if self.capacity <= 0 or len(self._index) <= self.capacity:
            return []
        aged = sorted((mtime, key) for key, _sz, mtime
                      in self.store.list_objects(self._PREFIX))
        evicted: List[int] = []
        with self._lock:
            excess = len(self._index) - self.capacity
        for _mtime, key in aged:
            if excess <= 0:
                break
            h = self._hash_of_key(key)
            if h is None or self._pins.get(h):
                continue
            self.store.delete_object(key)
            with self._lock:
                self._index.pop(h, None)
            self.evicted_blocks_total += 1
            evicted.append(h)
            excess -= 1
        return evicted

    def delete(self, seq_hash: int) -> None:
        self.store.delete_object(self._key(seq_hash))
        with self._lock:
            self._index.pop(seq_hash, None)

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


class RemoteKvStore:
    """The G4 rung behind the ``KvBlockManager`` cascade.

    Residency is the union of the shared object store and the hash →
    holder index of peers (``note_peer_stored`` / ``note_peer_removed``,
    fed by the fabric). Reads prefer the object store and fall back to the
    ``peer_fetch`` plug, the fabric's RPC. ``match_prefix`` runs the
    ``admission`` plug over the whole matched run: no admission, no hit.

    The spill pump writes from a worker thread while the engine loop
    matches and pins; peer fetches run on the onboard's thread."""

    def __init__(self, object_backend: Optional[ObjectKvBackend] = None):
        self.object = object_backend
        # the fabric plugs these in at attach:
        #   peer_fetch(worker_id, [hashes]) -> [per-block dict]
        self.peer_fetch: Optional[Callable] = None
        #   admission(n_blocks, holders) -> bool (fabric.AdmissionGate)
        self.admission: Optional[Callable] = None
        #   peer_usable(worker_id) -> bool (the peer's circuit breaker)
        self.peer_usable: Optional[Callable] = None
        self._lock = threading.RLock()
        # hash → {worker_id: announce time}, first holder first
        self._peers: Dict[int, Dict[int, float]] = {}
        self.match_queries = 0
        self.match_hits = 0
        self.admission_rejects_total = 0
        self.fetch_failures_total = 0

    # ---------------------------------------------------------- index feed
    def note_peer_stored(self, worker_id: int,
                         seq_hashes: Sequence[int]) -> None:
        now = time.monotonic()
        with self._lock:
            for h in seq_hashes:
                self._peers.setdefault(h, {})[worker_id] = now

    def note_peer_removed(self, worker_id: int,
                          seq_hashes: Sequence[int]) -> None:
        with self._lock:
            for h in seq_hashes:
                holders = self._peers.get(h)
                if holders is not None:
                    holders.pop(worker_id, None)
                    if not holders:
                        del self._peers[h]

    def forget_peer(self, worker_id: int) -> None:
        """A peer's lease died: its holdings are unreachable."""
        with self._lock:
            for h in list(self._peers):
                self._peers[h].pop(worker_id, None)
                if not self._peers[h]:
                    del self._peers[h]

    def peer_block_count(self) -> int:
        with self._lock:
            return len(self._peers)

    # ------------------------------------------------------------- queries
    def holders_of(self, seq_hash: int) -> List[int]:
        with self._lock:
            holders = list(self._peers.get(seq_hash, ()))
        if self.peer_usable is not None:
            holders = [w for w in holders if self.peer_usable(w)]
        return holders

    def holds_durable(self, seq_hash: int) -> bool:
        """Whether this worker's object backend holds the hash (the
        announce-worthy residency; peer-held blocks are the peer's)."""
        return self.object is not None and self.object.contains(seq_hash)

    def contains(self, seq_hash: int) -> bool:
        with self._lock:
            if self._peers.get(seq_hash):
                return True
        return self.object is not None and self.object.contains(seq_hash)

    @property
    def used_blocks(self) -> int:
        return self.object.used_blocks if self.object is not None else 0

    @property
    def capacity(self) -> int:
        return self.object.capacity if self.object is not None else 0

    @property
    def stored_blocks_total(self) -> int:
        return (self.object.stored_blocks_total
                if self.object is not None else 0)

    def hit_rate(self) -> float:
        return self.match_hits / max(self.match_queries, 1)

    def registered_entries(self) -> List[tuple]:
        """The object-held blocks: what this worker may announce."""
        if self.object is None:
            return []
        return self.object.registered_entries()

    def match_prefix(self, seq_hashes: Sequence[int],
                     pin: bool = False) -> List[int]:
        """Longest leading run of reachable hashes, through the admission
        gate: when the modeled fetch of the run loses to the modeled
        recompute, the whole run reports as a miss. ``pin`` protects the
        matched object entries from the capacity reaper until the
        onboard's read; a peer eviction mid-fetch surfaces as a fetch
        failure (the engine recomputes)."""
        run: List[int] = []
        holders: List[List[int]] = []
        for h in seq_hashes:
            self.match_queries += 1
            hs = self.holders_of(h)
            if not hs and not (self.object is not None
                               and self.object.contains(h)):
                break
            self.match_hits += 1
            run.append(h)
            holders.append(hs)
        if not run:
            return []
        if self.admission is not None and not self.admission(len(run),
                                                             holders):
            self.admission_rejects_total += 1
            # reachable, but refused by the gate: not counted as hits
            self.match_hits -= len(run)
            return []
        if pin:
            self.pin(run)
        return run

    def pin(self, seq_hashes: Sequence[int]) -> None:
        """Pins reach the object entries only: a peer's eviction surfaces
        as a failed fetch."""
        if self.object is not None:
            self.object.pin(seq_hashes)

    def unpin(self, seq_hashes: Sequence[int]) -> None:
        if self.object is not None:
            self.object.unpin(seq_hashes)

    # --------------------------------------------------------------- reads
    def fetch_blocks(self, seq_hashes: Sequence[int]) -> List[dict]:
        """Per-block value dicts ``{key: [L, H, bs, D]}`` in order. Runs on
        the onboard's thread. Raises KeyError when a block is unreachable
        (peer gone, object torn): the engine recomputes, never fails."""
        try:
            return self._fetch_blocks(seq_hashes)
        except Exception:
            self.fetch_failures_total += 1
            raise

    def fetch(self, seq_hashes: Sequence[int]) -> dict:
        """Stacked wire values ``{key: [L, H, n, bs, D]}``, as the disk
        tier's ``fetch``."""
        return stack_wire(self.fetch_blocks(seq_hashes))

    def _fetch_blocks(self, seq_hashes: Sequence[int]) -> List[dict]:
        # object-held blocks read locally; the rest grouped into one run
        # per peer, one RPC each
        out: List[Optional[dict]] = [None] * len(seq_hashes)
        peer_runs: Dict[int, List[int]] = {}
        for i, h in enumerate(seq_hashes):
            if self.object is not None and self.object.contains(h):
                out[i] = self.object.fetch_blocks([h])[0]
            else:
                holders = self.holders_of(h)
                if not holders or self.peer_fetch is None:
                    raise KeyError(f"remote KV block {h:#x} has no "
                                   f"reachable holder")
                peer_runs.setdefault(holders[0], []).append(i)
        for wid, idxs in peer_runs.items():
            blocks = self.peer_fetch(wid, [seq_hashes[i] for i in idxs])
            for i, b in zip(idxs, blocks):
                out[i] = b
        return out  # type: ignore[return-value]

    # -------------------------------------------------------------- writes
    def put(self, seq_hash: int, values: dict,
            tokens_hash: Optional[int] = None,
            parent_hash: Optional[int] = None) -> Optional[List[int]]:
        """Durable object put (the promotion pump's sink). A peer-only
        fabric (no object backend) stores nothing."""
        if self.object is None:
            return None
        return self.object.put(seq_hash, values, tokens_hash, parent_hash)

    def apply_put(self, seq_hash: int, evicted: Sequence[int],
                  values: dict, tokens_hash: Optional[int] = None,
                  parent_hash: Optional[int] = None) -> None:
        """Literal placement (the disk store's ``apply_put`` contract):
        delete exactly the given eviction set, then store."""
        if self.object is None:
            return
        for h in evicted:
            self.object.delete(h)
        if not self.object.contains(seq_hash):
            self.object.put(seq_hash, values, tokens_hash, parent_hash)
