"""Refcounted device-block pool with prefix reuse and LRU+priority eviction.

Counterpart of ``dynamo_tpu.llm.kv.pool`` (a copy of its pure-Python pool):
one pool object owning every block of the engine's flat paged KV pool,
with the run-tracking allocator (``FreeRunIndex``), prefix matching by
chained block hash, and priority-then-LRU eviction of reusable blocks.

States per block:
- uninitialized: free, content garbage (`_free_uninit`)
- inflight: refcount > 0, attached to >= 1 running sequence
- reusable: refcount == 0 but content valid & registered under its
  sequence hash — eligible for prefix matching, evicted priority-then-LRU
  when uninitialized blocks run out.

Block 0 is the engine's trash block and is never handed out. The
``on_stored``/``on_removed`` callbacks feed the engine's KV event hooks.
``make_kv_block_pool`` picks the native C++ pool (``native_pool.py``) or
this one, as the JAX package's factory does.
``KvBlockManager`` cascades a device miss to the host tier
(``offload.HostKvPool``) and then the disk tier (``diskstore.DiskKvStore``);
the JAX package's remote tier and tenant-preferred eviction are not here.
``relocate`` and the contiguity statistics serve the engine's defrag pass.
Single-threaded by design: one pool per engine loop.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .blocks import TokenBlockSequence


class FreeRunIndex:
    """Coalescing index over the uninitialized free blocks: maximal runs
    of physically-adjacent block ids, with best-fit-run allocation.

    The allocation order is the JAX package's, so the same requests land
    in the same block ids in both packages.

    Determinism contract (the native C++ pool mirrors this EXACTLY —
    tests/test_kv_pool.py differential fuzz): best fit = the smallest
    run with length >= n, ties broken by smallest start; when no run
    fits, take the LARGEST run (ties: smallest start) whole and repeat.
    Blocks are handed out ascending from each run's start.
    """

    def __init__(self):
        self._start: Dict[int, int] = {}   # run start -> length
        self._end: Dict[int, int] = {}     # run end (exclusive) -> start
        self._sorted: List[Tuple[int, int]] = []  # (length, start) sorted
        self.count = 0

    def __len__(self) -> int:
        return self.count

    @property
    def num_runs(self) -> int:
        return len(self._start)

    @property
    def largest_run(self) -> int:
        return self._sorted[-1][0] if self._sorted else 0

    def _remove_run(self, start: int, length: int) -> None:
        del self._start[start]
        del self._end[start + length]
        i = bisect.bisect_left(self._sorted, (length, start))
        assert self._sorted[i] == (length, start)
        self._sorted.pop(i)

    def _insert_run(self, start: int, length: int) -> None:
        self._start[start] = length
        self._end[start + length] = start
        bisect.insort(self._sorted, (length, start))

    def add(self, bid: int) -> None:
        """Return one block, coalescing with adjacent free runs."""
        start, length = bid, 1
        left = self._end.get(bid)
        if left is not None:                 # run ends exactly at bid
            llen = self._start[left]
            self._remove_run(left, llen)
            start, length = left, llen + 1
        rlen = self._start.get(bid + 1)
        if rlen is not None:                 # run starts right after bid
            self._remove_run(bid + 1, rlen)
            length += rlen
        self._insert_run(start, length)
        self.count += 1

    def take(self, n: int) -> List[int]:
        """Allocate n blocks as few maximal runs (contract above).
        Caller guarantees n <= len(self)."""
        out: List[int] = []
        while n > 0:
            i = bisect.bisect_left(self._sorted, (n, -1))
            if i < len(self._sorted):        # best fit: smallest len >= n
                length, start = self._sorted[i]
                take = n
            else:                            # largest run (tie: min start)
                length = self._sorted[-1][0]
                j = bisect.bisect_left(self._sorted, (length, -1))
                length, start = self._sorted[j]
                take = length
            self._remove_run(start, length)
            if take < length:
                self._insert_run(start + take, length - take)
            out.extend(range(start, start + take))
            n -= take
        self.count -= len(out)
        return out


@dataclasses.dataclass
class BlockMeta:
    block_id: int
    seq_hash: Optional[int] = None        # set when registered
    tokens_hash: Optional[int] = None     # local (unchained) hash
    parent_hash: Optional[int] = None
    refcount: int = 0
    priority: int = 0                     # lower evicts first
    return_tick: int = 0                  # LRU tiebreak


class KvBlockPool:
    """Owns block ids [1, num_blocks) — block 0 is the engine's trash block."""

    def __init__(self, num_blocks: int,
                 on_stored: Optional[Callable] = None,
                 on_removed: Optional[Callable] = None):
        self.num_blocks = num_blocks
        self._meta: Dict[int, BlockMeta] = {
            i: BlockMeta(i) for i in range(1, num_blocks)}
        # run-tracking free structure: maximal runs of adjacent block
        # ids, best-fit allocation, in the JAX package's order
        self._free_uninit = FreeRunIndex()
        for i in range(1, num_blocks):
            self._free_uninit.add(i)
        self._by_hash: Dict[int, int] = {}          # seq_hash → block_id
        self._reusable: Dict[int, int] = {}         # block_id → seq_hash (dict = insertion/LRU order)
        # lazy eviction heap keyed (priority, return_tick, bid): pushed
        # when a block becomes reusable; stale entries (re-matched,
        # re-registered with a new priority, already evicted) are
        # skipped at pop time by comparing against live meta
        self._evict_heap: List[Tuple[int, int, int]] = []
        self._tick = 0
        self.on_stored = on_stored
        self.on_removed = on_removed
        # stats
        self.match_queries = 0
        self.match_hits = 0
        # contiguity accounting: how many maximal runs each alloc was
        # served as, against the one-run ideal, and the defrag moves
        self.alloc_blocks_total = 0
        self.alloc_runs_total = 0
        self.alloc_requests_total = 0
        self.defrag_moves_total = 0

    # ------------------------------------------------------------- queries
    @property
    def free_blocks(self) -> int:
        return len(self._free_uninit) + len(self._reusable)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - self.free_blocks

    @property
    def reusable_blocks(self) -> int:
        return len(self._reusable)

    @property
    def free_uninit_blocks(self) -> int:
        """Uninitialized free blocks only (no reusable content at stake):
        the defrag pass takes its target runs from these alone, so a
        layout move never evicts a cached prefix."""
        return len(self._free_uninit)

    def hit_rate(self) -> float:
        return self.match_hits / max(self.match_queries, 1)

    @property
    def contig_runs(self) -> int:
        """Maximal free runs in the uninit index (1 = fully coalesced)."""
        return self._free_uninit.num_runs

    def frag_ratio(self) -> float:
        """Fragmentation of the uninit free space: 1 - largest_run/free.
        0 = one maximal run (or nothing free); toward 1 as the free space
        shatters into single blocks."""
        n = len(self._free_uninit)
        if n == 0:
            return 0.0
        return 1.0 - self._free_uninit.largest_run / n

    def contiguity_ratio(self) -> float:
        """Adjacency delivered / adjacency possible across all allocs: an
        n-block alloc served as r runs delivers n - r of its n - 1
        possible adjacent pairs. 1.0 = every alloc was one run."""
        possible = self.alloc_blocks_total - self.alloc_requests_total
        if possible <= 0:
            return 1.0
        return (self.alloc_blocks_total
                - self.alloc_runs_total) / possible

    @staticmethod
    def count_runs(blocks: Sequence[int]) -> int:
        """Maximal runs of consecutive ids in an ORDERED block list: the
        per-sequence fragmentation score the defrag pass ranks by."""
        if not blocks:
            return 0
        return 1 + sum(1 for a, b in zip(blocks, blocks[1:])
                       if b != a + 1)

    # ------------------------------------------------------------ matching
    def match_prefix(self, seq_hashes: Sequence[int]) -> List[int]:
        """Longest-prefix match: returns device block ids whose registered
        content equals the leading chained hashes. Matched blocks get a
        refcount hold (caller must release them later)."""
        out: List[int] = []
        for h in seq_hashes:
            self.match_queries += 1
            bid = self._by_hash.get(h)
            if bid is None:
                break
            self.match_hits += 1
            meta = self._meta[bid]
            if meta.refcount == 0:
                self._reusable.pop(bid, None)
            meta.refcount += 1
            out.append(bid)
        return out

    def peek_prefix(self, seq_hashes: Sequence[int]) -> int:
        """Length (in blocks) of the longest matchable prefix, without
        taking holds or touching stats."""
        n = 0
        for h in seq_hashes:
            if h not in self._by_hash:
                break
            n += 1
        return n

    # ----------------------------------------------------------- allocate
    def alloc_uninit(self, n: int) -> Optional[List[int]]:
        """n fresh blocks (content garbage) as few maximal runs of
        adjacent ids (best-fit over the free-run index). When the uninit
        index runs short, reusable blocks are evicted FIRST — in strict
        priority-then-LRU order, preserving the eviction contract — and
        returned to the index (coalescing), THEN the runs are carved.
        Returns None if even eviction can't satisfy."""
        if n > self.free_blocks:
            return None
        for _ in range(n - len(self._free_uninit)):
            self._free_uninit.add(self._evict_one())
        out = self._free_uninit.take(n)
        for bid in out:
            self._meta[bid].refcount = 1
        if n:
            self.alloc_requests_total += 1
            self.alloc_blocks_total += n
            self.alloc_runs_total += self.count_runs(out)
        return out

    def _evict_one(self) -> int:
        # priority first (lower first), then LRU by return_tick — the
        # reference's PriorityKey ordering (reuse.rs) — via the lazy
        # heap: stale entries (block re-matched / re-keyed since push)
        # are skipped by comparing against live meta.
        while True:
            prio, tick, bid = heapq.heappop(self._evict_heap)
            meta = self._meta[bid]
            if (bid in self._reusable and meta.priority == prio
                    and meta.return_tick == tick):
                break
        self._invalidate(bid)
        return bid

    def _invalidate(self, bid: int) -> None:
        meta = self._meta[bid]
        self._reusable.pop(bid, None)
        if meta.seq_hash is not None:
            self._by_hash.pop(meta.seq_hash, None)
            if self.on_removed is not None:
                self.on_removed([meta.seq_hash])
        meta.seq_hash = None
        meta.tokens_hash = None
        meta.parent_hash = None

    # ------------------------------------------------------------ register
    def register(self, bid: int, seq_hash: int, tokens_hash: int,
                 parent_hash: Optional[int], priority: int = 0) -> None:
        """Declare a block's content: it now holds the KV for the block whose
        chained hash is seq_hash. Emits a `stored` event."""
        meta = self._meta[bid]
        if meta.seq_hash == seq_hash:
            return
        existing = self._by_hash.get(seq_hash)
        if existing is not None and existing != bid:
            # duplicate content (two seqs computed the same prefix block):
            # keep the first registration; this block stays unregistered and
            # will return to the uninit pool on release.
            return
        if meta.seq_hash is not None:
            self._by_hash.pop(meta.seq_hash, None)
        meta.seq_hash = seq_hash
        meta.tokens_hash = tokens_hash
        meta.parent_hash = parent_hash
        if meta.priority != priority and bid in self._reusable:
            # re-key the lazy-heap entry: the old one goes stale and is
            # skipped at pop time (the C++ pool re-keys its set entry)
            heapq.heappush(self._evict_heap,
                           (priority, meta.return_tick, bid))
        meta.priority = priority
        self._by_hash[seq_hash] = bid
        if self.on_stored is not None:
            self.on_stored(bid, seq_hash, tokens_hash, parent_hash)

    def hold(self, blocks: Sequence[int]) -> None:
        """Add one reference to already-held blocks (pins them across an
        asynchronous copy: the host write-back)."""
        for bid in blocks:
            if bid != 0:
                self._meta[bid].refcount += 1

    # ------------------------------------------------------------- release
    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference from each block; refcount-0 blocks become
        reusable (if registered) or uninitialized."""
        for bid in blocks:
            if bid == 0:
                continue
            meta = self._meta[bid]
            if meta.refcount == 0:
                continue          # double release is a no-op
            meta.refcount -= 1
            if meta.refcount == 0:
                self._tick += 1
                meta.return_tick = self._tick
                if meta.seq_hash is not None:
                    self._reusable[bid] = meta.seq_hash
                    heapq.heappush(
                        self._evict_heap,
                        (meta.priority, meta.return_tick, bid))
                else:
                    self._free_uninit.add(bid)

    def reset(self) -> None:
        """Drop all reusable content (reference reuse.rs ``reset``)."""
        for bid in list(self._reusable):
            self._invalidate(bid)
            self._free_uninit.add(bid)

    # ------------------------------------------------------------ relocate
    def refcounts(self, blocks: Sequence[int]) -> List[int]:
        """Live refcounts (0 for the trash block): the defrag pass skips
        blocks shared across sequences (refcount != 1)."""
        return [0 if bid == 0 else self._meta[bid].refcount
                for bid in blocks]

    def relocate(self, moves) -> None:
        """Rebind resident blocks old→new after the engine copied their
        device contents (the defrag pass): hash registrations and
        refcounts follow the move, the old ids return to the free-run
        index. Each ``new`` must be a freshly alloc_uninit'd block
        (refcount 1, unregistered) and each ``old`` a resident block; no
        stored/removed events fire (the hashes are unchanged and block ids
        are worker-local)."""
        for old, new in moves:
            m_old, m_new = self._meta[old], self._meta[new]
            if m_new.seq_hash is not None or m_new.refcount != 1:
                raise ValueError(
                    f"relocate target {new} is not a fresh uninit block")
            if m_old.refcount < 1:
                raise ValueError(f"relocate source {old} is not resident")
            m_new.refcount = m_old.refcount
            m_new.priority = m_old.priority
            m_new.return_tick = m_old.return_tick
            if m_old.seq_hash is not None:
                m_new.seq_hash = m_old.seq_hash
                m_new.tokens_hash = m_old.tokens_hash
                m_new.parent_hash = m_old.parent_hash
                self._by_hash[m_new.seq_hash] = new
            m_old.seq_hash = None
            m_old.tokens_hash = None
            m_old.parent_hash = None
            m_old.refcount = 0
            self._free_uninit.add(old)
            self.defrag_moves_total += 1

    def registered_entries(self) -> List[Tuple[int, int, int, Optional[int]]]:
        """Every registered block as (bid, seq_hash, tokens_hash,
        parent_hash)."""
        out = []
        for seq_hash, bid in self._by_hash.items():
            m = self._meta[bid]
            out.append((bid, seq_hash, m.tokens_hash, m.parent_hash))
        return out

    def reannounce(self, announce: Optional[Callable] = None) -> int:
        """Re-publish every registered block through ``announce`` (default:
        the ``on_stored`` sink), parents before children so a radix indexer
        re-chains without re-rooting. The recovery hook for a transient
        lease expiry: the router wiped this worker's index on the DELETE
        watch events, the lease reclaim replayed only discovery KEYS —
        this replays the KV content announcements."""
        announce = announce or self.on_stored
        if announce is None:
            return 0
        pending = self.registered_entries()
        emitted: set = set()
        n = 0
        while pending:
            progress = False
            deferred = []
            for bid, seq_hash, tokens_hash, parent in pending:
                if parent is None or parent in emitted:
                    announce(bid, seq_hash, tokens_hash, parent)
                    emitted.add(seq_hash)
                    n += 1
                    progress = True
                else:
                    deferred.append((bid, seq_hash, tokens_hash, parent))
            if not progress:
                # orphans (parent evicted): emit anyway — the indexer
                # re-roots unknown parents at the top
                for bid, seq_hash, tokens_hash, parent in deferred:
                    announce(bid, seq_hash, tokens_hash, parent)
                    n += 1
                break
            pending = deferred
        return n


def make_kv_block_pool(num_blocks: int, on_stored=None, on_removed=None,
                       prefer_native: bool = True):
    """Pool factory: the C++ pool (``csrc/host/kv_reuse_pool.cpp``) unless
    ``prefer_native`` is false or ``DYN_NATIVE_KVPOOL=0``, else the Python
    implementation above. Both expose the identical interface. Unlike the
    JAX package's factory, a native pool that was asked for and does not
    build or load raises instead of quietly becoming the Python pool."""
    if prefer_native and os.environ.get("DYN_NATIVE_KVPOOL", "1") != "0":
        from .native_pool import NativeKvBlockPool
        return NativeKvBlockPool(num_blocks, on_stored=on_stored,
                                 on_removed=on_removed)
    return KvBlockPool(num_blocks, on_stored=on_stored,
                       on_removed=on_removed)


@dataclasses.dataclass
class PrefillPlan:
    """Outcome of preparing a sequence for prefill (reference
    `KvStorageManager::prepare_prefill_sequence` /
    `prepare_prefill_offload`, kv/manager.rs)."""

    hit_blocks: List[int]
    new_blocks: List[int]
    hit_tokens: int
    seq: TokenBlockSequence
    # host-tier hits: slots of the HostKvPool whose content is copied into
    # the first len(host_slots) entries of new_blocks before prefill
    host_slots: List[int] = dataclasses.field(default_factory=list)
    # disk-tier hits: chained hashes resident in the DiskKvStore, copied
    # into new_blocks[len(host_slots):len(host_slots) + len(disk_hashes)]
    # by the same onboard; pinned against spill-pump eviction from the
    # match until the onboard's read has run
    disk_hashes: List[int] = dataclasses.field(default_factory=list)
    # remote (G4) tier hits: chained hashes reachable through the
    # RemoteKvStore (the shared object store, or a peer's host / disk over
    # the fabric), the onboard run's tail after the disk hits. The store's
    # match went through the admission gate; object-held entries are
    # pinned until the onboard's read, and a failed fetch clears this list
    # (the engine recomputes those tokens)
    remote_hashes: List[int] = dataclasses.field(default_factory=list)

    @property
    def all_blocks(self) -> List[int]:
        return self.hit_blocks + self.new_blocks

    @property
    def host_hit_tokens(self) -> int:
        return len(self.host_slots) * self.seq.block_size

    @property
    def disk_hit_tokens(self) -> int:
        return len(self.disk_hashes) * self.seq.block_size

    @property
    def remote_hit_tokens(self) -> int:
        return len(self.remote_hashes) * self.seq.block_size


class KvBlockManager:
    """Pool + hashing glue the engine admit path calls, optionally backed
    by a host tier, a disk tier under it and a remote tier under that:
    device misses cascade device → host → disk → remote (reference
    ``prepare_prefill_offload``, down the Device → Host → Disk → Remote
    ladder)."""

    def __init__(self, num_blocks: int, block_size: int,
                 on_stored=None, on_removed=None, enable_reuse: bool = True,
                 host_pool=None, disk_store=None, remote_store=None,
                 prefer_native: bool = True):
        self.block_size = block_size
        self.pool = make_kv_block_pool(num_blocks, on_stored=on_stored,
                                       on_removed=on_removed,
                                       prefer_native=prefer_native)
        self.enable_reuse = enable_reuse
        self.host_pool = host_pool
        self.disk_store = disk_store
        self.remote_store = remote_store

    def prepare_prefill(self, prompt: Sequence[int], extra_blocks: int = 1,
                        seq: Optional[TokenBlockSequence] = None,
                        cold: bool = False) -> Optional[PrefillPlan]:
        """Match the prompt's full blocks against the pool (device tier,
        then host, then disk), allocate the remainder (+ room for
        ``extra_blocks`` of generation). None = out of memory. At least
        one prompt token is always left to recompute so prefill produces
        the first-token logits. ``seq`` may carry the prompt's
        already-computed hash chain. ``cold=True`` skips the host, disk and
        remote cascade (the engine's retry after a tier read failed)."""
        if seq is None:
            seq = TokenBlockSequence(self.block_size, prompt)
        matchable = seq.sequence_hashes
        # never match the *entire* prompt — hold back the final block so at
        # least one token runs through prefill
        if len(prompt) % self.block_size == 0 and matchable:
            matchable = matchable[:-1]
        hit_blocks = (self.pool.match_prefix(matchable)
                      if self.enable_reuse else [])
        hit_tokens = len(hit_blocks) * self.block_size
        host_slots: List[int] = []
        disk_hashes: List[int] = []
        if self.enable_reuse and not cold and self.host_pool is not None:
            host_slots = self.host_pool.match_prefix(
                matchable[len(hit_blocks):])
        if self.enable_reuse and not cold and self.disk_store is not None:
            # the run of hashes past the host hits; pin=True holds them
            # against the spill pump's capacity evictions (a worker
            # thread) until the onboard has read them (the engine unpins)
            disk_hashes = self.disk_store.match_prefix(
                matchable[len(hit_blocks) + len(host_slots):], pin=True)
        remote_hashes: List[int] = []
        # from the pin-taking matches to the returned plan (which hands the
        # pins to the caller), an unexpected raise (a faulty remote store,
        # a native-pool ABI error) must release the device holds and the
        # tier pins before it propagates
        try:
            if (self.enable_reuse and not cold
                    and self.remote_store is not None):
                # the run past the disk hits, reachable through the
                # remote tier; its match is admission-gated (a miss when
                # the modeled fetch loses to the modeled recompute) and
                # pins the object-held entries against the reaper
                remote_hashes = self.remote_store.match_prefix(
                    matchable[len(hit_blocks) + len(host_slots)
                              + len(disk_hashes):], pin=True)
            total_needed = (len(prompt) + extra_blocks * self.block_size
                            + self.block_size - 1) // self.block_size
            new_blocks = self.pool.alloc_uninit(total_needed
                                                - len(hit_blocks))
            if new_blocks is None:
                self.pool.release(hit_blocks)
                self._unpin_tiers(disk_hashes, remote_hashes)
                return None
            if len(new_blocks) < (len(host_slots) + len(disk_hashes)
                                  + len(remote_hashes)):
                # the onboard scatters the tier hits into
                # new_blocks[:n_onboard]: a plan whose allocation cannot
                # cover them would drop them or scatter past it. The
                # cascade's arithmetic rules this out; a tier that
                # over-returns fails loudly here (the except releases)
                self.pool.release(new_blocks)
                raise RuntimeError(
                    f"prepare_prefill invariant violated: "
                    f"{len(new_blocks)} new blocks cannot cover "
                    f"{len(host_slots)} host + {len(disk_hashes)} disk "
                    f"+ {len(remote_hashes)} remote tier hits (prompt "
                    f"{len(prompt)}, device hits {len(hit_blocks)})")
        except Exception:
            self.pool.release(hit_blocks)
            self._unpin_tiers(disk_hashes, remote_hashes)
            raise
        return PrefillPlan(hit_blocks=hit_blocks, new_blocks=new_blocks,
                           hit_tokens=hit_tokens, seq=seq,
                           host_slots=host_slots, disk_hashes=disk_hashes,
                           remote_hashes=remote_hashes)

    def _unpin_tiers(self, disk_hashes: List[int],
                     remote_hashes: List[int]) -> None:
        if disk_hashes:
            self.disk_store.unpin(disk_hashes)
        if remote_hashes:
            self.remote_store.unpin(remote_hashes)

    def abort_plan(self, plan: "PrefillPlan") -> None:
        """Release a plan that will never admit: the device holds drop and
        the disk and remote pins taken at the match release."""
        self.pool.release(plan.all_blocks)
        self._unpin_tiers(plan.disk_hashes, plan.remote_hashes)

    def register_full_blocks(self, plan_blocks: List[int],
                             seq: TokenBlockSequence,
                             already_registered: int) -> int:
        """Register every newly-full block of `seq` (device block order ==
        block-hash order). Returns the new count of registered blocks."""
        n_full = seq.num_full_blocks
        for i in range(already_registered, n_full):
            if i >= len(plan_blocks):
                break
            parent = seq.sequence_hashes[i - 1] if i > 0 else None
            self.pool.register(plan_blocks[i], seq.sequence_hashes[i],
                               seq.block_hashes[i], parent)
        return min(n_full, len(plan_blocks))
