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
``on_stored``/``on_removed`` callbacks are kept for a KV event publisher;
the host/disk/remote tiers of the JAX package are not wired here.
Single-threaded by design: one pool per engine loop.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
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

    # ------------------------------------------------------------- queries
    @property
    def free_blocks(self) -> int:
        return len(self._free_uninit) + len(self._reusable)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - self.free_blocks

    def hit_rate(self) -> float:
        return self.match_hits / max(self.match_queries, 1)

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


@dataclasses.dataclass
class PrefillPlan:
    """Outcome of preparing a sequence for prefill (reference
    `KvStorageManager::prepare_prefill_sequence`, kv/manager.rs)."""

    hit_blocks: List[int]
    new_blocks: List[int]
    hit_tokens: int
    seq: TokenBlockSequence

    @property
    def all_blocks(self) -> List[int]:
        return self.hit_blocks + self.new_blocks


class KvBlockManager:
    """Pool + hashing glue the engine admit path calls (device tier only)."""

    def __init__(self, num_blocks: int, block_size: int,
                 on_stored=None, on_removed=None, enable_reuse: bool = True):
        self.block_size = block_size
        self.pool = KvBlockPool(num_blocks, on_stored=on_stored,
                                on_removed=on_removed)
        self.enable_reuse = enable_reuse

    def prepare_prefill(self, prompt: Sequence[int], extra_blocks: int = 1,
                        seq: Optional[TokenBlockSequence] = None
                        ) -> Optional[PrefillPlan]:
        """Match the prompt's full blocks against the pool and allocate the
        remainder (+ room for ``extra_blocks`` of generation). None = out
        of memory. At least one prompt token is always left to recompute
        so prefill produces the first-token logits. ``seq`` may carry the
        prompt's already-computed hash chain."""
        if seq is None:
            seq = TokenBlockSequence(self.block_size, prompt)
        matchable = seq.sequence_hashes
        # never match the *entire* prompt — hold back the final block so at
        # least one token runs through prefill
        if len(prompt) % self.block_size == 0 and matchable:
            matchable = matchable[:-1]
        hit_blocks = (self.pool.match_prefix(matchable)
                      if self.enable_reuse else [])
        total_needed = (len(prompt) + extra_blocks * self.block_size
                        + self.block_size - 1) // self.block_size
        new_blocks = self.pool.alloc_uninit(total_needed - len(hit_blocks))
        if new_blocks is None:
            self.pool.release(hit_blocks)
            return None
        return PrefillPlan(hit_blocks=hit_blocks, new_blocks=new_blocks,
                           hit_tokens=len(hit_blocks) * self.block_size,
                           seq=seq)

    def abort_plan(self, plan: "PrefillPlan") -> None:
        """Release a plan that will never admit."""
        self.pool.release(plan.all_blocks)

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
