"""KV indexer: the router's global radix/prefix index of which worker holds
which KV blocks.

Reference: lib/llm/src/kv_router/indexer.rs:139-790 (`RadixTree`,
`KvIndexer::new` single-writer event task, `compute_block_hash_for_seq`,
`KvIndexerSharded`). A copy of ``dynamo_tpu.llm.kv_router.indexer`` with
its pure-Python tree only: the JAX package's native tree
(``csrc/kv_radix_index.cpp`` behind ``RadixIndexNative``) and its sharded
indexer are not ported yet (ROADMAP A7); the Python tree has the native
one's semantics. The tree sits behind a
single-writer asyncio task so event application is serialized exactly like
the reference's mpsc actor.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from ..kv.blocks import compute_block_hashes
from .protocols import RouterEvent

__all__ = ["OverlapScores", "KvIndexer", "RadixIndexPython"]


class OverlapScores:
    """worker_id → number of consecutive leading request blocks that worker
    already holds (reference `OverlapScores`). With frequency tracking on
    (an ``expiration_s`` on the index), ``frequencies`` lists the matched
    blocks' recent-use counts inside the expiration window, outermost
    first — the scheduler's hotness signal (reference add_frequency,
    indexer.rs:429-436)."""

    def __init__(self, scores: Optional[Dict[int, int]] = None,
                 frequencies: Optional[List[int]] = None,
                 weighted: Optional[Dict[int, float]] = None,
                 remote_blocks: Optional[Dict[int, int]] = None):
        self.scores: Dict[int, int] = scores or {}
        self.frequencies: List[int] = frequencies or []
        # tier-discounted effective overlap per worker (scoring.py
        # TIER_WEIGHTS): equals ``scores`` when every matched block is
        # device-resident. The scheduler consumes this, so a worker whose
        # matched prefix lives on disk wins ties only against recompute,
        # not against an HBM-resident copy elsewhere.
        self.weighted: Dict[int, float] = (
            dict(weighted) if weighted is not None else dict(self.scores))
        # worker → how many of its matched blocks carry tier "remote"
        # (a fabric fetch away, not local). The scheduler's NetKV
        # scoring keeps their credit only when that worker's modeled
        # transfer beats its modeled recompute (scoring.py
        # network_adjusted_overlap).
        self.remote_blocks: Dict[int, int] = dict(remote_blocks or {})

    @property
    def fleet_depth(self) -> int:
        """Deepest overlap any worker holds — the fabric makes those
        blocks fetchable by every attached candidate."""
        return max(self.scores.values(), default=0)

    def best(self) -> Optional[int]:
        if not self.scores:
            return None
        return max(self.scores, key=lambda w: self.scores[w])

    def __repr__(self) -> str:
        if self.frequencies:
            return f"OverlapScores({self.scores}, freq={self.frequencies})"
        return f"OverlapScores({self.scores})"


# ---------------------------------------------------------------------------
# The radix tree
# ---------------------------------------------------------------------------


class _PyNode:
    __slots__ = ("hash", "parent", "children", "workers", "recent_uses")

    def __init__(self, h: int = 0, parent=None):
        self.hash = h
        self.parent = parent
        self.children: Dict[int, "_PyNode"] = {}
        self.workers: set = set()
        self.recent_uses: deque = deque()   # timestamps inside the window


class RadixIndexPython:
    def __init__(self, expiration_s: Optional[float] = None):
        self._root = _PyNode()
        self._by_hash: Dict[int, _PyNode] = {}
        self._worker_nodes: Dict[int, set] = {}
        # normalize: <=0 means off (the JAX package's native tree's gate)
        if expiration_s is not None and expiration_s <= 0:
            expiration_s = None
        self.expiration_s = expiration_s
        self._event_count = 0    # mirrors RadixIndex::event_count

    def _find(self, h: Optional[int]) -> Optional[_PyNode]:
        if not h:
            return self._root
        return self._by_hash.get(h)

    def apply_stored(self, worker_id, parent_hash, block_hashes) -> None:
        self._event_count += 1
        node = self._find(parent_hash) or self._root
        for h in block_hashes:
            child = node.children.get(h)
            if child is None:
                child = _PyNode(h, node)
                node.children[h] = child
                self._by_hash[h] = child
            child.workers.add(worker_id)
            self._worker_nodes.setdefault(worker_id, set()).add(child)
            node = child

    def _detach_if_empty(self, node: _PyNode) -> None:
        while (node is not None and node is not self._root
               and not node.workers and not node.children):
            parent = node.parent
            if self._by_hash.get(node.hash) is node:  # only the map's holder
                del self._by_hash[node.hash]
            parent.children.pop(node.hash, None)
            node = parent

    def apply_removed(self, worker_id, block_hashes) -> None:
        self._event_count += 1
        for h in block_hashes:
            node = self._by_hash.get(h)
            if node is None:
                continue
            node.workers.discard(worker_id)
            nodes = self._worker_nodes.get(worker_id)
            if nodes:
                nodes.discard(node)
            self._detach_if_empty(node)

    def remove_worker(self, worker_id) -> None:
        # as the JAX package's native tree does: snapshot hash values, then
        # detach via the flat map's current holder
        self._event_count += 1
        nodes = self._worker_nodes.pop(worker_id, set())
        hashes = []
        for node in nodes:
            node.workers.discard(worker_id)
            hashes.append(node.hash)
        for h in hashes:
            node = self._by_hash.get(h)
            if node is not None:
                self._detach_if_empty(node)

    def find_matches(self, block_hashes,
                     now: Optional[float] = None) -> OverlapScores:
        scores: Dict[int, int] = {}
        freqs: List[int] = []
        exp = self.expiration_s
        if exp is not None and now is None:
            now = time.monotonic()
        node = self._root
        for depth, h in enumerate(block_hashes):
            node = node.children.get(h)
            if node is None:
                break
            any_advance = False
            for w in node.workers:
                if scores.get(w, 0) == depth:
                    scores[w] = depth + 1
                    any_advance = True
            if exp is not None:
                # expire stale uses, report survivors, record this access
                # (reference find_matches, indexer.rs:252-263)
                uses = node.recent_uses
                while uses and now - uses[0] > exp:
                    uses.popleft()
                if uses:
                    freqs.append(len(uses))
                uses.append(now)
            if not any_advance:
                break
        return OverlapScores(scores, freqs)

    def node_count(self) -> int:
        # count actual tree nodes, not the flat map: duplicate hashes from
        # out-of-order re-roots occupy two tree positions but one map slot
        def cnt(n: _PyNode) -> int:
            return 1 + sum(cnt(c) for c in n.children.values())
        return cnt(self._root) - 1

    def event_count(self) -> int:
        """Events applied (stored/removed/remove_worker) since creation —
        the staleness/liveness stat the router status surface reads."""
        return self._event_count

    def worker_blocks(self, worker_id) -> int:
        """How many tree nodes list ``worker_id``."""
        return len(self._worker_nodes.get(worker_id, ()))


# ---------------------------------------------------------------------------
# KvIndexer: single-writer event application + query API
# ---------------------------------------------------------------------------


class KvIndexer:
    """Applies RouterEvents to the tree from one task; queries compute block
    hashes for the request tokens then walk the tree (reference
    KvIndexer::new / find_matches_for_request)."""

    def __init__(self, block_size: int,
                 expiration_s: Optional[float] = None):
        """``expiration_s`` enables frequency tracking: matched blocks
        report their recent-use counts inside that window via
        OverlapScores.frequencies (reference KvIndexer::new_with_frequency,
        indexer.rs:525-560)."""
        self.block_size = block_size
        self.tree = RadixIndexPython(expiration_s)
        # (worker_id, seq_hash) → tier, tracked OUTSIDE the tree (both
        # tree backends stay tier-agnostic; device is the implicit
        # default and never stored here)
        self._tiers: Dict[tuple, str] = {}
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None

    # -- event side
    def apply_event(self, event: RouterEvent) -> None:
        if event.stored is not None:
            self.tree.apply_stored(event.worker_id, event.stored.parent_hash,
                                   event.stored.block_hashes)
            tier = getattr(event.stored, "tier", "device") or "device"
            for h in event.stored.block_hashes:
                key = (event.worker_id, h)
                if tier == "device":
                    # promotion back to HBM restores full weight
                    self._tiers.pop(key, None)
                else:
                    self._tiers[key] = tier
        if event.removed is not None:
            self.tree.apply_removed(event.worker_id,
                                    event.removed.block_hashes)
            for h in event.removed.block_hashes:
                self._tiers.pop((event.worker_id, h), None)

    async def enqueue_event(self, event: RouterEvent) -> None:
        self._ensure_task()
        await self._queue.put(event)

    def _ensure_task(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="kv-indexer")

    async def _run(self) -> None:
        while True:
            ev = await self._queue.get()
            self.apply_event(ev)

    async def drain(self) -> None:
        while not self._queue.empty():
            await asyncio.sleep(0)

    def worker_blocks(self, worker_id: int) -> int:
        """The blocks the index holds of ``worker_id`` (0 once it was
        pruned)."""
        return self.tree.worker_blocks(worker_id)

    def remove_worker(self, worker_id: int) -> None:
        self.tree.remove_worker(worker_id)
        self._tiers = {k: v for k, v in self._tiers.items()
                       if k[0] != worker_id}

    # -- query side
    def find_matches(self, block_hashes: Sequence[int]) -> OverlapScores:
        scores = self.tree.find_matches(block_hashes)
        if self._tiers:
            from .scoring import TIER_WEIGHTS
            for w, depth in scores.scores.items():
                eff = 0.0
                remote = 0
                for i in range(depth):
                    tier = self._tiers.get((w, block_hashes[i]), "device")
                    eff += TIER_WEIGHTS.get(tier, 1.0)
                    if tier == "remote":
                        remote += 1
                scores.weighted[w] = eff
                if remote:
                    scores.remote_blocks[w] = remote
        return scores

    def find_matches_for_request(self, token_ids: Sequence[int]
                                 ) -> OverlapScores:
        return self.find_matches(
            compute_block_hashes(token_ids, self.block_size))
