"""KV scheduler: pick the worker for a request given prefix overlap + load
(a copy of ``dynamo_tpu.llm.kv_router.scheduler``, its seeded
``random.Random(0)`` tie-break included; the JAX scheduler's per-tenant
counters wait for ``llm/tenancy.py``, ROADMAP A10).

Reference: lib/llm/src/kv_router/scheduler.rs:88-316 (`select_worker`). The
cost model re-implemented here keeps the reference's observable behavior:

- cost = alpha * load_deviation + (1 - alpha) * normalized_new_tokens
         + gamma * request_load_ratio
- balance mode: alpha = 0.7 when load_std > 0.1 * load_avg (loads diverging →
  weight load more), else alpha = 0.3 (loads even → weight cache hits more)
- workers with no free request slots are skipped
- optimistic local accounting: the chosen worker's active blocks/slots are
  bumped immediately so back-to-back decisions don't dogpile one worker
  before the next metrics scrape lands
- a KVHitRateEvent is emitted per decision
"""

from __future__ import annotations

import logging
import random
from typing import Callable, Optional

from .protocols import KVHitRateEvent
from .scoring import ProcessedEndpoints

logger = logging.getLogger("dynamo_tpu_torch.kv_scheduler")

GAMMA = 0.2

# indexer ⇄ scheduler would cycle at import time; resolve once on first
# use instead of per call (the routing hot path runs _effective_overlap
# once per candidate per decision)
_LAZY: tuple = ()


def _lazy_imports():
    global _LAZY
    if not _LAZY:
        from .indexer import OverlapScores
        from .scoring import network_adjusted_overlap
        _LAZY = (OverlapScores, network_adjusted_overlap)
    return _LAZY


class KvScheduler:
    def __init__(self, block_size: int,
                 on_hit_rate: Optional[Callable[[KVHitRateEvent], None]] = None,
                 rng: Optional[random.Random] = None):
        self.block_size = block_size
        self.on_hit_rate = on_hit_rate
        self.endpoints = ProcessedEndpoints([])
        self._rng = rng or random.Random(0)
        # optimistic deltas applied on top of the last scrape
        self._opt_blocks: dict = {}
        self._opt_slots: dict = {}

    def update_endpoints(self, endpoints: ProcessedEndpoints) -> None:
        self.endpoints = endpoints
        self._opt_blocks.clear()
        self._opt_slots.clear()

    def _effective_overlap(self, ep, overlap, fleet_depth: int) -> float:
        """One candidate's overlap credit. With a full OverlapScores in
        hand the credit is NETWORK-AWARE (NetKV): tier-discounted depth,
        with remote-tier blocks kept only when the candidate's modeled
        transfer beats its modeled recompute, plus fabric-fetchable
        credit for blocks other workers hold (scoring.py
        network_adjusted_overlap). A plain dict scores as before.

        (Imports are module-lazy via _lazy_imports(), NOT per-call: this
        runs once per candidate per routing decision — the router's
        hottest loop at fleet scale.)"""
        OverlapScores, network_adjusted_overlap = _lazy_imports()
        if not isinstance(overlap, OverlapScores):
            return overlap.get(ep.worker_id, 0)
        wid = ep.worker_id
        return network_adjusted_overlap(
            weighted=overlap.weighted.get(wid, 0.0),
            own_depth=overlap.scores.get(wid, 0),
            remote_depth=overlap.remote_blocks.get(wid, 0),
            fleet_depth=fleet_depth,
            block_size=self.block_size,
            m=ep.metrics)

    @staticmethod
    def _raw_overlap(overlap, worker_id: int):
        OverlapScores, _ = _lazy_imports()
        if isinstance(overlap, OverlapScores):
            return overlap.scores.get(worker_id, 0)
        return overlap.get(worker_id, 0)

    def schedule(self, isl_tokens: int, overlap_scores,
                 exclude: Optional[set] = None) -> Optional[int]:
        """Returns the chosen worker id, or None when no worker is usable.
        ``overlap_scores``: an indexer OverlapScores (network-aware
        scoring) or a plain {worker_id: effective_overlap} dict (legacy
        callers). ``exclude``: worker ids barred from NEW admissions
        (the planner's draining set) — skipped like full workers, so a
        drain shifts load instead of dropping requests."""
        OverlapScores, _ = _lazy_imports()
        eps = self.endpoints
        if not len(eps):
            return None
        isl_blocks = max((isl_tokens + self.block_size - 1) // self.block_size,
                         1)
        load_avg = eps.load_avg
        load_std = eps.load_std
        balance_mode = load_std > 0.1 * load_avg
        alpha = 0.7 if balance_mode else 0.3
        fleet_depth = (overlap_scores.fleet_depth
                       if isinstance(overlap_scores, OverlapScores) else 0)

        best_cost = None
        best_worker = None
        candidates = list(eps.endpoints.values())
        self._rng.shuffle(candidates)  # tie-break fairness
        for ep in candidates:
            if exclude and ep.worker_id in exclude:
                continue
            m = ep.metrics
            slots_used = (m.request_active_slots
                          + self._opt_slots.get(ep.worker_id, 0))
            if m.request_total_slots and slots_used >= m.request_total_slots:
                continue  # full worker
            overlap_blocks = min(
                self._effective_overlap(ep, overlap_scores, fleet_depth),
                isl_blocks)
            new_blocks = isl_blocks - overlap_blocks
            normalized_new = new_blocks / isl_blocks
            load = ep.load + self._opt_blocks.get(ep.worker_id, 0)
            # deviation normalized by the fleet average (not stddev — a tiny
            # stddev would explode the term and drown out cache overlap)
            load_dev = (load - load_avg) / max(load_avg, 1.0)
            req_ratio = (slots_used / m.request_total_slots
                         if m.request_total_slots else 0.0)
            cost = (alpha * load_dev + (1 - alpha) * normalized_new
                    + GAMMA * req_ratio)
            if best_cost is None or cost < best_cost:
                best_cost = cost
                best_worker = ep
        if best_worker is None:
            return None
        # optimistic accounting + routing hints use the RAW local depth:
        # the chosen worker's prefill skips exactly the blocks it itself
        # holds (a fabric fetch still allocates device blocks for them)
        overlap_blocks = min(self._raw_overlap(overlap_scores,
                                               best_worker.worker_id),
                             isl_blocks)
        # optimistic accounting until the next metrics scrape
        self._opt_blocks[best_worker.worker_id] = (
            self._opt_blocks.get(best_worker.worker_id, 0)
            + (isl_blocks - overlap_blocks))
        self._opt_slots[best_worker.worker_id] = (
            self._opt_slots.get(best_worker.worker_id, 0) + 1)
        if self.on_hit_rate is not None:
            # tier-weighted overlap may be fractional; the hit-rate
            # event's contract is whole blocks
            self.on_hit_rate(KVHitRateEvent(
                worker_id=best_worker.worker_id, isl_blocks=isl_blocks,
                overlap_blocks=int(round(overlap_blocks))))
        logger.debug("scheduled worker=%d cost=%.3f overlap=%d/%d alpha=%.1f",
                     best_worker.worker_id, best_cost, overlap_blocks,
                     isl_blocks, alpha)
        return best_worker.worker_id
