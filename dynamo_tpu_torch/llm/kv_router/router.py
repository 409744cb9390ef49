"""KvRouter: indexer + scheduler glued into one `schedule(tokens)` service
(a copy of ``dynamo_tpu.llm.kv_router.router`` over the Python radix tree)
(reference lib/llm/src/kv_router/kv_router.rs:44-140 — subscribe `kv_events`,
feed the indexer, scrape metrics, pick a worker)."""

from __future__ import annotations

import logging
from typing import Optional, Sequence

from .indexer import KvIndexer
from .protocols import ForwardPassMetrics, RouterEvent
from .scheduler import KvScheduler
from .scoring import Endpoint, ProcessedEndpoints

logger = logging.getLogger("dynamo_tpu_torch.kv_router")


class KvRouter:
    def __init__(self, block_size: int, on_hit_rate=None,
                 frequency_expiration_s: Optional[float] = None):
        """``frequency_expiration_s`` turns on the indexer's per-block
        recent-use tracking (reference new_with_frequency); the matched
        blocks' hotness lands on ``self.last_frequencies`` after every
        schedule() — surfaced for external schedulers/telemetry exactly
        like the reference's OverlapScores.frequencies (which its own
        scheduler likewise does not consume internally)."""
        self.block_size = block_size
        self.indexer = KvIndexer(block_size,
                                 expiration_s=frequency_expiration_s)
        self.scheduler = KvScheduler(block_size, on_hit_rate=on_hit_rate)
        self.last_frequencies: list = []

    # -- feeds (wired to transports in the distributed runtime layer)
    def on_kv_event(self, event: RouterEvent) -> None:
        self.indexer.apply_event(event)

    def on_metrics(self, worker_metrics: dict) -> None:
        """worker_metrics: worker_id → ForwardPassMetrics (or dict)."""
        eps = []
        for wid, m in worker_metrics.items():
            if isinstance(m, dict):
                m = ForwardPassMetrics.from_dict(m)
            eps.append(Endpoint(worker_id=int(wid), metrics=m))
        self.scheduler.update_endpoints(ProcessedEndpoints(eps))

    def on_worker_gone(self, worker_id: int) -> None:
        self.indexer.remove_worker(worker_id)

    # -- decision
    def schedule(self, token_ids: Sequence[int],
                 exclude: Optional[set] = None) -> Optional[tuple]:
        """Returns (worker_id, overlap_blocks) or None if no workers.
        ``exclude`` bars draining workers from new admissions — their
        indexed blocks stay in the radix tree (they come back if the
        drain is cancelled), the scheduler just won't pick them."""
        overlap = self.indexer.find_matches_for_request(token_ids)
        self.last_frequencies = overlap.frequencies
        # the scheduler gets the FULL OverlapScores: tier-discounted
        # depth (scoring.py TIER_WEIGHTS) plus the NetKV network
        # adjustment — remote-tier credit gated on each candidate's
        # modeled transfer beating its modeled recompute, and
        # fabric-fetchable credit for blocks other workers hold
        worker = self.scheduler.schedule(len(token_ids), overlap,
                                         exclude=exclude)
        if worker is None:
            return None
        return worker, overlap.scores.get(worker, 0)
