"""KV-aware routing: the radix index of which worker holds which blocks,
the scheduler, the router and the worker-side publishers (copies of
``dynamo_tpu.llm.kv_router``)."""

from .indexer import KvIndexer, OverlapScores
from .protocols import (ForwardPassMetrics, KVHitRateEvent, KvRemovedEvent,
                        KvStoredEvent, RouterEvent)
from .router import KvRouter
from .scheduler import KvScheduler
from .scoring import Endpoint, ProcessedEndpoints

__all__ = [
    "KvIndexer", "OverlapScores", "KvRouter",
    "KvScheduler", "Endpoint", "ProcessedEndpoints", "ForwardPassMetrics",
    "KVHitRateEvent", "KvStoredEvent", "KvRemovedEvent", "RouterEvent",
]
