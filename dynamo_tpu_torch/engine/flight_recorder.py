"""Engine flight recorder: a bounded ring of per-dispatch records and an
event-loop lag probe, read through the HTTP service's ``GET /debug``.

Counterpart of ``dynamo_tpu.engine.flight_recorder``. The engine core calls
``record(kind, **fields)`` from its loop (append-only, scalar fields) for
every admission prefill (with its device, host and disk hit tokens),
decode dispatch, ragged dispatch, verify dispatch, preemption, KV-tier
onboard and defrag pass; ``dump()`` returns the ring, newest last. A process-wide
weak registry lets ``/debug`` list every live engine's recorder.

The ``llmctl trace dump`` plumbing of the JAX module (``trace/`` keys and
the worker's watch loop) waits for the port's runtime and tracer (ROADMAP
A7, A10).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
import weakref
from collections import deque
from typing import Dict, List, Optional

logger = logging.getLogger("dynamo_tpu_torch.engine.flight")

__all__ = ["FlightRecorder", "register_recorder", "all_recorders"]

_REGISTRY: "weakref.WeakValueDictionary[str, FlightRecorder]" = \
    weakref.WeakValueDictionary()
_ids = itertools.count()


class FlightRecorder:
    """Bounded ring of per-dispatch records and the loop-lag probe."""

    def __init__(self, capacity: int = 512,
                 lag_probe_interval: float = 0.5):
        self._ring: deque = deque(maxlen=capacity)
        self.capacity = capacity
        self.records_total = 0
        self.lag_probe_interval = lag_probe_interval
        self.loop_lag_ms = 0.0       # the last probe's scheduling delay
        self.loop_lag_max_ms = 0.0   # its high-water mark since start
        self._probe_task: Optional[asyncio.Task] = None

    def record(self, kind: str, **fields) -> None:
        """Append one record (called synchronously from the engine loop;
        scalar fields only)."""
        self.records_total += 1
        self._ring.append({"kind": kind, "t": time.time(), **fields})

    def dump(self, last: Optional[int] = None) -> List[dict]:
        out = list(self._ring)
        return out[-last:] if last else out

    def stats(self) -> dict:
        kinds: Dict[str, int] = {}
        for r in self._ring:
            kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
        return {"records_total": self.records_total,
                "ring": len(self._ring), "capacity": self.capacity,
                "kinds": kinds,
                "loop_lag_ms": round(self.loop_lag_ms, 3),
                "loop_lag_max_ms": round(self.loop_lag_max_ms, 3)}

    def start_lag_probe(self) -> None:
        """Start the probe task on the running loop (idempotent)."""
        if self._probe_task is not None and not self._probe_task.done():
            return
        self._probe_task = asyncio.get_running_loop().create_task(
            self._probe_loop(), name="engine-lag-probe")

    def stop_lag_probe(self) -> None:
        if self._probe_task is not None:
            self._probe_task.cancel()
            self._probe_task = None

    async def _probe_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(self.lag_probe_interval)
            lag_ms = max(loop.time() - t0 - self.lag_probe_interval,
                         0.0) * 1e3
            self.loop_lag_ms = lag_ms
            if lag_ms > self.loop_lag_max_ms:
                self.loop_lag_max_ms = lag_ms
                if lag_ms > 100.0:
                    logger.warning("event-loop lag %.0fms — something is "
                                   "blocking the engine loop", lag_ms)


def register_recorder(recorder: FlightRecorder,
                      name: Optional[str] = None) -> str:
    """Register ``recorder`` for ``/debug`` (weakly: a collected engine's
    recorder drops out). Returns its name."""
    name = name or f"engine-{next(_ids)}"
    _REGISTRY[name] = recorder
    return name


def all_recorders() -> Dict[str, FlightRecorder]:
    return dict(_REGISTRY)
