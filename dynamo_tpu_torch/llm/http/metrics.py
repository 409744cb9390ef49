"""Prometheus metrics for the HTTP frontend, on the standard library.

Counterpart of ``dynamo_tpu.llm.http.metrics`` (reference
lib/llm/src/http/service/metrics.rs:36-346): the same
``nv_llm_http_service_*`` series, labels and buckets, and the RAII
``InflightGuard`` that decrements the inflight gauge and counts the request
under exactly one of {success, error, cancelled} however its stream ends.
The GPU machine has no ``prometheus_client``, so ``render`` writes the text
exposition (format 0.0.4) as that package's ``generate_latest`` does:
labels sorted by name, and each counter's and histogram's ``_created``
series in a gauge family of its own after the family's samples.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

PREFIX = "nv_llm_http_service"

REQUEST_STATUS_SUCCESS = "success"
REQUEST_STATUS_ERROR = "error"
REQUEST_STATUS_CANCELLED = "cancelled"


def _go_float(d: float) -> str:
    """prometheus_client's ``floatToGoString``."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _sample(name: str, labels: Dict[str, str], value: float) -> str:
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return f"{name}{{{body}}} {_go_float(value)}\n" if body \
        else f"{name} {_go_float(value)}\n"


class _Family:
    """One metric family: its children by label values."""

    kind = ""

    def __init__(self, name: str, doc: str, labelnames: Sequence[str]):
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def labels(self, *values):
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new()
        return child

    def _new(self):
        raise NotImplementedError

    def _head(self, name: str, kind: str) -> List[str]:
        doc = self.doc.replace("\\", r"\\").replace("\n", r"\n")
        return [f"# HELP {name} {doc}\n", f"# TYPE {name} {kind}\n"]

    def render(self) -> List[str]:
        raise NotImplementedError


class _Value:
    def __init__(self):
        self.value = 0.0
        self.created = time.time()
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount


class Counter(_Family):
    def _new(self):
        return _Value()

    def render(self) -> List[str]:
        base = self.name[:-len("_total")] if self.name.endswith("_total") \
            else self.name
        out = self._head(f"{base}_total", "counter")
        created = []
        for key, c in self._children.items():
            labels = dict(zip(self.labelnames, key))
            out.append(_sample(f"{base}_total", labels, c.value))
            created.append(_sample(f"{base}_created", labels, c.created))
        if created:
            out += self._head(f"{base}_created", "gauge") + created
        return out


class Gauge(_Family):
    def _new(self):
        return _Value()

    def render(self) -> List[str]:
        out = self._head(self.name, "gauge")
        for key, c in self._children.items():
            out.append(_sample(self.name, dict(zip(self.labelnames, key)),
                               c.value))
        return out


class _HistogramChild:
    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = bounds
        self.counts = [0.0] * len(bounds)
        self.sum = 0.0
        self.created = time.time()
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += value
            for i, b in enumerate(self.bounds):
                if value <= b:
                    self.counts[i] += 1
                    break


class Histogram(_Family):
    def __init__(self, name: str, doc: str, labelnames: Sequence[str],
                 buckets: Sequence[float]):
        super().__init__(name, doc, labelnames)
        self.bounds = tuple(float(b) for b in buckets) + (math.inf,)

    def _new(self):
        return _HistogramChild(self.bounds)

    def render(self) -> List[str]:
        out = self._head(self.name, "histogram")
        created = []
        for key, h in self._children.items():
            labels = dict(zip(self.labelnames, key))
            acc = 0.0
            for b, n in zip(h.bounds, h.counts):
                acc += n
                out.append(_sample(f"{self.name}_bucket",
                                   {**labels, "le": _go_float(b)}, acc))
            out.append(_sample(f"{self.name}_count", labels, acc))
            out.append(_sample(f"{self.name}_sum", labels, h.sum))
            created.append(_sample(f"{self.name}_created", labels,
                                   h.created))
        if created:
            out += self._head(f"{self.name}_created", "gauge") + created
        return out


class ServiceMetrics:
    def __init__(self):
        self.requests_total = Counter(
            f"{PREFIX}_requests_total",
            "Total requests by model/endpoint/type/status",
            ["model", "endpoint", "request_type", "status"])
        self.inflight = Gauge(
            f"{PREFIX}_inflight_requests",
            "Currently inflight requests",
            ["model", "endpoint"])
        self.request_duration = Histogram(
            f"{PREFIX}_request_duration_seconds",
            "End-to-end request duration",
            ["model", "endpoint"],
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                     120.0))
        self.time_to_first_token = Histogram(
            f"{PREFIX}_time_to_first_token_seconds",
            "TTFT per streaming request",
            ["model", "endpoint"],
            buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0))
        self.output_tokens = Counter(
            f"{PREFIX}_output_tokens_total",
            "Output tokens (streamed chunks) per model",
            ["model", "endpoint"])
        self.inter_token_latency = Histogram(
            f"{PREFIX}_inter_token_latency_seconds",
            "Gap between consecutive streamed tokens (ITL)",
            ["model", "endpoint"],
            buckets=(0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5))
        self._families = (self.requests_total, self.inflight,
                          self.request_duration, self.time_to_first_token,
                          self.output_tokens, self.inter_token_latency)

    def render(self) -> bytes:
        return "".join(line for f in self._families
                       for line in f.render()).encode()

    def inflight_guard(self, model: str, endpoint: str,
                       streaming: bool) -> "InflightGuard":
        return InflightGuard(self, model, endpoint, streaming)


class InflightGuard:
    """RAII-style inflight/request-status guard (reference metrics.rs
    `InflightGuard`): create on request admission, call `mark_ok()` on clean
    completion; anything else counts as error/cancelled on close."""

    def __init__(self, metrics: ServiceMetrics, model: str, endpoint: str,
                 streaming: bool):
        self._m = metrics
        self.model = model
        self.endpoint = endpoint
        self.request_type = "stream" if streaming else "unary"
        self._status = REQUEST_STATUS_ERROR
        self._start = time.monotonic()
        self._first_token_at: Optional[float] = None
        self._last_token_at: float = 0.0
        self._m.inflight.labels(model, endpoint).inc()
        self._closed = False

    def mark_ok(self) -> None:
        self._status = REQUEST_STATUS_SUCCESS

    def mark_cancelled(self) -> None:
        self._status = REQUEST_STATUS_CANCELLED

    def note_token(self, n: int = 1) -> None:
        now = time.monotonic()
        if self._first_token_at is None:
            self._first_token_at = now
            self._m.time_to_first_token.labels(self.model, self.endpoint).observe(
                now - self._start)
        else:
            # token-weighted ITL: the arrival gap is split across the n
            # tokens this chunk carries and observed once per token, so
            # histogram _count tracks output_tokens
            per_tok = (now - self._last_token_at) / max(n, 1)
            itl = self._m.inter_token_latency.labels(self.model,
                                                     self.endpoint)
            for _ in range(max(n, 1)):
                itl.observe(per_tok)
        self._last_token_at = now
        self._m.output_tokens.labels(self.model, self.endpoint).inc(n)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._m.inflight.labels(self.model, self.endpoint).dec()
        self._m.requests_total.labels(
            self.model, self.endpoint, self.request_type, self._status).inc()
        self._m.request_duration.labels(self.model, self.endpoint).observe(
            time.monotonic() - self._start)
