"""Core async-engine abstraction (a copy of ``dynamo_tpu.runtime.engine``): the analog of the reference's
``AsyncEngine`` trait (reference: lib/runtime/src/engine.rs:47-168).

Everything that produces a stream of responses from a single request — a model
engine, a remote client, a whole pipeline — implements :class:`AsyncEngine`.
Requests travel wrapped in a :class:`Context` (reference ``Context<T>``,
lib/runtime/src/pipeline/context.rs) that carries a request id, metadata and a
cancellation handle (:class:`EngineContext`, reference ``AsyncEngineContext``).

Cancellation is *step-granular*: a model step on the device cannot be
interrupted mid-dispatch, so engines poll ``ctx.is_stopped`` between decode
steps rather than rely on task cancellation.
"""

from __future__ import annotations

import abc
import asyncio
import uuid
from typing import (Any, AsyncIterator, Awaitable, Callable, Dict, Generic,
                    Optional, TypeVar)

T = TypeVar("T")
U = TypeVar("U")

__all__ = [
    "EngineContext",
    "Context",
    "SingleIn",
    "ManyOut",
    "ResponseStream",
    "AsyncEngine",
    "EngineFn",
    "engine_from_fn",
]


class EngineContext:
    """Cancellation + identity handle shared by a request and all streams
    derived from it.

    Mirrors the semantics of the reference's ``AsyncEngineContext``
    (lib/runtime/src/engine.rs:47-100):

    - ``stop_generating()`` — graceful: the engine should finish the current
      step, emit what it has, and stop issuing new work.
    - ``kill()`` — hard: downstream should drop the stream as soon as possible
      (used by the HTTP layer when a client disconnects mid-SSE).
    - ``deadline_s`` — optional absolute end-to-end deadline
      (``time.monotonic()`` clock). Set at the frontend from the
      request's ``deadline_ms`` budget, propagated on the wire as the
      REMAINING budget (codec.RequestControlMessage.deadline_ms), and
      polled by engines between steps exactly like cancellation — a
      request whose client stopped caring vacates its slot instead of
      burning capacity.
    - ``tenant`` / ``qos`` — multi-tenant identity (llm/tenancy.py):
      set at the frontend from ``nvext.tenant``/``nvext.priority`` and
      propagated on the wire (codec.RequestControlMessage tenant /
      priority) so routers and workers price per-tenant fair share and
      KV quotas without re-parsing the payload.
    """

    __slots__ = ("_id", "_stopped", "_killed", "_stop_event", "deadline_s",
                 "tenant", "qos")

    def __init__(self, request_id: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 tenant: Optional[str] = None,
                 qos: Optional[str] = None):
        self._id = request_id or uuid.uuid4().hex
        self._stopped = False
        self._killed = False
        self._stop_event: Optional[asyncio.Event] = None
        self.deadline_s: Optional[float] = None
        self.tenant = tenant
        self.qos = qos
        if deadline_ms is not None:
            self.set_deadline_ms(deadline_ms)

    @property
    def id(self) -> str:
        return self._id

    def stop_generating(self) -> None:
        self._stopped = True
        if self._stop_event is not None:
            self._stop_event.set()

    def kill(self) -> None:
        self._killed = True
        self.stop_generating()

    @property
    def is_stopped(self) -> bool:
        return self._stopped

    @property
    def is_killed(self) -> bool:
        return self._killed

    async def stopped(self) -> None:
        """Await until stop_generating()/kill() is called."""
        if self._stop_event is None:
            self._stop_event = asyncio.Event()
            if self._stopped:
                self._stop_event.set()
        await self._stop_event.wait()

    # ----------------------------------------------------------- deadline
    def set_deadline_ms(self, budget_ms: float) -> None:
        """Arm (or tighten) the end-to-end deadline ``budget_ms`` from
        now. A second call never LOOSENS an armed deadline — each hop
        may only shrink the remaining budget."""
        import time
        d = time.monotonic() + max(float(budget_ms), 0.0) / 1e3
        if self.deadline_s is None or d < self.deadline_s:
            self.deadline_s = d

    @property
    def deadline_exceeded(self) -> bool:
        if self.deadline_s is None:
            return False
        import time
        return time.monotonic() >= self.deadline_s


class Context(Generic[T]):
    """A request payload plus its engine context and metadata.

    Reference ``Context<T>`` / ``SingleIn<T>``
    (lib/runtime/src/pipeline/context.rs, pipeline.rs:41-68). ``map`` derives a
    new payload while keeping id/cancellation; ``transfer`` swaps the payload
    entirely (used at operator boundaries where the type changes).
    """

    __slots__ = ("data", "ctx", "metadata")

    def __init__(self, data: T, ctx: Optional[EngineContext] = None,
                 metadata: Optional[Dict[str, Any]] = None):
        self.data = data
        self.ctx = ctx or EngineContext()
        self.metadata: Dict[str, Any] = metadata if metadata is not None else {}

    @property
    def id(self) -> str:
        return self.ctx.id

    def map(self, fn: Callable[[T], U]) -> "Context[U]":
        return self.transfer(fn(self.data))

    def transfer(self, data: U) -> "Context[U]":
        return Context(data, self.ctx, self.metadata)


# Type aliases matching the reference's pipeline vocabulary
# (lib/runtime/src/pipeline.rs:41-68).
SingleIn = Context


class ResponseStream(Generic[U]):
    """An async stream of responses bound to an :class:`EngineContext`.

    Reference ``ResponseStream`` / ``ManyOut`` (lib/runtime/src/engine.rs:120-168).
    Iteration stops early if the context is killed (not merely stopped: a
    graceful stop lets the engine flush its tail).
    """

    def __init__(self, stream: AsyncIterator[U], ctx: EngineContext):
        self._stream = stream
        self.ctx = ctx

    def __aiter__(self) -> AsyncIterator[U]:
        return self._iter()

    async def _iter(self) -> AsyncIterator[U]:
        async for item in self._stream:
            if self.ctx.is_killed:
                break
            yield item

    def map(self, fn: Callable[[U], T]) -> "ResponseStream[T]":
        async def gen() -> AsyncIterator[T]:
            async for item in self._stream:
                yield fn(item)

        return ResponseStream(gen(), self.ctx)


ManyOut = ResponseStream


class AsyncEngine(abc.ABC, Generic[T, U]):
    """The one core interface: ``generate(SingleIn[T]) -> ManyOut[U]``.

    Reference trait ``AsyncEngine<Req, Resp, Err>`` (lib/runtime/src/engine.rs:104-118).
    """

    @abc.abstractmethod
    async def generate(self, request: SingleIn[T]) -> ManyOut[U]:
        ...


class EngineFn(AsyncEngine[T, U]):
    """Adapter: build an engine from ``async fn(Context[T]) -> AsyncIterator[U]``
    (the closure-engine pattern used throughout the reference's tests,
    lib/runtime/tests/common/engines.rs)."""

    def __init__(self, fn: Callable[[SingleIn[T]], Any]):
        self._fn = fn

    async def generate(self, request: SingleIn[T]) -> ManyOut[U]:
        result = self._fn(request)
        if isinstance(result, Awaitable):
            result = await result
        if isinstance(result, ResponseStream):
            return result
        return ResponseStream(result, request.ctx)


def engine_from_fn(fn: Callable[[SingleIn[T]], Any]) -> EngineFn:
    return EngineFn(fn)
