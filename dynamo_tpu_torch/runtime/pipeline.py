"""Typed request/response pipeline: Frontend → Operators → Backend(engine).

A copy of ``dynamo_tpu.runtime.pipeline``: a re-design of the reference's
bidirectional pipeline graph
(lib/runtime/src/pipeline/nodes.rs:70-180, nodes/{sources,sinks}.rs). The
reference wires explicit forward/backward edges between `Source`/`Sink` nodes;
here an :class:`Operator` is simply a stage that sees the forward request, the
downstream engine, and the backward response stream — composition produces one
:class:`AsyncEngine`, so a linked pipeline is itself an engine and can be
served, linked again, or called in-process.

    pipeline = link(preprocessor, backend, engine)
    stream = await pipeline.generate(Context(request))
"""

from __future__ import annotations

import abc
from typing import Generic, TypeVar

from .engine import AsyncEngine, ManyOut, SingleIn

Tin = TypeVar("Tin")
Tmid = TypeVar("Tmid")
Umid = TypeVar("Umid")
Uout = TypeVar("Uout")

__all__ = ["Operator", "link", "ServiceFrontend"]


class Operator(abc.ABC, Generic[Tin, Uout, Tmid, Umid]):
    """A pipeline stage that transforms the request on the way *forward* and
    the response stream on the way *backward*.

    Equivalent role to the reference's ``Operator``/``PipelineOperator`` with
    ``forward_edge``/``backward_edge`` (lib/runtime/src/pipeline/nodes.rs).
    """

    @abc.abstractmethod
    async def generate(self, request: SingleIn[Tin],
                       next_engine: AsyncEngine[Tmid, Umid]) -> ManyOut[Uout]:
        ...

    def attach(self, next_engine: AsyncEngine[Tmid, Umid]) -> AsyncEngine[Tin, Uout]:
        """Bind this operator onto a downstream engine, yielding an engine."""
        return _BoundOperator(self, next_engine)


class _BoundOperator(AsyncEngine[Tin, Uout]):
    def __init__(self, op: Operator, next_engine: AsyncEngine):
        self._op = op
        self._next = next_engine

    async def generate(self, request: SingleIn[Tin]) -> ManyOut[Uout]:
        return await self._op.generate(request, self._next)


class ServiceFrontend(AsyncEngine[Tin, Uout]):
    """Head node of a linked pipeline; also the no-op identity engine wrapper.

    Reference ``ServiceFrontend`` (lib/runtime/src/pipeline/nodes/sources.rs):
    its job there is to hold the graph's entry edge; here it simply delegates,
    existing so graphs have a stable, nameable head.
    """

    def __init__(self, inner: AsyncEngine[Tin, Uout], name: str = "frontend"):
        self._inner = inner
        self.name = name

    async def generate(self, request: SingleIn[Tin]) -> ManyOut[Uout]:
        return await self._inner.generate(request)


def link(*stages) -> AsyncEngine:
    """Compose operators and a terminal engine into one engine.

    ``link(opA, opB, engine)`` ≡ reference graph
    ``Frontend → opA → opB → Backend(engine) → opB' → opA' → Frontend``
    (the backward half is implicit: each operator transforms the returned
    stream before handing it upstream).
    """
    if not stages:
        raise ValueError("link() needs at least a terminal engine")
    tail = stages[-1]
    if isinstance(tail, Operator):
        raise TypeError("last link() stage must be an AsyncEngine, not an Operator")
    engine: AsyncEngine = tail
    for stage in reversed(stages[:-1]):
        if not isinstance(stage, Operator):
            raise TypeError(f"intermediate link() stage {stage!r} must be an Operator")
        engine = stage.attach(engine)
    return ServiceFrontend(engine)
