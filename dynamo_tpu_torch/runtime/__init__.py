"""In-process runtime: the async-engine abstraction and pipeline linking
(copies of ``dynamo_tpu.runtime.engine`` / ``.pipeline``; the distributed
runtime is not ported)."""

from .engine import (AsyncEngine, Context, EngineContext, EngineFn, ManyOut,
                     ResponseStream, SingleIn, engine_from_fn)
from .pipeline import Operator, ServiceFrontend, link

__all__ = [
    "AsyncEngine", "Context", "EngineContext", "EngineFn", "ManyOut",
    "ResponseStream", "SingleIn", "engine_from_fn",
    "Operator", "ServiceFrontend", "link",
]
