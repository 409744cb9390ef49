"""The runtime: the async-engine abstraction and pipeline linking (copies
of ``dynamo_tpu.runtime.engine`` / ``.pipeline``), and the distributed
runtime (naming, discovery, leases, the bus request plane and the TCP
response plane; ``distributed``, imported lazily)."""

from .engine import (AsyncEngine, Context, EngineContext, EngineFn, ManyOut,
                     ResponseStream, SingleIn, engine_from_fn)
from .pipeline import Operator, ServiceFrontend, link

__all__ = [
    "AsyncEngine", "Context", "EngineContext", "EngineFn", "ManyOut",
    "ResponseStream", "SingleIn", "engine_from_fn",
    "Operator", "ServiceFrontend", "link",
    # distributed layer (imported lazily by most callers)
    "DistributedRuntime", "Namespace", "Component", "Endpoint", "Client",
]


def __getattr__(name):  # lazy: keep `import dynamo_tpu_torch.runtime` light
    if name in ("DistributedRuntime", "Namespace", "Component", "Endpoint",
                "EndpointServer", "Client", "json_serde"):
        from . import distributed
        return getattr(distributed, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
