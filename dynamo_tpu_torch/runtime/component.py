"""Component model: Namespace → Component → Endpoint naming + discovery
(a copy of ``dynamo_tpu.runtime.component``).

Reference: lib/runtime/src/component.rs + component/{namespace,endpoint}.rs.
The serving side lives in runtime/ingress.py, the calling
side in runtime/egress.py, the per-process runtime in
runtime/distributed.py; this module is pure naming + the discovery
record + serde plumbing.
"""

from __future__ import annotations

import dataclasses
import json
from typing import TYPE_CHECKING, Any, Callable, Optional

from .engine import AsyncEngine

if TYPE_CHECKING:   # avoid the cycle: distributed imports this module
    from .distributed import DistributedRuntime

__all__ = ["Namespace", "Component", "Endpoint", "ComponentEndpointInfo",
           "json_serde"]


def _default_encode(obj: Any) -> bytes:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    elif hasattr(obj, "to_dict"):
        obj = obj.to_dict()
    return json.dumps(obj).encode()


def json_serde(cls: Optional[type] = None):
    """(encode, decode) pair: dataclass/dict → JSON bytes and back.
    ``cls`` may define ``from_dict`` or be a dataclass for typed decode."""

    def decode(raw: bytes) -> Any:
        d = json.loads(raw)
        if cls is None:
            return d
        if hasattr(cls, "from_dict"):
            return cls.from_dict(d)
        if dataclasses.is_dataclass(cls):
            return cls(**d)
        return d

    return _default_encode, decode


@dataclasses.dataclass
class ComponentEndpointInfo:
    """Discovery record one serving endpoint writes.
    Reference: ``ComponentEndpointInfo`` (component.rs:90-97).

    ``draining``: the planner's decommission flag (docs/planner.md). A
    draining instance stays discoverable — in-flight streams keep their
    dial-back path — but routers must stop admitting new requests to it."""

    subject: str
    worker_id: int
    component: str
    endpoint: str
    namespace: str
    draining: bool = False

    def to_json(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "ComponentEndpointInfo":
        d = json.loads(raw)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass
class Namespace:
    runtime: "DistributedRuntime"
    name: str

    def component(self, name: str) -> "Component":
        return Component(self.runtime, self.name, name)

    # -- event plane (reference traits/events.rs: namespace-scoped pub/sub)
    def event_subject(self, topic: str) -> str:
        return f"evt.{self.name}.{topic}"

    async def publish_event(self, topic: str, payload: Any) -> None:
        await self.runtime.bus.publish(self.event_subject(topic),
                                       _default_encode(payload))

    async def subscribe_event(self, topic: str):
        return await self.runtime.bus.subscribe(self.event_subject(topic))


@dataclasses.dataclass
class Component:
    runtime: "DistributedRuntime"
    namespace: str
    name: str

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self.runtime, self.namespace, self.name, name)

    def event_subject(self, topic: str) -> str:
        return f"evt.{self.namespace}.{self.name}.{topic}"

    async def publish_event(self, topic: str, payload: Any) -> None:
        await self.runtime.bus.publish(self.event_subject(topic),
                                       _default_encode(payload))

    async def subscribe_event(self, topic: str):
        return await self.runtime.bus.subscribe(self.event_subject(topic))


@dataclasses.dataclass
class Endpoint:
    runtime: "DistributedRuntime"
    namespace: str
    component: str
    name: str

    def parent_component(self) -> Component:
        return Component(self.runtime, self.namespace, self.component)

    # naming (reference component.rs:246-257 / component/endpoint.rs:110-137)
    def discovery_prefix(self) -> str:
        return f"{self.namespace}/components/{self.component}/{self.name}:"

    def discovery_key(self, lease_id: int) -> str:
        return f"{self.discovery_prefix()}{lease_id:x}"

    def subject(self, lease_id: int) -> str:
        return f"{self.namespace}|{self.component}.{self.name}-{lease_id:x}"

    def stats_key(self, lease_id: int) -> str:
        return (f"{self.namespace}/stats/{self.component}/"
                f"{self.name}:{lease_id:x}")

    def drain_prefix(self) -> str:
        """Drain-request keys: the planner writes
        ``{ns}/drain/{comp}/{ep}:{lease:x}`` and the serving endpoint —
        which owns its discovery entry — answers by re-announcing itself
        with ``draining=true`` (docs/planner.md drain protocol)."""
        return f"{self.namespace}/drain/{self.component}/{self.name}:"

    def drain_key(self, lease_id: int) -> str:
        return f"{self.drain_prefix()}{lease_id:x}"

    @property
    def path(self) -> str:
        return f"dyn://{self.namespace}/{self.component}/{self.name}"

    def __post_init__(self) -> None:
        # structure characters (| . - : /) in names would corrupt subjects
        # and discovery keys (reference slug.rs; component.rs:323-339 TODO)
        from .slug import validate_name
        validate_name(self.namespace, "namespace")
        validate_name(self.component, "component")
        validate_name(self.name, "endpoint")

    @classmethod
    def parse_path(cls, runtime: "DistributedRuntime",
                   path: str) -> "Endpoint":
        """Parse ``dyn://ns/comp/ep`` or ``ns.comp.ep`` (reference
        protocols.rs:33-200)."""
        p = path
        if p.startswith("dyn://"):
            p = p[len("dyn://"):]
        parts = p.replace(".", "/").split("/")
        if len(parts) != 3 or not all(parts):
            raise ValueError(f"invalid endpoint path: {path!r}")
        return cls(runtime, *parts)

    async def serve(self, engine: AsyncEngine,
                    decode_req: Optional[Callable[[bytes], Any]] = None,
                    encode_resp: Optional[Callable[[Any], bytes]] = None,
                    stats_handler: Optional[Callable[[], Any]] = None,
                    stats_interval: float = 1.0):
        """Register + start serving. Returns the running server handle."""
        from .ingress import EndpointServer
        server = EndpointServer(self, engine,
                                decode_req or json_serde()[1],
                                encode_resp or _default_encode,
                                stats_handler, stats_interval)
        await server.start()
        self.runtime._servers.append(server)
        return server

    def client(self, decode_resp: Optional[Callable[[bytes], Any]] = None,
               encode_req: Optional[Callable[[Any], bytes]] = None):
        from .egress import Client
        return Client(self, encode_req or _default_encode,
                      decode_resp or json_serde()[1])
