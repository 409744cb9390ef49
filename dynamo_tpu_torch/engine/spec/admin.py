"""The live draft budget's KV-store key and value.

Counterpart of ``dynamo_tpu.engine.spec.admin``: ``llmctl spec set-k``
writes ``spec/config/{namespace}`` and a worker that watches it moves its
``EngineCore.spec_k_live`` within [0, EngineConfig.spec_k]. The port has no
distributed runtime yet, so nothing here watches the key (ROADMAP A7);
the value and the key's layout are the JAX package's."""

from __future__ import annotations

import dataclasses
import json

SPEC_PREFIX = "spec/"


def spec_config_key(namespace: str) -> str:
    return f"{SPEC_PREFIX}config/{namespace}"


@dataclasses.dataclass
class SpecConfig:
    """The stored live speculation config of one namespace."""

    k: int = 0

    def to_json(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "SpecConfig":
        d = json.loads(raw)
        return cls(k=int(d.get("k", 0)))
