"""Disaggregation protocols: remote-prefill requests and the KV handoff
wire format.

Counterpart of ``dynamo_tpu.llm.protocols.disagg`` (the reference's vLLM
``RemotePrefillRequest`` and its NATS prefill queue). The prefill worker
dials the decode worker's TCP stream server (the response plane every
request already uses, ``runtime/tcp.py``) and streams the gathered block
values in JAX's head-major wire format; the decode side scatters them into
its paged pool. The bytes on the wire equal the JAX package's in both
directions: a JSON header naming the request, the first token, the block
hashes, the per-key shape and the numpy dtype name (``"bfloat16"``,
``"int8"``, ``"float32"``), then each key's bytes in sorted key order.
Values are torch tensors on the CPU: bf16 goes through a torch view of its
raw bytes, with no ``ml_dtypes``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import torch

from ..kv.diskstore import _DTYPES, dtype_name

__all__ = ["RemotePrefillRequest", "PrefillPublishRequest", "KvPayload",
           "KV_CHUNK_BYTES", "encode_kv_payload", "decode_kv_payload",
           "tensor_bytes", "tensor_from_bytes", "torch_dtype"]

# One KV handoff can be GBs for long prompts; split it across frames so no
# single frame approaches the codec's MAX_FRAME bound (runtime/codec.py).
# The first frame carries the metadata header; the rest are continuation
# chunks, and the stream's SENTINEL marks completion.
KV_CHUNK_BYTES = 64 * 1024 * 1024


@dataclasses.dataclass
class RemotePrefillRequest:
    """One unit of work on the prefill queue (the JAX package's fields)."""

    request_id: str
    token_ids: List[int]
    sampling: Dict                 # SlotSampling fields
    connection_info: Dict          # decode worker's KV-sink stream (addr+id)
    engine_id: str = ""            # decode worker identity (diagnostics)
    prefix_hit_tokens: int = 0     # decode-side estimate (router metric)
    # decode process's kv_transport.PROC_TOKEN: a prefill worker in the
    # SAME process takes the device-to-device plane and sends only a
    # control frame over TCP; others stream the wire payload
    device_bridge: str = ""
    # the decode side's trace context; carried and ignored here (request
    # tracing is not ported)
    trace: Optional[Dict] = None
    # end-to-end deadline: the REMAINING budget in ms at enqueue time; the
    # prefill worker re-anchors it to its own clock and drops the job
    # unstarted when it is already gone
    deadline_ms: Optional[float] = None
    # the decode side consumes per-layer frames on the wire plane
    # (llm/kv/stream.py)
    layer_stream: bool = False

    def to_json(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "RemotePrefillRequest":
        return cls(**json.loads(raw))


@dataclasses.dataclass
class PrefillPublishRequest:
    """One unit of work on the prefill-PUBLISH queue of prefill-as-a-service
    (``components/prefill_service.py``); ``trace`` is carried and ignored
    (request tracing waits for ROADMAP A10)."""

    request_id: str
    token_ids: List[int]
    sampling: Dict = dataclasses.field(default_factory=dict)
    trace: Optional[Dict] = None

    def to_json(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "PrefillPublishRequest":
        return cls(**json.loads(raw))


@dataclasses.dataclass
class KvPayload:
    """Decoded KV handoff: first sampled token + stacked block values."""

    request_id: str
    first_token: int
    first_logprob: float
    seq_hashes: List[int]          # chained hashes of the FULL blocks
    values: Dict[str, torch.Tensor]  # {"k": [L, H_kv, n, bs, D], "v": ...}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy dtype name as the wire carries it."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported KV wire dtype {name!r}") from None


def tensor_bytes(t: torch.Tensor) -> bytes:
    """A CPU tensor's bytes in C order (bf16 through a uint8 view)."""
    t = t.detach().cpu().contiguous()
    return t.view(torch.uint8).numpy().tobytes() if t.numel() else b""


def tensor_from_bytes(data, dtype: torch.dtype, shape) -> torch.Tensor:
    """A CPU tensor of ``shape`` over a copy of ``data``'s bytes."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    nbytes = n * torch.empty((), dtype=dtype).element_size()
    if len(data) != nbytes:
        raise ValueError(f"KV payload of {len(data)} bytes, expected "
                         f"{nbytes} for {shape} {dtype}")
    if not nbytes:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).view(
        dtype).reshape(shape)


def encode_kv_payload(payload: KvPayload) -> tuple:
    """→ (header bytes, data bytes) for one TCP DATA frame. The header
    names the pool's key set (sorted), so llama {"k","v"} and MLA latent
    {"kv"} pools share one wire format; all keys share one shape/dtype."""
    keys = sorted(payload.values)
    first = payload.values[keys[0]]
    header = json.dumps({
        "request_id": payload.request_id,
        "first_token": payload.first_token,
        "first_logprob": payload.first_logprob,
        "seq_hashes": payload.seq_hashes,
        "shape": list(first.shape),
        "dtype": dtype_name(first.dtype),
        "keys": keys,
    }).encode()
    return header, b"".join(tensor_bytes(payload.values[k]) for k in keys)


def decode_kv_payload(header: bytes, data: bytes) -> KvPayload:
    h = json.loads(header)
    shape = tuple(h["shape"])
    dt = torch_dtype(h["dtype"])
    keys = h.get("keys", ["k", "v"])   # absent: pre-"keys" wire frames
    n = 1
    for s in shape:
        n *= int(s)
    nbytes = n * torch.empty((), dtype=dt).element_size()
    if len(data) != nbytes * len(keys):
        raise ValueError(f"KV payload of {len(data)} bytes, expected "
                         f"{nbytes * len(keys)}")
    values = {key: tensor_from_bytes(data[i * nbytes:(i + 1) * nbytes], dt,
                                     shape)
              for i, key in enumerate(keys)}
    return KvPayload(
        request_id=h["request_id"], first_token=int(h["first_token"]),
        first_logprob=float(h["first_logprob"]),
        seq_hashes=[int(x) for x in h["seq_hashes"]],
        values=values)
