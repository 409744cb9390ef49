"""Streaming layer-wise KV handoff plane.

Counterpart of ``dynamo_tpu.llm.kv.stream`` (FlowKV, PAPERS.md), with the
same frames byte for byte. The monolithic wire handoff ships the whole
prompt's KV in one chunked payload after the prefill side's gather, so the
device→host copy, the transfer and the decode side's scatter sit serially
on TTFT. This module pipelines that tail per layer:

- **producer** (``PrefillWorker``): the prefill engine's gather is wrapped
  as a :class:`LayeredHarvest`, per-layer host fetches off the one
  dispatched gather. :func:`send_layer_stream` announces the geometry with
  a :class:`LayerStreamManifest` frame, then one DATA frame per layer on
  the dial-back stream the monolithic handoff uses. Layer ``l+1``'s
  device→host copy overlaps layer ``l``'s send.
- **consumer** (``DisaggEngine`` → ``EngineCore``): frames land in a
  :class:`LayerStreamPayload`; the decode engine admits the request at
  once (slot reserved, not decode-visible) and scatters each layer into
  the paged pool as it arrives (``EngineCore._stream_onboard``), recorded
  per layer as the ``kv_layer_stream`` event. The request becomes
  decode-ready when the last layer has landed.
- **fallback ladder** (never an error):
  1. a torn mid-stream layer frame degrades to the monolithic payload ON
     THE SAME STREAM, and the consumer fills every remaining layer from
     it. A sender tears a frame by raising :class:`TornFrame` from its
     ``send`` (the JAX package's ``disagg.layer_stream`` failpoint; the
     port has no failpoint registry, so a test wraps the sender);
  2. a dead stream, a short frame or a dead peer fails the payload: the
     decode engine releases the half-onboarded blocks and re-admits COLD;
  3. no stream at all (an old peer, the device plane) is the monolithic
     handoff, unchanged.

Pricing: :func:`exposed_transfer_s` is the overlap cost model the router's
``scoring.modeled_overlap_transfer_s`` uses.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
from typing import Callable, Dict, List, Optional

import torch

from ..protocols.disagg import (KV_CHUNK_BYTES, KvPayload, encode_kv_payload,
                                tensor_bytes, tensor_from_bytes, torch_dtype)
from .diskstore import dtype_name

logger = logging.getLogger("dynamo_tpu_torch.llm.kv.stream")

__all__ = ["LayerStreamManifest", "LayeredHarvest", "LayerStreamPayload",
           "MANIFEST_KIND", "LAYER_KIND", "TornFrame", "send_layer_stream",
           "send_monolithic_payload", "encode_layer_frame",
           "decode_layer_frame", "exposed_transfer_s"]

# header "stream" discriminators: a consumer that sees neither treats the
# frame as the monolithic KV payload (protocols/disagg.py)
MANIFEST_KIND = "kv_layer_manifest"
LAYER_KIND = "kv_layer"


class TornFrame(Exception):
    """Raised by a sender's ``send`` for a layer frame that tore before it
    was written: the producer degrades to the monolithic payload."""


@dataclasses.dataclass
class LayerStreamManifest:
    """First frame of a layer stream: the first token, the block hashes and
    the per-layer array geometry. Wire dataclass: evolve append-only with
    defaulted fields."""

    request_id: str
    first_token: int
    first_logprob: float
    seq_hashes: List[int]          # chained hashes of the FULL blocks
    num_layers: int
    shape: List[int]               # per-layer wire shape [H, n, bs, D]
    dtype: str                     # numpy dtype name ("bfloat16", "int8")
    keys: List[str]                # sorted pool key set ({"k","v"}/{"kv"})

    def to_header(self) -> bytes:
        d = dataclasses.asdict(self)
        d["stream"] = MANIFEST_KIND
        return json.dumps(d).encode()

    @classmethod
    def from_header(cls, h: dict) -> "LayerStreamManifest":
        return cls(request_id=h["request_id"],
                   first_token=int(h["first_token"]),
                   first_logprob=float(h["first_logprob"]),
                   seq_hashes=[int(x) for x in h["seq_hashes"]],
                   num_layers=int(h["num_layers"]),
                   shape=[int(x) for x in h["shape"]],
                   dtype=str(h["dtype"]), keys=list(h["keys"]))


@dataclasses.dataclass
class LayeredHarvest:
    """Prefill-side handle over ONE dispatched device gather: per-layer host
    fetches and the whole-stack fetch the fallback rung needs (both run
    off the loop: they wait for device→host copies)."""

    num_layers: int
    fetch_layer: Callable[[int], Dict[str, torch.Tensor]]  # {"k": [H,n,bs,D]}
    fetch_all: Callable[[], Dict[str, torch.Tensor]]       # {"k": [L,H,n,bs,D]}


def encode_layer_frame(layer: int, values: Dict[str, torch.Tensor],
                       keys: List[str]) -> tuple:
    """→ (header, data) for one per-layer DATA frame: the monolithic
    payload's per-key concatenation restricted to one layer."""
    header = json.dumps({"stream": LAYER_KIND, "layer": layer}).encode()
    return header, b"".join(tensor_bytes(values[k]) for k in keys)


def decode_layer_frame(manifest: LayerStreamManifest,
                       data: bytes) -> Dict[str, torch.Tensor]:
    """One layer's bytes → {key: [H, n, bs, D]}. A short or long payload
    raises ValueError (the consumer's cold-recompute rung, never a
    silently corrupt scatter)."""
    shape = tuple(manifest.shape)
    dt = torch_dtype(manifest.dtype)
    n = 1
    for s in shape:
        n *= s
    nbytes = n * torch.empty((), dtype=dt).element_size()
    if len(data) != nbytes * len(manifest.keys):
        raise ValueError(
            f"short layer frame: {len(data)} bytes, expected "
            f"{nbytes * len(manifest.keys)}")
    return {key: tensor_from_bytes(data[i * nbytes:(i + 1) * nbytes], dt,
                                   shape)
            for i, key in enumerate(manifest.keys)}


class LayerStreamPayload:
    """Consumer-side assembler: the decode engine admits against this when
    the manifest lands; per-layer values fill in as frames arrive. It has
    a ``KvPayload``'s admission fields (request_id, first_token,
    first_logprob, seq_hashes); the progressive onboard awaits
    :meth:`wait_layer` instead of reading ``values``."""

    def __init__(self, manifest: LayerStreamManifest):
        self.manifest = manifest
        self.request_id = manifest.request_id
        self.first_token = manifest.first_token
        self.first_logprob = manifest.first_logprob
        self.seq_hashes = list(manifest.seq_hashes)
        self.num_layers = manifest.num_layers
        self._layers: Dict[int, Dict[str, torch.Tensor]] = {}
        self._event = asyncio.Event()
        self._error: Optional[str] = None
        self.fallback_monolithic = False   # filled from a monolithic tail

    @property
    def complete(self) -> bool:
        return len(self._layers) >= self.num_layers

    @property
    def failed(self) -> bool:
        return self._error is not None

    def put_layer(self, layer: int, vals: Dict[str, torch.Tensor]) -> None:
        if not (0 <= layer < self.num_layers):
            raise ValueError(f"layer {layer} outside [0, {self.num_layers})")
        self._layers[layer] = vals
        self._event.set()

    def put_all(self, values: Dict[str, torch.Tensor]) -> None:
        """Monolithic-fallback fill: a whole-stack payload arrived on the
        stream (the producer hit a torn frame); every layer not yet
        delivered is sliced out of it."""
        self.fallback_monolithic = True
        for l in range(self.num_layers):
            if l not in self._layers:
                self._layers[l] = {k: v[l] for k, v in values.items()}
        self._event.set()

    def fail(self, msg: str) -> None:
        if self._error is None:
            self._error = msg
        self._event.set()

    def finish(self) -> None:
        """Stream ended: an incomplete payload is a failure (rung 2)."""
        if not self.complete:
            self.fail(f"layer stream ended at {len(self._layers)}/"
                      f"{self.num_layers} layers")

    async def wait_layer(self, layer: int) -> Dict[str, torch.Tensor]:
        """Block until ``layer`` is available (or the stream failed)."""
        while True:
            if self._error is not None:
                raise RuntimeError(
                    f"kv layer stream failed: {self._error}")
            if layer in self._layers:
                return self._layers[layer]
            self._event.clear()
            await self._event.wait()


async def send_monolithic_payload(sender, payload: KvPayload) -> int:
    """The whole-stack payload as chunked DATA frames (the monolithic wire
    handoff, kept as the shared fallback rung). Does NOT finish the stream:
    the caller owns the SENTINEL. Returns the bytes sent."""
    header, data = await asyncio.to_thread(encode_kv_payload, payload)
    await sender.send(data[:KV_CHUNK_BYTES], header=header)
    for off in range(KV_CHUNK_BYTES, len(data), KV_CHUNK_BYTES):
        await sender.send(data[off:off + KV_CHUNK_BYTES])
    return len(data)


async def send_layer_stream(sender, request_id: str, first_token: int,
                            first_logprob: float, seq_hashes: List[int],
                            harvest: LayeredHarvest) -> dict:
    """The producer: the manifest frame, then one DATA frame per layer,
    layer ``l+1``'s device→host fetch running behind layer ``l``'s send. A
    torn frame (:class:`TornFrame` from the sender) degrades to the
    monolithic payload on the same stream; the consumer never sees an
    error. Returns {"layers": streamed, "fallback": bool, "bytes": n}."""
    first = await asyncio.to_thread(harvest.fetch_layer, 0)
    keys = sorted(first)
    sample = first[keys[0]]
    manifest = LayerStreamManifest(
        request_id=request_id, first_token=first_token,
        first_logprob=first_logprob, seq_hashes=list(seq_hashes),
        num_layers=harvest.num_layers, shape=list(sample.shape),
        dtype=dtype_name(sample.dtype), keys=keys)
    await sender.send(b"", header=manifest.to_header())

    streamed = sent = 0
    vals: Optional[Dict[str, torch.Tensor]] = first
    prefetch: Optional[asyncio.Task] = None
    try:
        for layer in range(harvest.num_layers):
            if vals is None:
                vals = await prefetch
                prefetch = None
            if layer + 1 < harvest.num_layers:
                prefetch = asyncio.get_running_loop().create_task(
                    asyncio.to_thread(harvest.fetch_layer, layer + 1))
            header, data = encode_layer_frame(layer, vals, keys)
            try:
                await sender.send(data, header=header)
            except TornFrame:
                # rung 1: the frame tore mid-stream — the monolithic
                # payload on this same stream (the consumer fills every
                # remaining layer from it)
                logger.warning(
                    "layer stream for %s torn at layer %d/%d — "
                    "degrading to the monolithic handoff", request_id,
                    layer, harvest.num_layers)
                if prefetch is not None:
                    prefetch.cancel()
                    prefetch = None
                values = await asyncio.to_thread(harvest.fetch_all)
                sent += await send_monolithic_payload(sender, KvPayload(
                    request_id=request_id, first_token=first_token,
                    first_logprob=first_logprob,
                    seq_hashes=list(seq_hashes), values=values))
                await sender.finish()
                return {"layers": streamed, "fallback": True, "bytes": sent}
            streamed += 1
            sent += len(data)
            vals = None
        await sender.finish()
        return {"layers": streamed, "fallback": False, "bytes": sent}
    finally:
        if prefetch is not None:
            prefetch.cancel()


def exposed_transfer_s(transfer_s: float, n_layers: int,
                       hidden_s: float = 0.0) -> float:
    """Critical-path cost of a transfer of serial duration ``transfer_s``
    streamed as ``n_layers`` frames with ``hidden_s`` seconds of
    overlappable compute behind it.

    - The consumer can't act before the FIRST frame lands: at least
      ``transfer_s / n_layers`` is always exposed.
    - Compute hides at most ``hidden_s`` of the rest:
      ``transfer_s - hidden_s`` stays exposed when compute runs short.

    Monolithic transfers are the ``n_layers <= 1, hidden_s = 0`` case:
    exposed == transfer_s exactly."""
    if transfer_s <= 0.0:
        return 0.0
    n = max(int(n_layers), 1)
    return max(transfer_s / n, transfer_s - max(hidden_s, 0.0))
