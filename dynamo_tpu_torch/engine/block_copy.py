"""Paged-KV block copies: gather, scatter, move, and the device↔host legs
of the KV tiers.

Counterpart of ``dynamo_tpu.engine.block_copy``. In JAX a block copy is an
XLA take or a donated update; here it is PyTorch indexing, and every write
into the pool is IN PLACE (``index_copy_`` into the ``[L, nb, bs, C]`` view
of the pool tensor): the decode, ragged and verify programs hold the pool
tensors' addresses in their CUDA graphs, so a tier copy or a defrag move
that rebound a pool tensor would leave every graph reading a dead buffer.
No id list is padded (JAX pads to a power of two for XLA's compile cache).

Device pool layout (``models.*.init_kv_cache``) is block-major: ``{"k":
[L, num_blocks * bs, C], "v": ...}`` (one ``"kv"`` entry for an MLA latent
pool); block b is token rows ``[b * bs, (b + 1) * bs)``. The wire format of
stacked blocks is JAX's head-major ``[L, H, n, bs, D]``: a full-precision
llama pool uses its real KV heads, an int8 pool or an MLA latent pool is
one opaque "head" of whole rows (scale and rope lanes included), so a round
trip is bit-exact (``wire_kv_heads``). The host tier and the disk tier keep
each block's wire rows ``[L, H, bs, D]``; stacked on a LEADING block axis
they are the "rows" layout ``[n, L, H, bs, D]``, whose blocks are
contiguous, so the host side only ever copies contiguous bytes: the
head-major transpose runs on the card, after the gather and before the
device→host copy, and after the host→device copy and before the scatter.

On the card the host legs are asynchronous: ``start_d2h`` gathers on the
compute stream (so the read is ordered before any later graph replay that
could overwrite a block whose hold is then released) and copies into
pinned memory on a side stream behind an event; ``start_h2d`` copies pinned
rows to the card on a side stream behind an event, and ``scatter_transfer``
makes the compute stream wait for it before the in-place scatter. Each
returned ``Transfer`` keeps its buffers alive until its event has
completed. On the CPU every leg is a plain synchronous copy.

The disaggregated handoff's legs (``llm/disagg.py``): the prefill engine
dispatches one gather of the prompt's blocks (``gather_blocks_dispatch``,
on the compute stream, an event recorded behind it), and a thread fetches
it to the host in the wire format, whole (``fetch_wire``) or one layer at
a time (``fetch_wire_layer``): the head-major transpose runs on the card
on a side stream after the event, then a copy into pinned memory. The
decode side copies each arriving layer to the card on a side stream
(``start_h2d``) and scatters it in place on the compute stream after that
copy's event (``scatter_layer_transfer``); ``scatter_layer_from_host`` is
the synchronous form (the replayer's).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

KVCache = Dict[str, torch.Tensor]

__all__ = ["gather_blocks", "scatter_blocks", "move_blocks", "wire_kv_heads",
           "to_rows", "from_rows",
           "rows_as_wire", "wire_as_rows", "gather_rows", "scatter_rows",
           "gather_blocks_to_host", "scatter_blocks_from_host", "Transfer",
           "start_d2h", "start_h2d", "scatter_transfer",
           "gather_blocks_dispatch", "fetch_wire", "fetch_wire_layer",
           "prep_layer_values", "scatter_layer_prepped", "slice_local_lanes",
           "scatter_layer_from_host", "scatter_layer_transfer"]


def _paged(arr: torch.Tensor, block_size: int) -> torch.Tensor:
    """The ``[L, nb, bs, C]`` view of a pool tensor (shares its storage)."""
    L, T, C = arr.shape
    return arr.view(L, T // block_size, block_size, C)


def _ids(block_ids, device) -> torch.Tensor:
    return torch.as_tensor(list(block_ids), dtype=torch.long, device=device)


def gather_blocks(kv: KVCache, block_ids, block_size: int) -> KVCache:
    """Stack ``n`` blocks out of the paged pool -> ``{"k": [L, n, bs, C]}``
    (block-major, the pool's lane packing; a fresh tensor per key)."""
    out = {}
    for k, arr in kv.items():
        out[k] = _paged(arr, block_size).index_select(
            1, _ids(block_ids, arr.device))
    return out


def scatter_blocks(kv: KVCache, block_ids, values: KVCache,
                   block_size: int) -> None:
    """Write stacked block values (``[L, n, bs, C]``, on the pool's device)
    into blocks ``block_ids`` of the pool, in place."""
    for k, arr in kv.items():
        _paged(arr, block_size).index_copy_(
            1, _ids(block_ids, arr.device), values[k].to(arr.dtype))


def move_blocks(kv: KVCache, src_ids, dst_ids, block_size: int) -> None:
    """Block migration src → dst inside the same pool (the defrag pass):
    every source is gathered before any target is written, so overlapping
    id lists are safe; the pool tensors are written in place."""
    if len(src_ids) != len(dst_ids):
        raise ValueError(f"move_blocks: {len(src_ids)} sources, "
                         f"{len(dst_ids)} targets")
    if not len(src_ids):
        return
    scatter_blocks(kv, dst_ids, gather_blocks(kv, src_ids, block_size),
                   block_size)


def wire_kv_heads(model_cfg, kv_quantization: str) -> int:
    """Head count of the wire format: an int8 pool or an MLA latent pool
    ships whole rows as ONE opaque head (in-row scales and latent / rope
    lanes have no head structure to split), a full-precision llama pool
    its real KV heads (JAX's ``EngineCore.wire_kv_heads``)."""
    return (1 if kv_quantization != "none" or model_cfg.kv_lora_rank > 0
            else model_cfg.num_kv_heads)


def to_rows(picked: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``[L, n, bs, H*D]`` (block-major) -> rows ``[n, L, H, bs, D]``
    (each block's wire rows contiguous)."""
    L, n, bs, HD = picked.shape
    return picked.reshape(L, n, bs, num_heads, HD // num_heads).permute(
        1, 0, 3, 2, 4).contiguous()


def from_rows(rows: torch.Tensor) -> torch.Tensor:
    """rows ``[n, L, H, bs, D]`` -> ``[L, n, bs, H*D]`` (block-major)."""
    n, L, H, bs, d = rows.shape
    return rows.permute(1, 0, 3, 2, 4).reshape(L, n, bs, H * d)


def rows_as_wire(rows: torch.Tensor) -> torch.Tensor:
    """rows ``[n, L, H, bs, D]`` viewed as wire ``[L, H, n, bs, D]``."""
    return rows.permute(1, 2, 0, 3, 4)


def wire_as_rows(wire: torch.Tensor) -> torch.Tensor:
    """wire ``[L, H, n, bs, D]`` viewed as rows ``[n, L, H, bs, D]``."""
    return wire.permute(2, 0, 1, 3, 4)


def gather_rows(kv: KVCache, block_ids, block_size: int,
                num_heads: int) -> KVCache:
    """Gather blocks and transpose them to rows on the pool's device."""
    return {k: to_rows(v, num_heads)
            for k, v in gather_blocks(kv, block_ids, block_size).items()}


def scatter_rows(kv: KVCache, block_ids, rows: KVCache,
                 block_size: int) -> None:
    """Write rows (``[n, L, H, bs, D]`` on the pool's device) into blocks
    ``block_ids``, in place."""
    scatter_blocks(kv, block_ids, {k: from_rows(v) for k, v in rows.items()},
                   block_size)


def gather_blocks_to_host(kv: KVCache, block_ids, block_size: int,
                          num_heads: int) -> KVCache:
    """Device -> host, synchronously: wire ``{"k": [L, H, n, bs, D]}`` on
    the CPU (the replayer's and the tests' form)."""
    return fetch_wire(gather_blocks_dispatch(kv, block_ids, block_size),
                      len(block_ids), num_heads)


def scatter_blocks_from_host(kv: KVCache, block_ids, host_values: KVCache,
                             block_size: int) -> None:
    """Host -> device, synchronously: wire values into blocks
    ``block_ids`` of the pool, in place."""
    dev = next(iter(kv.values())).device
    scatter_rows(kv, block_ids, {k: wire_as_rows(v.to(dev))
                                 for k, v in host_values.items()},
                 block_size)


class Transfer:
    """One asynchronous tier copy: ``values`` (rows by key) on its
    destination, ``event`` recorded behind the copy (None on the CPU,
    where the copy has already run), ``start`` recorded before it, and the
    tensors the copy reads (``keep``), held until the event has
    completed."""

    def __init__(self, values: KVCache, event=None, keep=None,
                 start=None) -> None:
        self.values = values
        self.event = event
        self.start = start
        self._keep = keep

    @property
    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.values.values())

    def copy_s(self) -> Optional[float]:
        """The copy's own seconds on the card, once it has run (None on
        the CPU)."""
        if self.start is None:
            return None
        return self.start.elapsed_time(self.event) / 1e3

    def wait(self) -> KVCache:
        """Block until the copy has run; the destination values."""
        if self.event is not None:
            self.event.synchronize()
        self._keep = None
        return self.values


def start_d2h(kv: KVCache, block_ids, block_size: int, num_heads: int,
              stream=None, out: Optional[KVCache] = None) -> Transfer:
    """The write-back's device leg: gather ``block_ids`` and transpose them
    to rows on the compute stream (the current one), then, on ``stream``
    after it, copy the rows into pinned host memory (``out`` where given)
    behind an event. On the CPU: the rows themselves."""
    rows = gather_rows(kv, block_ids, block_size, num_heads)
    sample = next(iter(rows.values()))
    if not sample.is_cuda:
        return Transfer(rows)
    compute = torch.cuda.current_stream(sample.device)
    stream = stream or compute
    stream.wait_stream(compute)
    with torch.cuda.stream(stream):
        host = out if out is not None else {
            k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            for k, v in rows.items()}
        start, event = _timed_events(stream)
        for k, v in rows.items():
            host[k].copy_(v, non_blocking=True)
        event.record(stream)
    return Transfer(host, event, keep=rows, start=start)


def _timed_events(stream) -> tuple:
    """(start recorded on ``stream`` now, end to record after the copy),
    both timing events."""
    start = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    return start, torch.cuda.Event(enable_timing=True)


def start_h2d(rows: KVCache, device, stream=None) -> Transfer:
    """The onboard's host leg: copy host rows (pinned on the card) to
    ``device`` on ``stream`` behind an event; the source rows stay alive
    until it has completed. On the CPU: the rows themselves."""
    device = torch.device(device)
    if device.type != "cuda":
        return Transfer({k: v.to(device) for k, v in rows.items()})
    with torch.cuda.device(device):
        stream = stream or torch.cuda.current_stream(device)
        with torch.cuda.stream(stream):
            start, event = _timed_events(stream)
            dev = {k: v.to(device, non_blocking=True)
                   for k, v in rows.items()}
            event.record(stream)
    return Transfer(dev, event, keep=rows, start=start)


def scatter_transfer(kv: KVCache, block_ids: Sequence[int], h2d: Transfer,
                     block_size: int) -> None:
    """Scatter an h2d ``Transfer``'s rows into ``block_ids`` on the compute
    stream, after the copy's event (the stream waits on the device, the
    host does not)."""
    sample = next(iter(kv.values()))
    if sample.is_cuda:
        compute = torch.cuda.current_stream(sample.device)
        compute.wait_event(h2d.event)
        for v in h2d.values.values():
            # allocated on the copy's stream, read on this one: the
            # allocator keeps it until the scatter has run
            v.record_stream(compute)
    scatter_rows(kv, block_ids, h2d.values, block_size)


class Gather(dict):
    """A dispatched gather: block-major ``{"k": [L, n, bs, C]}`` on the
    pool's device, and on the card the event recorded behind it on the
    stream that ran it (``ready``; None on the CPU)."""

    ready = None


def gather_blocks_dispatch(kv: KVCache, block_ids,
                           block_size: int) -> Gather:
    """Dispatch (but do not fetch) the gather of ``block_ids``: on the card
    it is enqueued on the current (compute) stream, so it reads the pool
    before any later graph replay writes it, and a fetch on another
    stream waits for its ``ready`` event. Nothing is padded (JAX pads the
    count to a power of two for XLA's compile cache)."""
    out = Gather(gather_blocks(kv, block_ids, block_size))
    sample = next(iter(out.values()))
    if sample.is_cuda:
        out.ready = torch.cuda.Event()
        out.ready.record(torch.cuda.current_stream(sample.device))
    return out


def _wire_heads(v: torch.Tensor, num_heads: int) -> int:
    """The wire head count of a gathered key: an int8 pool's rows are one
    opaque head (``wire_kv_heads``)."""
    return 1 if v.dtype == torch.int8 else num_heads


def _fetch(stacked: Gather, make, stream=None) -> KVCache:
    """``make(key, tensor)`` of each gathered key, on the host: on the card
    computed on ``stream`` (the current one by default) after the gather's
    event, copied into pinned memory there and waited for (the caller is
    a thread off the engine loop); on the CPU computed in place."""
    sample = next(iter(stacked.values()))
    if not sample.is_cuda:
        return {k: make(k, v).contiguous() for k, v in stacked.items()}
    stream = stream or torch.cuda.current_stream(sample.device)
    with torch.cuda.device(sample.device), torch.cuda.stream(stream):
        if stacked.ready is not None:
            stream.wait_event(stacked.ready)
        out = {}
        for k, v in stacked.items():
            v.record_stream(stream)
            dev = make(k, v).contiguous()
            host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            host.copy_(dev, non_blocking=True)
            out[k] = host
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return out


def fetch_wire(stacked: Gather, n: int, num_heads: int,
               stream=None) -> KVCache:
    """A dispatched gather's first ``n`` blocks on the host in wire format
    ``{"k": [L, H, n, bs, D]}`` (an int8 pool's rows as one head)."""
    def make(_k, v):
        L, _n, bs, C = v.shape
        h = _wire_heads(v, num_heads)
        return v[:, :n].reshape(L, n, bs, h, C // h).permute(0, 3, 1, 2, 4)
    return _fetch(stacked, make, stream)


def fetch_wire_layer(stacked: Gather, n: int, num_heads: int, layer: int,
                     stream=None) -> KVCache:
    """ONE layer of a dispatched gather on the host, per-layer wire format
    ``{"k": [H, n, bs, D]}``: only that layer crosses to the host, so layer
    ``l+1``'s copy overlaps layer ``l``'s send. Stacked over the layer
    axis, the layers equal ``fetch_wire``'s bytes."""
    def make(_k, v):
        _L, _n, bs, C = v.shape
        h = _wire_heads(v, num_heads)
        return v[layer, :n].reshape(n, bs, h, C // h).permute(2, 0, 1, 3)
    return _fetch(stacked, make, stream)


def prep_layer_values(block_ids, layer_values: KVCache) -> tuple:
    """Per-layer wire ``{"k": [H, n, bs, D]}`` → (ids, block-major
    ``{"k": [n, bs, H*D]}``) on the values' device (a transpose on the
    card after the host→device copy, or on the CPU)."""
    ids = list(block_ids)
    out = {}
    for k, v in layer_values.items():
        H, nb, bs, d = v.shape
        out[k] = v.permute(1, 2, 0, 3).reshape(nb, bs, H * d)
    return ids, out


def scatter_layer_prepped(kv: KVCache, layer: int, ids, vals: KVCache,
                          block_size: int) -> None:
    """Write one layer's block-major values (``[n, bs, C]``, on the pool's
    device) into blocks ``ids`` of layer ``layer``, in place."""
    for k, arr in kv.items():
        _paged(arr, block_size)[layer].index_copy_(
            0, _ids(ids, arr.device), vals[k].to(arr.dtype))


def slice_local_lanes(kv: KVCache, host_values: KVCache) -> KVCache:
    """This process's lane shard of global-head wire values: the identity
    (the port has no tensor-parallel pool yet, ROADMAP A9)."""
    return host_values


def scatter_layer_from_host(kv: KVCache, block_ids, layer: int,
                            layer_values: KVCache, block_size: int) -> None:
    """Host → device for ONE layer, synchronously: per-layer wire values
    into blocks ``block_ids`` of layer ``layer``, in place (the replayer's
    form of the ``kv_layer_stream`` event)."""
    dev = next(iter(kv.values())).device
    ids, vals = prep_layer_values(
        block_ids, {k: v.to(dev) for k, v in
                    slice_local_lanes(kv, layer_values).items()})
    scatter_layer_prepped(kv, layer, ids, vals, block_size)


def scatter_layer_transfer(kv: KVCache, block_ids, layer: int, h2d: Transfer,
                           block_size: int) -> None:
    """Scatter an h2d ``Transfer``'s per-layer wire values into blocks
    ``block_ids`` of layer ``layer`` on the compute stream, after the
    copy's event: the transpose to block-major and the in-place write."""
    sample = next(iter(kv.values()))
    if sample.is_cuda:
        compute = torch.cuda.current_stream(sample.device)
        compute.wait_event(h2d.event)
        for v in h2d.values.values():
            v.record_stream(compute)
    ids, vals = prep_layer_values(block_ids, h2d.values)
    scatter_layer_prepped(kv, layer, ids, vals, block_size)
