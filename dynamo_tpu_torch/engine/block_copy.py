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
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

KVCache = Dict[str, torch.Tensor]

__all__ = ["gather_blocks", "scatter_blocks", "move_blocks", "wire_kv_heads",
           "to_rows", "from_rows",
           "rows_as_wire", "wire_as_rows", "gather_rows", "scatter_rows",
           "gather_blocks_to_host", "scatter_blocks_from_host", "Transfer",
           "start_d2h", "start_h2d", "scatter_transfer"]


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
    return {k: rows_as_wire(v).cpu() for k, v in
            gather_rows(kv, block_ids, block_size, num_heads).items()}


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
