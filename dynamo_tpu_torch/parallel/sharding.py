"""The device mesh of the PyTorch engine.

Counterpart of ``dynamo_tpu.parallel.sharding`` for the one axis the port
implements, ``sp``: sequence-parallel (ring-attention) prefill of long
prompts. JAX's mesh is a single-controller grid of devices with named axes;
the port's is the same idea in one process: ``Mesh.shape`` maps each axis
to its size (``mesh.shape["sp"]``, as the JAX engine reads it) and
``Mesh.devices`` lists the sp axis's devices in ring order. A tensor
sharded over sp is a Python list of per-device shards
(``parallel.ring_attention``).

One placement that JAX's mesh lacks: a mesh may name one device more than
once, so an sp ring runs on one card (``devices=["cuda:0"] * sp``), or on
the CPU in the tests (``["cpu"] * sp``). Each shard still runs its own
hops and merges and computes the same function; what one card cannot show
is the transfer between cards and the O(T/sp) memory per card.

Not ported: tp, dp and ep, with ``param_pspecs``, ``shard_params`` and
``shard_kv`` (ROADMAP A9). Under sp the JAX engine replicates the
parameters and the KV pool over the axis; the port keeps the pool on the
engine's device and one copy of the weights on each distinct device of
the mesh (``replicate_params``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..engine.device import resolve_device
from ..engine.quant import QuantizedTensor


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes (dp, tp, sp, ep, as in the JAX mesh) and the sp axis's
    devices."""

    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]

    @property
    def distinct_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices))


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, ep: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``sp`` devices (after ``dynamo_tpu.parallel.sharding.
    make_mesh``). ``devices=None`` takes the first ``sp`` CUDA cards and
    raises with fewer, as the JAX function raises with fewer devices; an
    explicit list (device names or ``torch.device``s) may repeat a device.
    Only sp may exceed 1."""
    for name, n in (("dp", dp), ("tp", tp), ("ep", ep)):
        if n > 1:
            raise NotImplementedError(
                f"{name}={n}: the PyTorch engine implements only the sp "
                f"axis of the mesh (tp, dp and ep: ROADMAP A9)")
    if sp < 1:
        raise ValueError(f"sp must be >= 1, got {sp}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if sp > have:
            raise ValueError(f"mesh dp*tp*sp*ep={sp} > {have} CUDA devices "
                             f"(pass devices= to name them, repeats allowed)")
        devices = [torch.device("cuda", i) for i in range(sp)]
    elif sp > len(devices):
        raise ValueError(f"mesh dp*tp*sp*ep={sp} > {len(devices)} devices")
    return Mesh(shape={"dp": 1, "tp": 1, "sp": sp, "ep": 1},
                devices=tuple(_device(d) for d in devices[:sp]))


def _to(leaf, dev: torch.device):
    if isinstance(leaf, QuantizedTensor):
        return QuantizedTensor(leaf.q.to(dev), leaf.scale.to(dev), leaf.group,
                               leaf.packed4)
    return leaf.to(dev)


def replicate_params(params: Dict[str, object],
                     devices: Sequence[torch.device]
                     ) -> Dict[torch.device, Dict[str, object]]:
    """The weights on each distinct device of ``devices``: ``params``
    itself on its own device, one copy on every other."""
    home = params["final_norm"].device
    return {d: params if d == home else {k: _to(v, d) for k, v in
                                          params.items()}
            for d in dict.fromkeys(devices)}
