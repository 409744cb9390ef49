"""Grouped-int4 matmul: x @ W for packed-int4 weights.

Counterpart of ``dynamo_tpu.engine.quant_matmul``. ``grouped_int4_matmul``
dispatches on the tensor's device alone: a CPU tensor takes the plain
version (``grouped_int4_matmul_ref``), a CUDA tensor launches the
hand-written kernel ``csrc/grouped_int4_matmul.cu`` or raises. Whether a
weight goes through it at all is decided before any launch, from shapes
only (``grouped_kernel_eligible``, the JAX package's rule).
"""

from __future__ import annotations

import torch

GROUP = 128          # contraction rows per scale group


def grouped_kernel_eligible(d: int, f: int, group: int) -> bool:
    """The JAX package's shape rule for the grouped kernel: the group-128
    encoding, an even group count and a 128-aligned output width. Every
    layer matmul of the Llama-3-8B geometry passes it; a whole-axis group
    (D % 128 != 0) does not."""
    return (group == GROUP and d % GROUP == 0 and f % 128 == 0
            and (d // GROUP) % 2 == 0)


def grouped_int4_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                            scale: torch.Tensor) -> torch.Tensor:
    """Plain version: unpack, one f32 partial product per 128-row group,
    each scaled by its ``scale[g, :]`` and summed in f32; the result in
    x's dtype (the Pallas kernel's semantics). x ``[N, D]``, packed
    ``[D/2, F]`` int8, scale ``[D/128, F]`` f32 → ``[N, F]``."""
    from .quant import unpack_int4_rows
    N, D = x.shape
    F = packed.shape[1]
    gn = D // GROUP
    w = unpack_int4_rows(packed).float().reshape(gn, GROUP, F)
    xg = x.float().reshape(N, gn, GROUP).transpose(0, 1)        # [gn, N, 128]
    part = torch.bmm(xg, w)                                      # [gn, N, F]
    return (part * scale.float()[:, None, :]).sum(0).to(x.dtype)


def grouped_int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """x ``[N, D]`` @ packed-int4 W (``quant.pack_int4_rows`` layout:
    byte d of a column holds rows 2d and 2d+1), ``scale [D/128, F]`` f32 →
    ``[N, F]`` in x's dtype."""
    if not x.is_cuda:
        return grouped_int4_matmul_ref(x, packed, scale)
    from .kernels import grouped_int4_matmul_cuda
    return grouped_int4_matmul_cuda(x, packed, scale)
