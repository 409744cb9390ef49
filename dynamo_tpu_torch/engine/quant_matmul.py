"""Grouped-int4 matmul: x @ W for packed-int4 weights.

Counterpart of ``dynamo_tpu.engine.quant_matmul``. ``grouped_int4_matmul``
dispatches on the tensor's device alone: a CPU tensor takes the plain
version (``grouped_int4_matmul_ref``), a CUDA tensor launches the
hand-written kernel ``csrc/grouped_int4_matmul.cu`` or raises. Whether a
weight goes through it at all is decided before any launch, from shapes
only (``grouped_kernel_eligible``, the JAX package's rule).

Where its grid alone would leave SMs idle the kernel splits the
contraction across CTAs by ``int4_split_plan`` and sums the splits' f32
partials in index order; ``grouped_int4_matmul_split_ref`` is that
arithmetic in plain PyTorch, for the tests.
"""

from __future__ import annotations

from typing import Tuple

import torch

GROUP = 128          # contraction rows per scale group
STRIP = 128          # output columns per CTA of the kernel
DECODE_ROWS = 16     # the largest N of the kernel's decode tiling
PREFILL_ROWS = 128   # x rows per CTA of its prefill tiling
SMS = 132            # streaming multiprocessors of an H100
# decode CTAs per SM the split aims at: shared memory lets four share an SM,
# but more splits measured no faster (PERF.md, Findings)
DECODE_CTAS_PER_SM = 2


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


def int4_split_plan(n: int, d: int, f: int,
                    sms: int = SMS) -> Tuple[int, int]:
    """(splits, groups per split) of the kernel for x [n, d] @ W [d, f]:
    the d/128 groups cut into ``splits`` ranges of ``groups per split``
    (the last may be shorter, none is empty). The decode tiling (n <=
    DECODE_ROWS, f/128 CTAs) splits until its CTAs reach about
    DECODE_CTAS_PER_SM per SM; the prefill tiling ((f/128) x ceil(n/128)
    CTAs, one per SM at a time) splits only where those fill fewer than
    half the ``sms`` SMs, then to about two per SM."""
    groups = d // GROUP
    tiles = f // STRIP
    if n <= DECODE_ROWS:
        target = DECODE_CTAS_PER_SM * sms
    else:
        tiles *= -(-n // PREFILL_ROWS)
        if 2 * tiles >= sms:
            return 1, groups
        target = 2 * sms
    want = min(groups, -(-target // tiles))
    per = -(-groups // want)
    return -(-groups // per), per


def grouped_int4_split_partials_ref(x: torch.Tensor, packed: torch.Tensor,
                                    scale: torch.Tensor,
                                    plan: Tuple[int, int]) -> torch.Tensor:
    """The kernel's split partials in plain PyTorch: for each split of
    ``plan`` (``int4_split_plan``), the f32 sum in group order of its
    groups' partial products, each scaled by ``scale[g, :]``. →
    ``[splits, N, F]`` f32, the kernel's scratch layout."""
    from .quant import unpack_int4_rows
    splits, per = plan
    N, D = x.shape
    F = packed.shape[1]
    gn = D // GROUP
    w = unpack_int4_rows(packed).float().reshape(gn, GROUP, F)
    xg = x.float().reshape(N, gn, GROUP).transpose(0, 1)        # [gn, N, 128]
    part = torch.bmm(xg, w) * scale.float()[:, None, :]          # [gn, N, F]
    out = torch.zeros((splits, N, F), dtype=torch.float32, device=x.device)
    for s in range(splits):
        for g in range(s * per, min((s + 1) * per, gn)):
            out[s] += part[g]
    return out


def merge_int4_split_partials(partials: torch.Tensor,
                              dtype: torch.dtype) -> torch.Tensor:
    """The kernel's reduction: ``[splits, N, F]`` f32 partials summed in
    split order (f32), → ``[N, F]`` in ``dtype``."""
    acc = torch.zeros_like(partials[0])
    for p in partials:
        acc = acc + p
    return acc.to(dtype)


def grouped_int4_matmul_split_ref(x: torch.Tensor, packed: torch.Tensor,
                                  scale: torch.Tensor,
                                  plan: Tuple[int, int]) -> torch.Tensor:
    """``grouped_int4_matmul_ref`` in the kernel's split form: per-split
    f32 partials by ``plan``, then the fixed-order reduction."""
    return merge_int4_split_partials(
        grouped_int4_split_partials_ref(x, packed, scale, plan), x.dtype)


def grouped_int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """x ``[N, D]`` @ packed-int4 W (``quant.pack_int4_rows`` layout:
    byte d of a column holds rows 2d and 2d+1), ``scale [D/128, F]`` f32 →
    ``[N, F]`` in x's dtype."""
    if not x.is_cuda:
        return grouped_int4_matmul_ref(x, packed, scale)
    from .kernels import grouped_int4_matmul_cuda
    return grouped_int4_matmul_cuda(x, packed, scale)
