"""The int8 LM head: ``x @ q * scale`` with f32 logits.

Counterpart of ``dynamo_tpu.engine.lm_head``. ``lm_head_int8`` dispatches
on the tensor's device alone: a CPU tensor takes the plain version
(``lm_head_int8_ref``), a CUDA tensor launches the hand-written kernel
``csrc/lm_head_int8.cu`` or raises. The JAX package's ``kernel_selftest``
and the fallback it guards are not ported: no fallback hides the kernel.
"""

from __future__ import annotations

import torch


def lm_head_int8_ref(x: torch.Tensor, q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(x.float() @ q.float()) * scale``, f32."""
    return (x.float() @ q.float()) * scale.float().reshape(-1)


def lm_head_int8(x: torch.Tensor, q: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """``x [B, D] (or [D]) @ q [D, V] int8 * scale → f32 [B, V] (or [V])``;
    ``scale`` is per output column, shaped ``[V]``, ``[1, V]`` or
    ``[V, 1]``. Any V."""
    if not x.is_cuda:
        return lm_head_int8_ref(x, q, scale)
    from .kernels import lm_head_int8_cuda
    squeeze = x.dim() == 1
    out = lm_head_int8_cuda(x[None] if squeeze else x, q, scale.reshape(-1))
    return out[0] if squeeze else out
