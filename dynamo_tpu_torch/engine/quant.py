"""Weight-only int8/int4 quantization for the PyTorch engine.

Counterpart of ``dynamo_tpu.engine.quant``, with the same encodings so a
tree quantized by either package holds the same bytes:

- int8: symmetric absmax, one f32 scale per output channel (per (layer,
  out-channel) for the stacked ``[L, D, F]`` layer matmuls, per column for
  the ``[D, V]`` lm head, per ROW for the ``[V, D]`` embedding, so the
  token gather dequantizes with one scale per token).
- int4 (the dense layer matmuls only): one f32 scale per (layer, group of
  128 contraction rows, out-channel); two signed nibbles per int8 byte,
  the low nibble holding contraction row 2d and the high nibble row 2d+1
  (``pack_int4_rows``). The lm head stays int8 and the embedding int8 (or
  in the load dtype under ``-noembed``).

``mm`` is the one matmul every model projection goes through. An int8
weight is cast to the activation dtype and its scale applied after the
product, in the activation dtype, as in the JAX package. A packed int4
weight of a shape the grouped kernel takes (``grouped_kernel_eligible``,
decided from shapes before any launch) goes through
``quant_matmul.grouped_int4_matmul`` (the hand-written kernel for CUDA
tensors, its plain version for CPU tensors); any other grouped weight
takes the plain grouped contraction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .config import ModelConfig
from .device import resolve_device
from .quant_matmul import GROUP, grouped_int4_matmul, grouped_kernel_eligible

# stacked per-layer matmul weights [L, D, F] that are quantized
LAYER_MATMULS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


@dataclasses.dataclass
class QuantizedTensor:
    """int8/int4 payload + f32 scale; dequantizes as q * scale.

    ``group == 0``: ``scale`` broadcasts against ``q`` (per-channel int8).
    ``group > 0``: the logical q is ``[..., D, F]`` with one scale per
    (contraction group, out-channel), ``scale [..., D/group, F]``.
    ``packed4``: ``q`` holds two signed nibbles per byte, ``[..., D/2, F]``
    (``pack_int4_rows``)."""

    q: torch.Tensor
    scale: torch.Tensor
    group: int = 0
    packed4: bool = False

    @property
    def shape(self):
        """The logical (unpacked) shape."""
        s = tuple(self.q.shape)
        if self.packed4:
            return s[:-2] + (s[-2] * 2, s[-1])
        return s

    def __getitem__(self, idx) -> "QuantizedTensor":
        """Leading-axis (layer) indexing: q and every scale layout share
        their leading dims."""
        return QuantizedTensor(self.q[idx], self.scale[idx], self.group,
                               self.packed4)

    def unpacked(self) -> "QuantizedTensor":
        if not self.packed4:
            return self
        return QuantizedTensor(unpack_int4_rows(self.q), self.scale,
                               self.group)

    def dequantize(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        w = self.unpacked()
        s = (torch.repeat_interleave(w.scale, w.group, dim=-2) if w.group
             else w.scale)
        out = w.q.to(w.scale.dtype) * s
        return out.to(dtype) if dtype is not None else out


def quantize_array(w: torch.Tensor, *, keep_axes=(-1,)) -> QuantizedTensor:
    """Symmetric absmax int8, one scale per coordinate of ``keep_axes``
    (reduced over every other axis; the scale keeps its broadcast shape).
    Rounds half to even, as ``jnp.round``."""
    w32 = w.float()
    keep = {a % w.dim() for a in keep_axes}
    reduce_axes = tuple(a for a in range(w.dim()) if a not in keep)
    absmax = torch.amax(w32.abs(), dim=reduce_axes, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale)


def pack_int4_rows(q: torch.Tensor) -> torch.Tensor:
    """int4-valued int8 ``[..., D, F]`` (D even) → packed int8
    ``[..., D/2, F]``: rows 2d and 2d+1 become the low and high nibble of
    byte d."""
    lo = q[..., 0::2, :].to(torch.int16) & 0xF
    hi = (q[..., 1::2, :].to(torch.int16) & 0xF) << 4
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_int4_rows(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_rows`: packed int8 ``[..., D/2, F]`` →
    signed int4 values held in int8, ``[..., D, F]``."""
    v = packed.to(torch.int16)
    lo = ((v & 0xF) ^ 8) - 8             # sign-extend the low nibble
    hi = v >> 4                          # arithmetic: the signed high nibble
    un = torch.stack([lo, hi], dim=-2)   # [..., D/2, 2, F]
    s = packed.shape
    return un.reshape(s[:-2] + (s[-2] * 2, s[-1])).to(torch.int8)


def quantize_array_grouped(w: torch.Tensor, group: int = GROUP,
                           bits: int = 4) -> QuantizedTensor:
    """Symmetric absmax with one scale per (leading axes, contraction
    group, out-channel): w ``[..., D, F]`` → q ``[..., D, F]``, scale
    ``[..., D/group, F]`` f32. When ``group`` does not divide D the whole
    axis is one group. bits=4 with even D returns packed storage; odd D
    stays unpacked, int8-held."""
    *_lead, D, F = w.shape
    if D % group != 0:
        group = D
    gn = D // group
    qmax = 2 ** (bits - 1) - 1
    w32 = w.float().reshape(tuple(w.shape[:-2]) + (gn, group, F))
    absmax = torch.amax(w32.abs(), dim=-2)                 # [..., gn, F]
    scale = torch.clamp(absmax, min=1e-12) / qmax
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -qmax, qmax)
    q = q.reshape(w.shape).to(torch.int8)
    if bits == 4 and D % 2 == 0:
        return QuantizedTensor(pack_int4_rows(q), scale, group=group,
                               packed4=True)
    return QuantizedTensor(q, scale, group=group)


def _mm_grouped(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """x ``[..., D]`` @ grouped-quantized w ``[D, F]``."""
    D, F = w.shape[-2:]
    if w.packed4 and grouped_kernel_eligible(D, F, w.group):
        x2 = x[None] if x.dim() == 1 else x
        y = grouped_int4_matmul(x2, w.q, w.scale)
        return y[0] if x.dim() == 1 else y
    # the JAX package's XLA form: per-group partials in x's dtype, then
    # the [gn, F] scales in a second contraction
    w = w.unpacked()
    gn = D // w.group
    xg = x.reshape(tuple(x.shape[:-1]) + (gn, w.group))
    qg = w.q.to(x.dtype).reshape(gn, w.group, F)
    part = torch.einsum("...gd,gdf->...gf", xg, qg)
    return torch.einsum("...gf,gf->...f", part, w.scale.to(x.dtype))


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain tensor or a :class:`QuantizedTensor`."""
    if isinstance(w, QuantizedTensor):
        if w.group:
            return _mm_grouped(x, w)
        y = x @ w.q.to(x.dtype)
        return y * w.scale.to(x.dtype).reshape(w.scale.shape[-1])
    return x @ w


def quantize_named(name: str, w: torch.Tensor, include_embed: bool,
                   tied: bool, bits: int = 8) -> Dict[str, object]:
    """One tensor of the parameter tree, quantized as the JAX package's
    ``_quantize_named`` does (dense families: no MoE or MLA names)."""
    suffix = name.split(".", 1)[1] if name.startswith("layers.") else name
    if name.startswith("layers.") and suffix in LAYER_MATMULS:
        if bits == 4:
            return {name: quantize_array_grouped(w, bits=4)}
        return {name: quantize_array(w, keep_axes=(0, -1))}
    if name == "lm_head":               # int8 under int4 too
        return {name: quantize_array(w, keep_axes=(-1,))}
    if name == "embed" and include_embed:
        out = {name: quantize_array(w, keep_axes=(0,))}
        if tied:
            # a pre-transposed int8 head [D, V], so the head reads its
            # bytes in natural orientation (per-column scales); laid out
            # row-major, as the head kernel reads it
            out["lm_head"] = quantize_array(w.t().contiguous(),
                                            keep_axes=(-1,))
        return out
    return {name: w}


def tree_quantization(params: Dict[str, object]) -> str:
    """The weight quantization a tree already holds, as the
    ``EngineConfig.quantization`` name that makes it ("none" for a tree in
    its load dtype)."""
    wo = params.get("layers.wo")
    if not isinstance(wo, QuantizedTensor):
        return "none"
    bits = "int4" if wo.group else "int8"
    return bits if isinstance(params.get("embed"), QuantizedTensor) \
        else f"{bits}-noembed"


def quantize_params(params: Dict[str, torch.Tensor],
                    include_embed: bool = True,
                    bits: int = 8) -> Dict[str, object]:
    """A parameter tree with its matmul weights quantized (see the module
    docstring for the encodings). Norms and biases are left as they are."""
    tied = "lm_head" not in params
    out: Dict[str, object] = {}
    for name, w in params.items():
        out.update(quantize_named(name, w, include_embed, tied, bits))
    return out


def init_params_quantized(cfg: ModelConfig, seed: int, device="cuda",
                          dtype: torch.dtype = torch.bfloat16,
                          include_embed: bool = True,
                          bits: int = 8) -> Dict[str, object]:
    """Random weights quantized one tensor at a time, equal to
    ``quantize_params(weights.init_params(cfg, seed, ...))``: the tensors
    are drawn from the same ``torch.Generator`` sequence as ``init_params``
    and each is quantized (a stacked layer matmul slice by slice) before
    the next is drawn, so the whole tree in ``dtype`` (16 GB for the 8B
    geometry) never exists."""
    from .models.llama import param_shapes
    from .weights import init_one_param
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shapes = param_shapes(cfg)
    tied = "lm_head" not in shapes
    out: Dict[str, object] = {}
    for name, shape in shapes.items():
        w = init_one_param(cfg, name, shape, gen, dev, dtype)
        if name.startswith("layers.") and name[7:] in LAYER_MATMULS:
            # both encodings scale per layer, so slice-by-slice
            # quantization stacks into the whole-tensor result
            parts = [quantize_array_grouped(s, bits=4) if bits == 4
                     else quantize_array(s, keep_axes=(-1,)) for s in w]
            out[name] = QuantizedTensor(
                torch.stack([p.q for p in parts]),
                torch.stack([p.scale for p in parts]), parts[0].group,
                parts[0].packed4)
        else:
            out.update(quantize_named(name, w, include_embed, tied, bits))
        del w
    return out
