"""Parameters of the PyTorch models (llama, MLA): conversion and random
init.

``params_from_numpy`` takes the JAX package's parameter tree (names from
``param_shapes``, ``[in, out]`` matmul layout, layer weights stacked
``[L, ...]``, quantized leaves as their fields) as numpy arrays, so a test
can run both packages on the same weights. ``init_params`` makes random
weights from a seed directly on the device, one matrix slice at a time
(a layer's, or one expert's of a layer), so the f32 staging buffer stays
one slice large (the 8B geometry's bf16 tree alone is ~16 GB,
DeepSeek-V2-Lite's ~31 GB). The names and shapes are the model family's
``param_shapes`` (``models.family``).

``load_params_auto`` loads an HF-style model directory's ``*.safetensors``
(read by ``safetensors_file``, the standard library's stand-in for the
``safetensors`` package) for every family the port serves: each stacked
tensor is preallocated on the device in the engine dtype, and each
checkpoint tensor goes through one pinned host buffer to the device, is
transposed there (HF ``[out, in]`` to ``[in, out]``) and lands in its
layer's slice, so host staging is one checkpoint tensor. Under
``quantization`` each layer matmul slice, the embedding and the head are
quantized as they land, in column (or row) chunks whose scales are exact,
equal bit for bit to ``quant.quantize_params`` of the bf16 load; the tree
in the engine dtype never exists. ``save_hf_style`` writes a tree back
out under the HF names, one tensor at a time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import math
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import ModelConfig
from .device import resolve_device
from .models import family
from .quant import (LAYER_MATMULS, QuantizedTensor, quantize_array,
                    quantize_array_grouped)
from .quant_matmul import GROUP
from .safetensors_file import SafetensorsFile, TensorInfo, write_file

_NORMS = ("ln1", "ln2", "ln1_post", "ln2_post", "q_norm", "k_norm",
          "kv_norm", "q_a_norm")
_BIASES = ("bq", "bk", "bv", "router_bias")


def params_from_numpy(np_params: Mapping[str, object], cfg: ModelConfig,
                      device="cuda",
                      dtype: torch.dtype = torch.bfloat16
                      ) -> Dict[str, object]:
    """JAX-layout numpy tree → tensors on ``device`` in ``dtype``. Every
    name of ``param_shapes(cfg)`` must be present with its shape (and a
    tied tree quantized with its embedding also carries ``lm_head``). A
    quantized leaf is a mapping ``{"q", "scale", "group", "packed4"}`` of
    the JAX package's ``QuantizedArray`` fields; it becomes a
    ``quant.QuantizedTensor`` with its int8 payload and f32 scale kept as
    they are."""
    dev = resolve_device(device)
    shapes = dict(family(cfg).param_shapes(cfg))
    if "lm_head" in np_params and "lm_head" not in shapes:
        shapes["lm_head"] = (cfg.hidden_size, cfg.vocab_size)
    out = {}
    for name, shape in shapes.items():
        if name not in np_params:
            raise KeyError(f"parameter {name!r} missing")
        leaf = np_params[name]
        if isinstance(leaf, Mapping):
            t = QuantizedTensor(
                torch.from_numpy(np.array(leaf["q"], dtype=np.int8)).to(dev),
                torch.from_numpy(np.array(leaf["scale"],
                                          dtype=np.float32)).to(dev),
                int(leaf["group"]), bool(leaf["packed4"]))
        else:
            arr = np.array(leaf, dtype=np.float32)   # owned copy
            t = torch.from_numpy(arr).to(device=dev, dtype=dtype)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"parameter {name!r}: shape {tuple(t.shape)} "
                             f"!= {shape}")
        out[name] = t
    return out


def init_one_param(cfg: ModelConfig, name: str, shape, gen: torch.Generator,
                   dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """One tensor of ``init_params``, drawn from ``gen`` one matrix at a
    time (the last two axes of a stacked weight, in index order)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _NORMS or name == "final_norm":
        fill = 0.0 if cfg.norm_plus_one else 1.0
        return torch.full(shape, fill, dtype=dtype, device=dev)
    if leaf in _BIASES:
        return torch.zeros(shape, dtype=dtype, device=dev)
    fan_in = shape[-2] if len(shape) > 1 else shape[-1]
    t = torch.empty(shape, dtype=dtype, device=dev)
    slices = (t.reshape((-1,) + tuple(shape[-2:])) if len(shape) > 1
              else t[None])
    for s in slices:
        s.copy_(torch.randn(s.shape, generator=gen, device=dev,
                            dtype=torch.float32) * fan_in ** -0.5)
    return t


def init_params(cfg: ModelConfig, seed: int, device="cuda",
                dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """Random weights with the JAX package's init rule (norms 1, or 0 for
    plus-one norms; biases 0; matmuls N(0, 1/fan_in)), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {name: init_one_param(cfg, name, shape, gen, dev, dtype)
            for name, shape in family(cfg).param_shapes(cfg).items()}


# ---------------------------------------------------------------------------
# HF checkpoints (the JAX package's engine/weights.py, names kept)
# ---------------------------------------------------------------------------

_LAYER_MAP = {
    "input_layernorm.weight": ("ln1", False),
    "post_attention_layernorm.weight": ("ln2", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "mlp.gate_proj.weight": ("gate", True),
    "mlp.up_proj.weight": ("up", True),
    "mlp.down_proj.weight": ("down", True),
    # qwen2-style attention biases
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    # qwen3-style per-head q/k norms
    "self_attn.q_norm.weight": ("q_norm", False),
    "self_attn.k_norm.weight": ("k_norm", False),
    # mixtral MoE router
    "block_sparse_moe.gate.weight": ("router", True),
    # qwen3-moe / qwen2-moe / deepseek router
    "mlp.gate.weight": ("router", True),
    # qwen2_moe shared expert (dense swiglu + sigmoid gate)
    "mlp.shared_expert.gate_proj.weight": ("sh_gate", True),
    "mlp.shared_expert.up_proj.weight": ("sh_up", True),
    "mlp.shared_expert.down_proj.weight": ("sh_down", True),
    "mlp.shared_expert_gate.weight": ("sh_router", True),
    # deepseek shared experts (plural naming; additive, ungated)
    "mlp.shared_experts.gate_proj.weight": ("sh_gate", True),
    "mlp.shared_experts.up_proj.weight": ("sh_up", True),
    "mlp.shared_experts.down_proj.weight": ("sh_down", True),
    # deepseek MLA attention (models/mla.py)
    "self_attn.q_a_proj.weight": ("wq_a", True),
    "self_attn.q_a_layernorm.weight": ("q_a_norm", False),
    "self_attn.q_b_proj.weight": ("wq_b", True),
    "self_attn.kv_a_proj_with_mqa.weight": ("wkv_a", True),
    "self_attn.kv_a_layernorm.weight": ("kv_norm", False),
    "self_attn.kv_b_proj.weight": ("wkv_b", True),
}

# expert sub-weights: mixtral w1=gate, w3=up, w2=down; qwen-moe / deepseek
# {gate,up,down}_proj (all torch [out, in])
_EXPERT_MAP = {"w1": "moe_gate", "w3": "moe_up", "w2": "moe_down",
               "gate_proj": "moe_gate", "up_proj": "moe_up",
               "down_proj": "moe_down"}

# per-family expert tensor prefixes under model.layers.{i}.
_EXPERT_PREFIXES = ("block_sparse_moe.experts.", "mlp.experts.")

_SINGLES = {"model.embed_tokens.weight": ("embed", False),
            "model.norm.weight": ("final_norm", False),
            "lm_head.weight": ("lm_head", True)}

# elements of one quantize-on-load chunk (16 MB in f32), so that the
# quantizer's f32 temporaries stay small beside the checkpoint tensor
_QUANT_CHUNK = 1 << 22


def _layer_map_for(cfg: ModelConfig) -> Dict[str, tuple]:
    """HF layer-tensor suffix → (stacked key, transpose) for this
    family."""
    layer_map = dict(_LAYER_MAP)
    if cfg.post_norms:
        # gemma2: "post_attention_layernorm" is a true post-attn norm (not
        # llama's pre-MLP norm) and the MLP has its own pre/post pair;
        # the norms are stored raw (the model adds the one)
        layer_map["post_attention_layernorm.weight"] = ("ln1_post", False)
        layer_map["pre_feedforward_layernorm.weight"] = ("ln2", False)
        layer_map["post_feedforward_layernorm.weight"] = ("ln2_post", False)
    if (cfg.model_type in ("deepseek_v2", "deepseek_v3")
            and cfg.num_experts > 0):
        # hybrid sparsity: mlp.*_proj exists only on the dense-prefix
        # layers and lands in the dense_* stacks (_partial_ranges)
        layer_map["mlp.gate_proj.weight"] = ("dense_gate", True)
        layer_map["mlp.up_proj.weight"] = ("dense_up", True)
        layer_map["mlp.down_proj.weight"] = ("dense_down", True)
    if cfg.moe_routing == "sigmoid_noaux":
        # deepseek_v3 router bias buffer (persistent, so in every
        # checkpoint's state dict)
        layer_map["mlp.gate.e_score_correction_bias"] = (
            "router_bias", False)
    if cfg.model_type == "phi3":
        # phi3 ships fused projections (_fused_sections); the split
        # suffixes must not also match
        for k in ("self_attn.q_proj.weight", "self_attn.k_proj.weight",
                  "self_attn.v_proj.weight", "mlp.gate_proj.weight",
                  "mlp.up_proj.weight"):
            layer_map.pop(k, None)
    return layer_map


def _fused_sections(cfg: ModelConfig) -> Dict[str, list]:
    """Fused HF layer tensors → the row sections (torch [out, in]
    orientation) that map onto the split keys: phi3 packs q/k/v into
    ``qkv_proj`` and gate/up into ``gate_up_proj``. Returns {suffix:
    [(key, row_offset, row_count)]}."""
    if cfg.model_type != "phi3":
        return {}
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    return {
        "self_attn.qkv_proj.weight": [
            ("wq", 0, qd), ("wk", qd, kvd), ("wv", qd + kvd, kvd)],
        "mlp.gate_up_proj.weight": [
            ("gate", 0, cfg.intermediate_size),
            ("up", cfg.intermediate_size, cfg.intermediate_size)],
    }


def _partial_ranges(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    """Stacked keys that cover only a layer range (deepseek hybrid
    sparsity): key -> (lo, hi) global layer bounds. Empty for uniform
    families."""
    if (cfg.model_type not in ("deepseek_v2", "deepseek_v3")
            or cfg.num_experts == 0):
        return {}
    k, L = cfg.first_k_dense, cfg.num_layers
    out = {key: (0, k) for key in ("dense_gate", "dense_up",
                                   "dense_down")}
    for key in ("router", "router_bias", "moe_gate", "moe_up",
                "moe_down", "sh_gate", "sh_up", "sh_down"):
        out[key] = (k, L)
    return out


class LoadAccounting:
    """Host bytes of checkpoint loads: ``peak`` the most staging bytes
    alive at once (the loader's one pinned buffer, sized to the largest
    tensor it reads), ``total`` the bytes read through it, and
    ``largest_tensor`` the largest checkpoint tensor read."""

    def __init__(self) -> None:
        self.live = 0
        self.peak = 0
        self.total = 0
        self.largest_tensor = 0

    def stage(self, nbytes: int) -> None:
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def unstage(self, nbytes: int) -> None:
        self.live -= nbytes

    def read(self, nbytes: int) -> None:
        self.total += nbytes
        self.largest_tensor = max(self.largest_tensor, nbytes)


_ACCOUNTING: Optional[LoadAccounting] = None


@contextlib.contextmanager
def load_accounting():
    """``with load_accounting() as acct: load(...)``: afterwards
    ``acct.peak`` / ``acct.total`` / ``acct.largest_tensor`` hold the byte
    counts of every load made inside the block."""
    global _ACCOUNTING
    acct = LoadAccounting()
    prev = _ACCOUNTING
    _ACCOUNTING = acct
    try:
        yield acct
    finally:
        _ACCOUNTING = prev


def _safetensors_files(model_dir: str) -> List[SafetensorsFile]:
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {model_dir}")
    return [SafetensorsFile(p) for p in files]


@dataclasses.dataclass(frozen=True)
class _Dest:
    """Where one checkpoint tensor (or a fused tensor's row section)
    lands: the tree key, the index into its stacked leading axes (already
    offset by the key's layer range), and how it is cut and turned."""

    key: str
    index: tuple
    transpose: bool
    rows: Optional[Tuple[int, int]] = None


def _plan(files: List[SafetensorsFile], cfg: ModelConfig) -> tuple:
    """Map every checkpoint tensor to its place, with the JAX loader's
    errors in its order (files in name order, names sorted in each):
    a layer beyond the config's (deepseek_v3's MTP layers skipped), and
    each stacked key's layer (or expert) coverage. Returns ({(file, name):
    [_Dest]}, the keys found)."""
    L, E = cfg.num_layers, cfg.num_experts
    layer_map = _layer_map_for(cfg)
    fused = _fused_sections(cfg)
    singles: Dict[str, tuple] = {}
    staging: Dict[str, Dict[int, tuple]] = {}     # key → {layer: src}
    expert_staging: Dict[str, Dict[tuple, tuple]] = {}
    for f in files:
        for name in f.keys():
            info = f.tensors[name]
            if name in _SINGLES:
                key, transpose = _SINGLES[name]
                singles[key] = (f, info, transpose, None)
                continue
            if not name.startswith("model.layers."):
                continue
            idx_str, sub = name[len("model.layers."):].split(".", 1)
            i = int(idx_str)
            if i >= L:
                if i < L + cfg.num_nextn_predict_layers:
                    # deepseek_v3 MTP heads live at model.layers.{L}+:
                    # generation never runs them
                    continue
                raise ValueError(
                    f"checkpoint tensor {name} is beyond the config's "
                    f"{L} layers (+{cfg.num_nextn_predict_layers} MTP) "
                    f"— config.json/checkpoint mismatch")
            prefix = next((p for p in _EXPERT_PREFIXES
                           if sub.startswith(p)), None)
            if prefix is not None:
                e_str, wname, _ = sub[len(prefix):].split(".", 2)
                key = _EXPERT_MAP.get(wname)
                if key is not None:
                    expert_staging.setdefault(key, {})[(i, int(e_str))] = (
                        f, info, True, None)
                continue
            if sub in fused:
                for key, off, cnt in fused[sub]:
                    staging.setdefault(key, {})[i] = (f, info, True,
                                                      (off, cnt))
                continue
            mapped = layer_map.get(sub)
            if mapped is None:
                continue  # rotary inv_freq buffers etc.
            key, transpose = mapped
            staging.setdefault(key, {})[i] = (f, info, transpose, None)

    partial = _partial_ranges(cfg)
    sources: Dict[tuple, List[_Dest]] = {}

    def add(src, dest):
        f, info, _, _ = src
        sources.setdefault((f, info.name), []).append(dest)

    for key, src in singles.items():
        add(src, _Dest(key, (), src[2]))
    for key, per_layer in staging.items():
        lo, hi = partial.get(key, (0, L))
        missing = [i for i in range(lo, hi) if i not in per_layer]
        extra = [i for i in range(L) if i in per_layer
                 and not (lo <= i < hi)]
        if missing or extra:
            raise ValueError(
                f"checkpoint layer coverage wrong for {key}: missing "
                f"{missing[:4]}, outside-range {extra[:4]} "
                f"(expected layers [{lo}, {hi}))")
        for i, src in per_layer.items():
            add(src, _Dest(f"layers.{key}", (i - lo,), src[2], src[3]))
    for key, grid in expert_staging.items():
        lo, hi = partial.get(key, (0, L))
        missing = [(i, j) for i in range(lo, hi) for j in range(E)
                   if (i, j) not in grid]
        extra = [(i, j) for i in range(L) for j in range(E)
                 if (i, j) in grid and not (lo <= i < hi)]
        if extra:
            raise ValueError(
                f"checkpoint expert coverage wrong for {key}: tensors "
                f"at layers outside [{lo}, {hi}): {extra[:4]}")
        if missing:
            raise ValueError(f"checkpoint missing experts {missing[:4]}… "
                             f"for {key}")
        for (i, j), src in grid.items():
            add(src, _Dest(f"layers.{key}", (i - lo, j), True))
    found = (set(singles) | {f"layers.{k}" for k in staging}
             | {f"layers.{k}" for k in expert_staging})
    return sources, found


def _landed_shape(info: TensorInfo, dest: _Dest) -> tuple:
    shape = list(info.shape)
    if dest.rows is not None:
        shape[0] = dest.rows[1]
    return tuple(reversed(shape)) if dest.transpose else tuple(shape)


def _quantized_empty(lead: tuple, d: int, f: int, bits: int,
                     dev: torch.device) -> QuantizedTensor:
    """Storage of a stacked ``[*lead, d, f]`` layer matmul quantized as
    ``quant.quantize_params`` quantizes it: int8 with one scale per
    (layer, out-channel), or grouped int4 (the whole axis one group where
    128 does not divide it; packed where d is even)."""
    if bits == 8:
        return _int8_empty(lead + (d, f), lead + (1, f), dev)
    group = GROUP if d % GROUP == 0 else d
    packed = d % 2 == 0
    return QuantizedTensor(
        torch.empty(lead + (d // 2 if packed else d, f), dtype=torch.int8,
                    device=dev),
        torch.empty(lead + (d // group, f), dtype=torch.float32,
                    device=dev), group=group, packed4=packed)


def _int8_empty(shape: tuple, scale_shape: tuple,
                dev: torch.device) -> QuantizedTensor:
    return QuantizedTensor(
        torch.empty(shape, dtype=torch.int8, device=dev),
        torch.empty(scale_shape, dtype=torch.float32, device=dev))


def _quantize_into(dst: QuantizedTensor, src: torch.Tensor, dtype,
                   bits: int) -> None:
    """Quantize ``src`` ``[d, f]`` (cast to ``dtype`` first, as the tree
    of the plain load holds it) into ``dst``'s ``[d, f]`` slice, in
    column chunks: every encoding scales per column (or per column and
    row group), so the chunks' scales are the whole slice's."""
    d, f = src.shape
    step = max(1, _QUANT_CHUNK // d)
    for c0 in range(0, f, step):
        w = src[:, c0:c0 + step].to(dtype)
        part = (quantize_array_grouped(w, bits=4) if bits == 4
                else quantize_array(w, keep_axes=(-1,)))
        dst.q[:, c0:c0 + step].copy_(part.q)
        dst.scale[:, c0:c0 + step].copy_(part.scale)


def _quantize_embed_into(embed: QuantizedTensor,
                         head: Optional[QuantizedTensor],
                         src: torch.Tensor, dtype) -> None:
    """The int8 embedding (one scale per row) and, for a tied head, its
    pre-transposed int8 head ``[D, V]`` (one scale per column), in row
    chunks of ``src`` ``[V, D]``."""
    v, d = src.shape
    step = max(1, _QUANT_CHUNK // d)
    for r0 in range(0, v, step):
        w = src[r0:r0 + step].to(dtype)
        part = quantize_array(w, keep_axes=(0,))
        embed.q[r0:r0 + step].copy_(part.q)
        embed.scale[r0:r0 + step].copy_(part.scale)
        if head is not None:
            part = quantize_array(w.t(), keep_axes=(-1,))
            head.q[:, r0:r0 + step].copy_(part.q)
            head.scale[:, r0:r0 + step].copy_(part.scale)


def _parse_quantization(quantization: str) -> tuple:
    """(bits, quantize the embedding) of a weight quantization, bits 0 for
    none."""
    if quantization == "none":
        return 0, False
    if quantization not in ("int8", "int8-noembed", "int4",
                            "int4-noembed"):
        raise ValueError(f"unknown weight quantization {quantization!r}")
    return (4 if quantization.startswith("int4") else 8,
            not quantization.endswith("-noembed"))


def load_llama_params(model_dir: str, cfg: Optional[ModelConfig] = None,
                      device="cuda", dtype: torch.dtype = torch.bfloat16,
                      quantization: str = "none"
                      ) -> Tuple[Dict[str, object], ModelConfig]:
    """Load an HF checkpoint directory into the stacked parameter tree on
    ``device``: (params, cfg). ``cfg`` comes back replaced with
    ``tie_word_embeddings=True`` when the config is untied and the
    checkpoint has no ``lm_head.weight`` (an implicit tie). Every name of
    the family's ``param_shapes`` must be covered with its shape."""
    cfg = cfg or ModelConfig.from_model_dir(model_dir)
    bits, qembed = _parse_quantization(quantization)
    if bits and cfg.kv_lora_rank > 0:
        raise NotImplementedError(
            "quantize-on-load covers the dense llama families; MLA "
            "weights load in the engine dtype (EngineCore refuses MLA "
            "with int8 / int4 weights)")
    dev = resolve_device(device)
    files = _safetensors_files(model_dir)
    sources, found = _plan(files, cfg)
    if "lm_head" not in found and not cfg.tie_word_embeddings:
        # some checkpoints tie implicitly by omitting lm_head
        cfg = dataclasses.replace(cfg, tie_word_embeddings=True)
    shapes = dict(family(cfg).param_shapes(cfg))
    if "lm_head" in found and "lm_head" not in shapes:
        shapes["lm_head"] = (cfg.hidden_size, cfg.vocab_size)
    missing = [k for k in shapes if k not in found]
    if missing:
        raise ValueError(f"checkpoint under {model_dir} has no tensors for "
                         f"{missing[:4]} (the {cfg.model_type} config's "
                         f"parameters)")
    extra = sorted(k for k in found if k not in shapes)
    if extra:
        raise ValueError(f"checkpoint tensors map to {extra[:4]}, which "
                         f"the {cfg.model_type} config has no parameter "
                         f"for")
    for (f, name), dests in sources.items():
        for dest in dests:
            want = shapes[dest.key][len(dest.index):]
            got = _landed_shape(f.tensors[name], dest)
            if got != tuple(want):
                raise ValueError(
                    f"checkpoint tensor {name}: shape "
                    f"{list(f.tensors[name].shape)} lands as {got} in "
                    f"{dest.key}, which wants {tuple(want)}")

    # the whole tree, preallocated on the device
    tied = "lm_head" not in shapes
    params: Dict[str, object] = {}
    for key, shape in shapes.items():
        if bits and key.startswith("layers.") and key[7:] in LAYER_MATMULS:
            params[key] = _quantized_empty(tuple(shape[:-2]), shape[-2],
                                           shape[-1], bits, dev)
        elif bits and key == "lm_head":     # int8 under int4 too
            params[key] = _int8_empty(shape, (1, shape[1]), dev)
        elif bits and key == "embed" and qembed:
            params[key] = _int8_empty(shape, (shape[0], 1), dev)
        else:
            params[key] = torch.empty(shape, dtype=dtype, device=dev)
    tied_head = None
    if bits and qembed and tied:
        # quant.quantize_named's pre-transposed int8 head [D, V]
        V, D = shapes["embed"]
        tied_head = params["lm_head"] = _int8_empty((D, V), (1, V), dev)

    # one checkpoint tensor at a time through one (pinned) host buffer
    acct = _ACCOUNTING
    size = max((f.tensors[name].nbytes for f, name in sources), default=0)
    buf = torch.empty(size, dtype=torch.uint8,
                      pin_memory=dev.type == "cuda")
    if acct is not None:
        acct.stage(size)
    copied = None
    try:
        for f in files:
            for info in f.tensors.values():           # data order
                dests = sources.get((f, info.name))
                if not dests:
                    continue
                if copied is not None:
                    copied.synchronize()    # the buffer's last copy landed
                host = f.read_into(info, buf)
                if acct is not None:
                    acct.read(info.nbytes)
                t = host.to(dev, non_blocking=True)
                if dev.type == "cuda":
                    copied = torch.cuda.Event()
                    copied.record()
                for dest in dests:
                    src = t
                    if dest.rows is not None:
                        off, cnt = dest.rows
                        src = src[off:off + cnt]
                    if dest.transpose:
                        src = src.t()
                    dst = params[dest.key][dest.index]
                    if not isinstance(dst, QuantizedTensor):
                        dst.copy_(src)
                    elif dest.key == "embed":
                        _quantize_embed_into(dst, tied_head, src, dtype)
                    else:
                        _quantize_into(dst, src, dtype,
                                       8 if dest.key == "lm_head" else bits)
                # the card's copy goes before the next one is made
                del t, src, host
        if copied is not None:
            copied.synchronize()
    finally:
        if acct is not None:
            acct.unstage(size)
    return params, cfg


def load_params_auto(model_dir: str, cfg: Optional[ModelConfig] = None,
                     device="cuda", dtype: torch.dtype = torch.bfloat16,
                     quantization: str = "none"
                     ) -> Tuple[Dict[str, object], ModelConfig]:
    """The loader entry point: (params, cfg) of an HF model directory on
    ``device`` (``load_llama_params``: llama / qwen2 / qwen3 / gemma2 /
    phi3 and deepseek_v2 / v3 MLA). It takes no mesh: an sp mesh
    replicates the loaded tree (``parallel.sharding.replicate_params``),
    and a tp mesh, which would shard it, is not ported."""
    cfg = cfg or ModelConfig.from_model_dir(model_dir)
    return load_llama_params(model_dir, cfg, device, dtype, quantization)


def save_hf_style(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                  out_dir: str, max_file_bytes: Optional[int] = None
                  ) -> List[str]:
    """Write a parameter tree out under the HF names, each tensor in its
    own dtype and copied to the host alone: one ``model.safetensors``, or
    ``model-0000k-of-0000n.safetensors`` files of at most
    ``max_file_bytes`` of tensors each (a tensor larger than that gets a
    file of its own). Returns the paths written."""
    if (cfg.model_type in ("deepseek_v2", "deepseek_v3")
            and cfg.num_experts > 0):
        raise NotImplementedError(
            "save_hf_style cannot write the deepseek hybrid MoE layout "
            "(partial layer stacks + deepseek expert naming); the MLA "
            "tests carry their own converter")
    quantized = [k for k, v in params.items()
                 if isinstance(v, QuantizedTensor)]
    if quantized:
        raise ValueError(f"save_hf_style writes unquantized trees; "
                         f"{quantized[:4]} are quantized")
    inv = {key: (sub, t) for sub, (key, t) in _layer_map_for(cfg).items()}
    fused = _fused_sections(cfg)
    entries = []

    def add(name, w, transpose):
        shape = tuple(w.shape)[::-1] if transpose else tuple(w.shape)
        entries.append((name, w.dtype, shape,
                        (lambda w=w: w.t()) if transpose else
                        (lambda w=w: w)))

    done = {"embed", "final_norm"}
    add("model.embed_tokens.weight", params["embed"], False)
    add("model.norm.weight", params["final_norm"], False)
    if "lm_head" in params:
        add("lm_head.weight", params["lm_head"], True)
        done.add("lm_head")
    for i in range(cfg.num_layers):
        for sub, sections in fused.items():
            parts = [params[f"layers.{k}"][i] for k, _, _ in sections]
            rows = sum(p.shape[-1] for p in parts)
            entries.append((f"model.layers.{i}.{sub}", parts[0].dtype,
                            (rows, parts[0].shape[0]),
                            lambda parts=parts: torch.cat(
                                [p.t() for p in parts], 0)))
            done.update(f"layers.{k}" for k, _, _ in sections)
        for key, (sub, transpose) in inv.items():
            if f"layers.{key}" in params:
                add(f"model.layers.{i}.{sub}",
                    params[f"layers.{key}"][i], transpose)
                done.add(f"layers.{key}")
    left = sorted(set(params) - done)
    if left:
        raise ValueError(f"save_hf_style has no HF name for {left[:4]}")

    files: List[list] = [[]]
    used = 0
    for e in entries:
        n = math.prod(e[2]) * e[1].itemsize
        if files[-1] and max_file_bytes and used + n > max_file_bytes:
            files.append([])
            used = 0
        files[-1].append(e)
        used += n
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for k, group in enumerate(files):
        name = ("model.safetensors" if len(files) == 1 else
                f"model-{k + 1:05d}-of-{len(files):05d}.safetensors")
        path = os.path.join(out_dir, name)
        write_file(path, group, {"format": "pt"})
        paths.append(path)
    return paths
