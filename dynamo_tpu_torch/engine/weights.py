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
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .config import ModelConfig
from .device import resolve_device
from .models import family
from .quant import QuantizedTensor

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
