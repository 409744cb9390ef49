"""Parameters of the PyTorch llama: conversion and random init.

``params_from_numpy`` takes the JAX package's parameter tree (names from
``param_shapes``, ``[in, out]`` matmul layout, layer weights stacked
``[L, ...]``) as numpy arrays, so a test can run both packages on the same
weights. ``init_params`` makes random weights from a seed directly on the
device, one layer slice at a time, so the f32 staging buffer stays one
slice large (the 8B geometry's bf16 tree alone is ~16 GB).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .config import ModelConfig
from .device import resolve_device
from .models.llama import param_shapes

_NORMS = ("ln1", "ln2", "ln1_post", "ln2_post", "q_norm", "k_norm")
_BIASES = ("bq", "bk", "bv")


def params_from_numpy(np_params: Mapping[str, np.ndarray], cfg: ModelConfig,
                      device="cuda",
                      dtype: torch.dtype = torch.bfloat16
                      ) -> Dict[str, torch.Tensor]:
    """JAX-layout numpy tree → tensors on ``device`` in ``dtype``. Every
    name of ``param_shapes(cfg)`` must be present with its shape."""
    dev = resolve_device(device)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name not in np_params:
            raise KeyError(f"parameter {name!r} missing")
        arr = np.array(np_params[name], dtype=np.float32)   # owned copy
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"parameter {name!r}: shape {arr.shape} != "
                             f"{shape}")
        out[name] = torch.from_numpy(arr).to(device=dev, dtype=dtype)
    return out


def init_params(cfg: ModelConfig, seed: int, device="cuda",
                dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """Random weights with the JAX package's init rule (norms 1, or 0 for
    plus-one norms; biases 0; matmuls N(0, 1/fan_in)), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _NORMS or name == "final_norm":
            fill = 0.0 if cfg.norm_plus_one else 1.0
            out[name] = torch.full(shape, fill, dtype=dtype, device=dev)
            continue
        if leaf in _BIASES:
            out[name] = torch.zeros(shape, dtype=dtype, device=dev)
            continue
        fan_in = shape[-2] if len(shape) > 1 else shape[-1]
        t = torch.empty(shape, dtype=dtype, device=dev)
        slices = t if len(shape) == 3 else t[None]
        for s in slices:
            s.copy_(torch.randn(s.shape, generator=gen, device=dev,
                                dtype=torch.float32) * fan_in ** -0.5)
        out[name] = t
    return out
