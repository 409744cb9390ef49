"""Llama-family transformer in PyTorch over a paged KV pool.

Counterpart of ``dynamo_tpu.engine.models.llama`` for the dense llama
family (untied or tied heads, qkv bias, qk-norm, gemma post-norms and
soft-caps). Parameters are a plain dict of tensors with the JAX package's
names and layout (``param_shapes``): matmul weights ``[in, out]``, layer
weights stacked on a leading ``[L, ...]`` axis.

The KV cache is ``{"k": [L, NTOK, KVH*Dh], "v": ...}`` with block 0 the
reserved trash block; each forward writes this step's K/V IN PLACE with
``index_copy_`` (pad tokens and inactive slots aim at trash rows). Casts
follow the JAX model: norms and rope in f32 cast back to the activation
dtype, logits in f32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..attention import (flash_prefill, flat_token_indices, paged_attention,
                         softcap_scores)
from ..config import ModelConfig

Params = Dict[str, torch.Tensor]
KVCache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             plus_one: bool = False) -> torch.Tensor:
    x32 = x.float()
    normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    if plus_one:   # gemma convention: weights are zero-centered
        return (normed * (1.0 + w.float())).to(x.dtype)
    return normed.to(x.dtype) * w


def rope_inv_freq(cfg: ModelConfig) -> np.ndarray:
    """Rotary inverse frequencies incl. llama-3 / linear / longrope scaling."""
    dim = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    rs = cfg.rope_scaling
    if rs is not None and rs.rope_type in ("llama3",):
        low_wl = rs.original_max_position_embeddings / rs.low_freq_factor
        high_wl = rs.original_max_position_embeddings / rs.high_freq_factor
        wl = 2 * np.pi / inv
        smooth = (rs.original_max_position_embeddings / wl - rs.low_freq_factor) / (
            rs.high_freq_factor - rs.low_freq_factor)
        inv = np.where(
            wl > low_wl, inv / rs.factor,
            np.where(wl < high_wl, inv,
                     (1 - smooth) * inv / rs.factor + smooth * inv))
    elif rs is not None and rs.rope_type == "linear":
        inv = inv / rs.factor
    elif rs is not None and rs.rope_type == "longrope":
        use_long = (rs.longrope_active == "long"
                    or (rs.longrope_active == "auto"
                        and cfg.max_position_embeddings
                        > rs.original_max_position_embeddings))
        ext = np.asarray(rs.long_factor if use_long else rs.short_factor,
                         np.float64)
        inv = inv / ext
    return inv.astype(np.float32)


def rope_attention_scaling(cfg: ModelConfig) -> float:
    """cos/sin multiplier: longrope's sqrt(1 + ln(M/O)/ln(O)), else 1.0."""
    rs = cfg.rope_scaling
    if rs is None or rs.rope_type != "longrope":
        return 1.0
    if rs.attention_factor:
        return rs.attention_factor
    factor = cfg.max_position_embeddings / rs.original_max_position_embeddings
    if factor <= 1.0:
        return 1.0
    return math.sqrt(1 + math.log(factor)
                     / math.log(rs.original_max_position_embeddings))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor, scaling: float = 1.0) -> torch.Tensor:
    """x: [T, H, Dh]; positions: [T]. HF half-split rotate convention."""
    angles = positions[:, None].float() * inv_freq[None, :]       # [T, Dh/2]
    cos = torch.cos(angles)[:, None, :] * scaling
    sin = torch.sin(angles)[:, None, :] * scaling
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor,
           down_w: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g, u = x @ gate_w, x @ up_w
    if act in ("gelu_pytorch_tanh", "gelu"):   # gemma families
        gated = F.gelu(g, approximate="tanh")
    elif act == "silu":
        gated = F.silu(g)
    else:
        raise ValueError(f"unsupported hidden_act {act!r}")
    return (gated * u) @ down_w


# ---------------------------------------------------------------------------
# Parameters and KV pool
# ---------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Names and shapes of the dense llama parameter tree (the JAX
    package's ``param_shapes`` for ``num_experts == 0``)."""
    if cfg.num_experts > 0 or cfg.kv_lora_rank > 0:
        raise NotImplementedError(
            "MoE and MLA families are not implemented by the PyTorch engine")
    L, D = cfg.num_layers, cfg.hidden_size
    H, KVH, Dh, F_ = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                      cfg.intermediate_size)
    shapes = {
        "embed": (cfg.vocab_size, D),
        "final_norm": (D,),
        "layers.ln1": (L, D),
        "layers.ln2": (L, D),
        "layers.wq": (L, D, H * Dh),
        "layers.wk": (L, D, KVH * Dh),
        "layers.wv": (L, D, KVH * Dh),
        "layers.wo": (L, H * Dh, D),
        "layers.gate": (L, D, F_),
        "layers.up": (L, D, F_),
        "layers.down": (L, F_, D),
    }
    if cfg.attention_bias:
        shapes["layers.bq"] = (L, H * Dh)
        shapes["layers.bk"] = (L, KVH * Dh)
        shapes["layers.bv"] = (L, KVH * Dh)
    if cfg.qk_norm:
        shapes["layers.q_norm"] = (L, Dh)
        shapes["layers.k_norm"] = (L, Dh)
    if cfg.post_norms:
        shapes["layers.ln1_post"] = (L, D)
        shapes["layers.ln2_post"] = (L, D)
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (D, cfg.vocab_size)
    return shapes


def init_kv_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                  device, dtype=torch.bfloat16) -> KVCache:
    """Zeroed pool ``[L, num_blocks * block_size, KVH*Dh]`` for k and v."""
    shape = (cfg.num_layers, num_blocks * block_size,
             cfg.num_kv_heads * cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def sliding_layer_mask(cfg: ModelConfig) -> np.ndarray:
    """Per-layer local-attention flags (HF ``layer_types`` or the gemma2
    even-layers-local default)."""
    if cfg.sliding_window is None:
        return np.zeros((cfg.num_layers,), dtype=bool)
    if cfg.layer_types:
        return np.array([t == "sliding_attention" for t in cfg.layer_types],
                        dtype=bool)
    return np.array([i % 2 == 0 for i in range(cfg.num_layers)], dtype=bool)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _attn_scale(cfg: ModelConfig) -> float:
    return (cfg.query_pre_attn_scalar or cfg.head_dim) ** -0.5


def _embed(params: Params, tokens: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.embed_scale:   # gemma normalizer, applied in the embed dtype
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    return x


def _logits(params: Params, x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    head = params.get("lm_head")
    out = x @ head if head is not None else x @ params["embed"].t()
    out = out.float()
    if cfg.final_logit_softcap:
        out = softcap_scores(out, cfg.final_logit_softcap)
    return out


def _run_layers(params: Params, kv: KVCache, x: torch.Tensor,
                positions: torch.Tensor, slots: torch.Tensor,
                cfg: ModelConfig, attn_fn) -> torch.Tensor:
    """The transformer stack: per layer qkv projection, rope, the in-place
    KV write at ``slots``, ``attn_fn(q, li, sliding)`` (the one thing the
    prefill and decode paths differ in), wo residual, MLP. Returns the
    final-normed hidden states."""
    N = x.shape[0]
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    inv_freq = torch.from_numpy(rope_inv_freq(cfg)).to(x.device)
    rope_att = rope_attention_scaling(cfg)
    sliding_flags = sliding_layer_mask(cfg)
    p1 = cfg.norm_plus_one
    eps = cfg.rms_norm_eps
    for li in range(cfg.num_layers):
        lp = {name[len("layers."):]: w[li] for name, w in params.items()
              if name.startswith("layers.")}
        hn = rms_norm(x, lp["ln1"], eps, p1)
        q, k, v = hn @ lp["wq"], hn @ lp["wk"], hn @ lp["wv"]
        if cfg.attention_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = q.reshape(N, H, Dh)
        k = k.reshape(N, KVH, Dh)
        v = v.reshape(N, KVH, Dh)
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"], eps, p1)
            k = rms_norm(k, lp["k_norm"], eps, p1)
        q = apply_rope(q, positions, inv_freq, rope_att)
        k = apply_rope(k, positions, inv_freq, rope_att)
        kv["k"][li].index_copy_(0, slots, k.reshape(N, -1).to(kv["k"].dtype))
        kv["v"][li].index_copy_(0, slots, v.reshape(N, -1).to(kv["v"].dtype))
        attn = attn_fn(q, li, bool(sliding_flags[li]))
        attn_out = attn.reshape(N, H * Dh) @ lp["wo"]
        if cfg.post_norms:
            attn_out = rms_norm(attn_out, lp["ln1_post"], eps, p1)
        x = x + attn_out
        hn2 = rms_norm(x, lp["ln2"], eps, p1)
        mlp_out = swiglu(hn2, lp["gate"], lp["up"], lp["down"], cfg.hidden_act)
        if cfg.post_norms:
            mlp_out = rms_norm(mlp_out, lp["ln2_post"], eps, p1)
        x = x + mlp_out
    return rms_norm(x, params["final_norm"], eps, p1)


def prefill_forward(params: Params, kv: KVCache, tokens: torch.Tensor,
                    block_table: torch.Tensor, start_pos: int, true_len: int,
                    cfg: ModelConfig, block_size: int) -> torch.Tensor:
    """Single-sequence (chunk) prefill.

    tokens: [T] padded to a bucket; block_table: [M] this sequence's
    blocks; start_pos: tokens[0]'s absolute position (> 0 after a prefix
    hit: blocks [0, start_pos) already hold the prefix KV); true_len: the
    valid tokens in this chunk. Writes the chunk's KV into ``kv`` in place
    (pads go to the trash block 0) and returns the last valid token's
    logits [V] f32.
    """
    T = tokens.shape[0]
    dev = tokens.device
    M = block_table.shape[0]
    scale = _attn_scale(cfg)
    positions = start_pos + torch.arange(T, device=dev)
    valid = torch.arange(T, device=dev) < true_len
    # pads may sit past the table: clamp the block index before the gather
    blk = block_table.long()[torch.clamp(positions // block_size, max=M - 1)]
    slots = torch.where(valid, blk * block_size + positions % block_size,
                        torch.zeros_like(positions))
    seq_len = start_pos + true_len
    idx = flat_token_indices(block_table[None, :], block_size)[0]   # [S]
    S = idx.shape[0]
    KVH, Dh = cfg.num_kv_heads, cfg.head_dim

    def attn(q, li, sliding):
        # the whole block table (prefix KV + this chunk), dense
        ks = kv["k"][li].index_select(0, idx).reshape(S, KVH, Dh)
        vs = kv["v"][li].index_select(0, idx).reshape(S, KVH, Dh)
        return flash_prefill(q, ks, vs, scale=scale, start_pos=start_pos,
                             seq_len=seq_len, sliding=sliding,
                             window=cfg.sliding_window,
                             softcap=cfg.attn_logit_softcap or None)

    x = _embed(params, tokens, cfg)
    x = _run_layers(params, kv, x, positions, slots, cfg, attn)
    return _logits(params, x[max(true_len - 1, 0)], cfg)


def decode_forward(params: Params, kv: KVCache, tokens: torch.Tensor,
                   positions: torch.Tensor, block_tables: torch.Tensor,
                   cfg: ModelConfig, block_size: int) -> torch.Tensor:
    """Batched single-token decode step.

    tokens: [B] input token per slot; positions: [B] their absolute
    positions (inactive slots: position 0 with an all-zero table, i.e. the
    trash block); block_tables: [B, M] int32. Writes each slot's KV in place
    and returns logits [B, V] f32.
    """
    B = tokens.shape[0]
    dev = tokens.device
    scale = _attn_scale(cfg)
    pos = positions.long()
    slots = (block_tables.long()[torch.arange(B, device=dev), pos // block_size]
             * block_size + pos % block_size)
    seq_lens = (positions + 1).to(torch.int32)

    def attn(q, li, sliding):
        win_lo = None
        if cfg.sliding_window is not None and sliding:
            win_lo = positions - cfg.sliding_window
        return paged_attention(q, kv["k"][li], kv["v"][li], block_tables,
                               seq_lens, block_size=block_size, scale=scale,
                               softcap=cfg.attn_logit_softcap or None,
                               win_lo=win_lo)

    x = _embed(params, tokens, cfg)
    x = _run_layers(params, kv, x, positions, slots, cfg, attn)
    return _logits(params, x, cfg)
