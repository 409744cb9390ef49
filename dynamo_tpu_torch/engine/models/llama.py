"""Llama-family transformer in PyTorch over a paged KV pool.

Counterpart of ``dynamo_tpu.engine.models.llama`` for the dense llama
family (untied or tied heads, qkv bias, qk-norm, gemma post-norms and
soft-caps). Parameters are a plain dict of tensors with the JAX package's
names and layout (``param_shapes``): matmul weights ``[in, out]``, layer
weights stacked on a leading ``[L, ...]`` axis.

Matmul weights may be ``quant.QuantizedTensor`` leaves (int8 or packed
int4); every projection goes through ``quant.mm``, and an int8 LM head
through ``lm_head.lm_head_int8``.

The KV cache is ``{"k": [L, NTOK, KVH*Dh], "v": ...}`` with block 0 the
reserved trash block, or ``[L, NTOK, KVH*Dh + KV_SCALE_LANES]`` int8 rows
with in-row scales; each forward writes this step's K/V IN PLACE with
``index_copy_`` (pad tokens and inactive slots aim at trash rows) before
attention reads it, so the current token sees the quantized values later
steps see. Casts follow the JAX model: norms and rope in f32 cast back to
the activation dtype, logits in f32.

Every forward pass runs the same per-layer body (``_layer``) over token
shards: one shard on one device for prefill, decode and ragged dispatch;
one shard per mesh device for the sequence-parallel prefill
(``prefill_forward_sp``), where only attention crosses shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..attention import (KV_SCALE_LANES, RAGGED_WIN_SENTINEL,
                         dequant_kv_rows, flash_prefill, flat_token_indices,
                         kv_value_lanes, paged_attention, quantize_kv_rows,
                         ragged_paged_attention, softcap_scores)
from ..config import ModelConfig
from ..lm_head import lm_head_int8
from ..quant import QuantizedTensor, mm

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
    g, u = mm(x, gate_w), mm(x, up_w)
    if act in ("gelu_pytorch_tanh", "gelu"):   # gemma families
        gated = F.gelu(g, approximate="tanh")
    elif act == "silu":
        gated = F.silu(g)
    else:
        raise ValueError(f"unsupported hidden_act {act!r}")
    return mm(gated * u, down_w)


def run_experts_dense(x: torch.Tensor, gate_w: torch.Tensor,
                      up_w: torch.Tensor, down_w: torch.Tensor,
                      top_idx: torch.Tensor,
                      top_w: torch.Tensor) -> torch.Tensor:
    """Every expert over every token, then the top-k combine (the JAX
    package's ``run_experts_dense``): x [N, D]; gate/up [E, D, F]; down [E,
    F, D]; top_idx / top_w [N, k] the chosen experts and their weights.
    Dense over E, so the shapes are static whatever the routing picks (a
    decode step stays one CUDA graph); the combine is [N, E] f32 with each
    token's weights at its experts and zeros elsewhere. The expert products
    are batched matmuls over E with x broadcast (``torch.einsum`` would
    copy each [E, D, F] weight into another layout first)."""
    E = down_w.shape[0]
    combine = torch.zeros((x.shape[0], E), dtype=torch.float32,
                          device=x.device).scatter_(1, top_idx.long(),
                                                    top_w.float())
    g = torch.matmul(x, gate_w)                                  # [E, N, F]
    u = torch.matmul(x, up_w)
    y = torch.matmul(F.silu(g) * u, down_w)                      # [E, N, D]
    return torch.einsum("ne,end->nd", combine.to(y.dtype), y)


# ---------------------------------------------------------------------------
# Parameters and KV pool
# ---------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Names and shapes of the dense llama parameter tree (the JAX
    package's ``param_shapes`` for ``num_experts == 0``)."""
    if cfg.num_experts > 0 or cfg.kv_lora_rank > 0:
        raise NotImplementedError(
            "the MoE llama families (mixtral, qwen2_moe) are not "
            "implemented by the PyTorch engine (ROADMAP A8); MLA models "
            "take models/mla.py")
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
                  device, dtype=torch.bfloat16,
                  quantization: str = "none") -> KVCache:
    """Zeroed pool ``[L, num_blocks * block_size, KVH*Dh]`` for k and v in
    ``dtype``; ``quantization="int8"``: int8 rows of ``KVH*Dh +
    KV_SCALE_LANES`` lanes (attention.quantize_kv_rows)."""
    C = cfg.num_kv_heads * cfg.head_dim
    if quantization == "int8":
        C, dtype = C + KV_SCALE_LANES, torch.int8
    elif quantization != "none":
        raise ValueError(f"unknown kv quantization {quantization!r} "
                         f"(none|int8)")
    shape = (cfg.num_layers, num_blocks * block_size, C)
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
    emb = params["embed"]
    if isinstance(emb, QuantizedTensor):
        # per-row int8: dequantized in the final-norm dtype, as in JAX
        dt = params["final_norm"].dtype
        x = emb.q[tokens].to(dt) * emb.scale[tokens].to(dt)
    else:
        x = emb[tokens]
    if cfg.embed_scale:   # gemma normalizer, applied in the embed dtype
        # a 0-dim CPU tensor enters a CUDA kernel as a scalar argument: no
        # copy, so a captured decode program may run this
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    return x


def _logits(params: Params, x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    head = params.get("lm_head")
    if isinstance(head, QuantizedTensor) and not head.group:
        # every int8 head, tied ones pre-transposed by quant.quantize_named
        out = lm_head_int8(x, head.q, head.scale)
    elif head is not None:
        out = mm(x, head)
    else:
        out = x @ params["embed"].t()
    out = out.float()
    if cfg.final_logit_softcap:
        out = softcap_scores(out, cfg.final_logit_softcap)
    return out


@dataclasses.dataclass
class _Shard:
    """Token rows on one device: their hidden states ``x``, positions and
    rope frequencies there, their pool slots (on the pool's device), and
    the weights on that device."""

    params: Params
    x: torch.Tensor
    positions: torch.Tensor
    slots: torch.Tensor
    inv_freq: torch.Tensor


# rope_inv_freq per (rope fields, device), copied to the device once: a
# captured program (engine/programs.py) cannot copy from pageable host
# memory
_INV_FREQ: Dict[tuple, torch.Tensor] = {}


def _inv_freq(cfg: ModelConfig, device: torch.device) -> torch.Tensor:
    key = (cfg.head_dim, cfg.rope_theta, repr(cfg.rope_scaling),
           cfg.max_position_embeddings, str(device))
    t = _INV_FREQ.get(key)
    if t is None:
        t = _INV_FREQ[key] = torch.from_numpy(rope_inv_freq(cfg)).to(device)
    return t


def _shard(params: Params, x: torch.Tensor, positions: torch.Tensor,
           slots: torch.Tensor, cfg: ModelConfig) -> _Shard:
    return _Shard(params, x, positions, slots, _inv_freq(cfg, x.device))


def _layer(shards, kv: KVCache, li: int, cfg: ModelConfig, attn_fn) -> None:
    """Layer ``li`` over token shards, updating each ``shard.x``: per shard
    the qkv projection, rope and the in-place KV write at its slots; then
    ``attn_fn(qs, ks, vs)`` → one attention output per shard, the one step
    that crosses shards; then per shard the wo residual and the MLP. The
    single-device paths pass one shard (``_run_layers``), the
    sequence-parallel prefill one per mesh device."""
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rope_att = rope_attention_scaling(cfg)
    p1 = cfg.norm_plus_one
    eps = cfg.rms_norm_eps
    pool_dev = kv["k"].device
    lps = [{name[len("layers."):]: w[li] for name, w in sh.params.items()
            if name.startswith("layers.")} for sh in shards]
    qs, ks, vs = [], [], []
    for sh, lp in zip(shards, lps):
        N = sh.x.shape[0]
        hn = rms_norm(sh.x, lp["ln1"], eps, p1)
        q, k, v = mm(hn, lp["wq"]), mm(hn, lp["wk"]), mm(hn, lp["wv"])
        if cfg.attention_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = q.reshape(N, H, Dh)
        k = k.reshape(N, KVH, Dh)
        v = v.reshape(N, KVH, Dh)
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"], eps, p1)
            k = rms_norm(k, lp["k_norm"], eps, p1)
        q = apply_rope(q, sh.positions, sh.inv_freq, rope_att)
        k = apply_rope(k, sh.positions, sh.inv_freq, rope_att)
        if kv["k"].dtype == torch.int8:
            # one call for both sides: the rows are quantized one by one
            k_rows, v_rows = quantize_kv_rows(
                torch.cat([k.reshape(N, -1), v.reshape(N, -1)])).split(N)
        else:
            k_rows = k.reshape(N, -1).to(kv["k"].dtype)
            v_rows = v.reshape(N, -1).to(kv["v"].dtype)
        kv["k"][li].index_copy_(0, sh.slots, k_rows.to(pool_dev))
        kv["v"][li].index_copy_(0, sh.slots, v_rows.to(pool_dev))
        qs.append(q)
        ks.append(k)
        vs.append(v)
    for sh, lp, attn in zip(shards, lps, attn_fn(qs, ks, vs)):
        attn_out = mm(attn.reshape(sh.x.shape[0], H * Dh), lp["wo"])
        if cfg.post_norms:
            attn_out = rms_norm(attn_out, lp["ln1_post"], eps, p1)
        x = sh.x + attn_out
        hn2 = rms_norm(x, lp["ln2"], eps, p1)
        mlp_out = swiglu(hn2, lp["gate"], lp["up"], lp["down"], cfg.hidden_act)
        if cfg.post_norms:
            mlp_out = rms_norm(mlp_out, lp["ln2_post"], eps, p1)
        sh.x = x + mlp_out


def _run_layers(params: Params, kv: KVCache, x: torch.Tensor,
                positions: torch.Tensor, slots: torch.Tensor,
                cfg: ModelConfig, attn_fn) -> torch.Tensor:
    """The transformer stack on one device: ``_layer`` over one shard of
    every row, with ``attn_fn(q, li, sliding)`` (the one thing the
    prefill, decode and ragged paths differ in). Returns the final-normed
    hidden states."""
    sh = _shard(params, x, positions, slots, cfg)
    sliding_flags = sliding_layer_mask(cfg)
    for li in range(cfg.num_layers):
        sliding = bool(sliding_flags[li])
        _layer([sh], kv, li, cfg,
               lambda qs, ks, vs: [attn_fn(qs[0], li, sliding)])
    return rms_norm(sh.x, params["final_norm"], cfg.rms_norm_eps,
                    cfg.norm_plus_one)


def _chunk_slots(block_table: torch.Tensor, positions: torch.Tensor,
                 true_len: int, block_size: int) -> torch.Tensor:
    """Flat pool slot of each chunk token; pads go to slot 0 (the trash
    block) and may sit past the table, so the block index is clamped
    before the gather."""
    M = block_table.shape[0]
    valid = torch.arange(positions.shape[0], device=positions.device) < true_len
    blk = block_table.long()[torch.clamp(positions // block_size, max=M - 1)]
    return torch.where(valid, blk * block_size + positions % block_size,
                       torch.zeros_like(positions))


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
    scale = _attn_scale(cfg)
    positions = start_pos + torch.arange(T, device=dev)
    slots = _chunk_slots(block_table, positions, true_len, block_size)
    seq_len = start_pos + true_len
    idx = flat_token_indices(block_table[None, :], block_size)[0]   # [S]
    S = idx.shape[0]
    KVH, Dh = cfg.num_kv_heads, cfg.head_dim

    def attn(q, li, sliding):
        # the whole block table (prefix KV + this chunk), dense
        ks = kv["k"][li].index_select(0, idx)
        vs = kv["v"][li].index_select(0, idx)
        if ks.dtype == torch.int8:
            # dequantize the gathered rows; the flash kernel runs unchanged
            C = kv_value_lanes(ks)
            ks = dequant_kv_rows(ks, C, q.dtype)
            vs = dequant_kv_rows(vs, C, q.dtype)
        ks = ks.reshape(S, KVH, Dh)
        vs = vs.reshape(S, KVH, Dh)
        return flash_prefill(q, ks, vs, scale=scale, start_pos=start_pos,
                             seq_len=seq_len, sliding=sliding,
                             window=cfg.sliding_window,
                             softcap=cfg.attn_logit_softcap or None)

    x = _embed(params, tokens, cfg)
    x = _run_layers(params, kv, x, positions, slots, cfg, attn)
    return _logits(params, x[max(true_len - 1, 0)], cfg)


def prefill_forward_sp(params: Params, kv: KVCache, tokens: torch.Tensor,
                       block_table: torch.Tensor, true_len: int,
                       cfg: ModelConfig, block_size: int, mesh,
                       replicas=None) -> torch.Tensor:
    """Sequence-parallel whole-prompt prefill (contract of
    ``dynamo_tpu.engine.models.llama.prefill_forward_sp``): ``prefill_
    forward`` at start_pos 0 with the token axis sharded over the mesh's
    sp axis. Shard r's T/sp rows live on ``mesh.devices[r]`` through every
    layer, with the weights there (``replicas``: weights per distinct mesh
    device, default ``parallel.sharding.replicate_params(params, ...)``);
    only attention crosses shards, as a ring (``parallel.ring_attention``,
    K2 hops on the card) over each layer's fresh K/V, as in JAX. KV rows
    go into the pool on its own device (an int8 pool quantizes them as
    ``prefill_forward`` does). T must divide by sp; global-attention,
    uncapped models only. Returns the last valid token's logits [V] f32
    on the pool's device."""
    from ...parallel.ring_attention import ring_attention
    from ...parallel.sharding import replicate_params
    if cfg.sliding_window is not None or cfg.attn_logit_softcap:
        raise NotImplementedError("the sp ring implements neither sliding "
                                  "windows nor logit soft-capping")
    n = mesh.shape["sp"]
    T = tokens.shape[0]
    if T % n:
        raise ValueError(f"prefill_forward_sp: {T} tokens do not divide "
                         f"over sp={n}")
    Tl = T // n
    dev = kv["k"].device
    positions = torch.arange(T, device=dev)
    slots = _chunk_slots(block_table, positions, true_len, block_size)
    replicas = replicas or replicate_params(params, mesh.devices)
    shards = []
    for r, d in enumerate(mesh.devices):
        rows = slice(r * Tl, (r + 1) * Tl)
        p = replicas[d]
        shards.append(_shard(p, _embed(p, tokens[rows].to(d), cfg),
                             positions[rows].to(d), slots[rows], cfg))
    scale = _attn_scale(cfg)
    for li in range(cfg.num_layers):
        _layer(shards, kv, li, cfg,
               lambda qs, ks, vs: ring_attention(qs, ks, vs, mesh,
                                                 scale=scale,
                                                 kv_len=true_len))
    r, i = divmod(max(true_len - 1, 0), Tl)
    sh = shards[r]
    last = rms_norm(sh.x[i], sh.params["final_norm"], cfg.rms_norm_eps,
                    cfg.norm_plus_one)
    return _logits(sh.params, last, cfg).to(dev)


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


def ragged_forward(params: Params, kv: KVCache, tokens: torch.Tensor,
                   positions: torch.Tensor, block_tables: torch.Tensor,
                   row_slot: torch.Tensor, seq_starts: torch.Tensor,
                   seq_counts: torch.Tensor, sample_rows: torch.Tensor,
                   cfg: ModelConfig, block_size: int,
                   max_rows: int,
                   sample_all_rows: bool = False) -> torch.Tensor:
    """Ragged mixed prefill+decode step: one forward pass serves prefill
    chunks and decode rows together (engine/ragged.py packs them).

    tokens/positions: [TT] flat token rows; block_tables: [S, M] int32
    whose LAST row is all zeros (the trash sequence dead rows aim at);
    row_slot: [TT] row → sequence; seq_starts/seq_counts: [S] int32 each
    sequence's contiguous row span, ascending starts (a decode step is a
    span of 1); sample_rows: [S] the row whose hidden state each
    sequence's logits come from (its last row; inactive sequences point
    at row 0 and their sample is discarded). Writes every row's KV in
    place at (its sequence's table, its position), then attends with
    ``ragged_paged_attention`` in every layer. Returns logits [S, V]
    f32, or with ``sample_all_rows`` (the row-sampled form that verifies
    speculative spans) logits [TT, V] of every row."""
    TT = tokens.shape[0]
    dev = tokens.device
    scale = _attn_scale(cfg)
    pos = positions.long()
    row_tables = block_tables[row_slot.long()]                    # [TT, M]
    slots = (row_tables.long()[torch.arange(TT, device=dev), pos // block_size]
             * block_size + pos % block_size)
    # each sequence's kv length after this dispatch and its first row's
    # position (a count-0 sequence reads 0; its start may lie past the rows)
    last_rows = torch.clamp(seq_starts.long()
                            + torch.clamp(seq_counts.long() - 1, min=0),
                            max=TT - 1)
    seq_ctx = torch.where(seq_counts > 0, positions[last_rows] + 1,
                          torch.zeros_like(seq_counts)).to(torch.int32)
    pos0 = seq_ctx - seq_counts

    def attn(q, li, sliding):
        win_base = None
        if cfg.sliding_window is not None and sliding:
            win_base = torch.where(
                seq_counts > 0, pos0 - cfg.sliding_window,
                torch.full_like(pos0, RAGGED_WIN_SENTINEL))
        return ragged_paged_attention(
            q, kv["k"][li], kv["v"][li], block_tables, seq_starts,
            seq_counts, seq_ctx, block_size=block_size, scale=scale,
            max_rows=max_rows, softcap=cfg.attn_logit_softcap or None,
            win_base=win_base)

    x = _embed(params, tokens, cfg)
    x = _run_layers(params, kv, x, positions, slots, cfg, attn)
    if sample_all_rows:
        # the row-sampled form (speculative spans): logits [TT, V] of every
        # row, sample_rows unread
        return _logits(params, x, cfg)
    return _logits(params, x[sample_rows.long()], cfg)
