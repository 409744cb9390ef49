"""Multi-head Latent Attention (MLA, deepseek_v2) in PyTorch over the paged
latent-KV pool.

Counterpart of ``dynamo_tpu.engine.models.mla`` (single device, bf16 or
f32 weights). The pool keeps one row per token, ``[c_kv (kv_lora_rank) |
k_pe (qk_rope_head_dim)]`` padded to a 128-lane multiple
(``latent_row_lanes``): ``{"kv": [L, NTOK, W]}``, block 0 the trash block,
or int8 rows in the sectioned in-row encoding
(``attention.quantize_kv_rows_sections``: one scale pair for c_kv, one for
k_pe). Each forward writes this step's rows IN PLACE before attention reads
the pool, as ``models/llama.py`` does.

Conventions (pinned by the JAX package against HF ``DeepseekV2Attention``):
interleaved rope (pairs (2i, 2i+1)), with yarn scaling folded into cos/sin;
softmax scale (qk_nope + qk_rope)^-0.5 (deepseek_v3 under yarn times
mscale^2); the cached latent is post-RMSNorm c_kv and post-rope k_pe; q is
a plain ``wq`` when q_lora_rank == 0 (the -Lite layout), else ``wq_a`` →
RMSNorm → ``wq_b``. The MLP is dense for the first ``first_k_dense``
layers and the deepseek MoE block after them: routed experts (v2 softmax
greedy or group-limited greedy, v3 ``sigmoid_noaux``) run dense over E
(``llama.run_experts_dense``), plus additive shared experts.

Attention by path:
- prefill: the JAX package's f32 einsum, k_nope and v expanded from the
  latent rows of the whole block table; no kernel (its memory grows with
  T x table: 16 heads x 4096 x 4096 f32 scores are 1.07 GB);
- decode, the ABSORBED form: q_lat = q_nope W_k (rank lanes), the query
  ``[q_lat | q_pe | 0]`` dots whole latent rows, and probs . c comes back
  through W_v. A bf16 pool takes ``attention.paged_attention`` as MQA with
  ``v_lanes`` = rank (the query rounded to the pool's dtype on every
  device, as in JAX); an int8 pool takes it with ``quant_sections`` on the
  card (a bf16 query, as JAX's TPU kernel takes) and elsewhere the gather
  and sectioned dequant with an f32 query (JAX's CPU path); ranks that are
  not 128-aligned (tiny test geometries) slice the output, or gather;
- ragged: the decode form per row through ``ragged_paged_attention`` with
  ``v_lanes`` (bf16 pools); int8 pools keep the gather, as the JAX package
  does until its sectioned ragged mode is wired.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..attention import (KV_SCALE_LANES, NEG_INF, dequant_kv_rows_sections,
                         flat_token_indices, paged_attention,
                         quantize_kv_rows_sections, ragged_paged_attention)
from ..config import ModelConfig
from ..quant import mm
from .llama import (_chunk_slots, _embed, _logits, rms_norm,
                    run_experts_dense, swiglu)

Params = Dict[str, torch.Tensor]
KVCache = Dict[str, torch.Tensor]       # {"kv": [L, NTOK, W]}


# ---------------------------------------------------------------------------
# Rope (interleaved) and the softmax scale
# ---------------------------------------------------------------------------


def get_mscale(scale: float, m: float = 1.0) -> float:
    """HF's yarn_get_mscale."""
    if scale <= 1:
        return 1.0
    return 0.1 * m * math.log(scale) + 1.0


def rope_params(cfg: ModelConfig) -> Tuple[np.ndarray, float]:
    """(inv_freq [d/2] f32, attention factor): default rope, or yarn (HF
    ``_compute_yarn_parameters``: the NTK interpolation / extrapolation
    blend over a linear ramp between the beta_fast / beta_slow correction
    dims, and the attention factor that multiplies cos/sin)."""
    d = cfg.qk_rope_head_dim
    base = cfg.rope_theta
    pos_freqs = base ** (np.arange(0, d, 2, dtype=np.float64) / d)
    inv = 1.0 / pos_freqs
    rs = cfg.rope_scaling
    if rs is None:
        return inv.astype(np.float32), 1.0
    if rs.rope_type != "yarn":
        raise ValueError(
            f"MLA rope_scaling type {rs.rope_type!r} is not implemented "
            f"(yarn is; remove rope_scaling for base-context models)")
    factor = rs.factor
    if rs.attention_factor:
        att = rs.attention_factor
    elif rs.mscale and rs.mscale_all_dim:
        att = get_mscale(factor, rs.mscale) / get_mscale(
            factor, rs.mscale_all_dim)
    else:
        att = get_mscale(factor)
    interp = 1.0 / (factor * pos_freqs)

    def corr_dim(num_rot):
        return (d * math.log(rs.original_max_position_embeddings
                             / (num_rot * 2 * math.pi))
                ) / (2 * math.log(base))

    low = max(math.floor(corr_dim(rs.beta_fast)), 0)
    high = min(math.ceil(corr_dim(rs.beta_slow)), d - 1)
    if low == high:
        high += 0.001                    # HF's singularity guard
    ramp = np.clip((np.arange(d // 2, dtype=np.float64) - low)
                   / (high - low), 0, 1)
    extrap = 1.0 - ramp
    inv_freq = interp * (1 - extrap) + inv * extrap
    return inv_freq.astype(np.float32), float(att)


def softmax_scale(cfg: ModelConfig) -> float:
    """(qk_nope + qk_rope)^-0.5; deepseek_v3 under yarn times
    mscale(factor, mscale_all_dim)^2 (v2 applies its factor through
    cos/sin instead)."""
    s = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    rs = cfg.rope_scaling
    if (cfg.model_type == "deepseek_v3" and rs is not None
            and rs.mscale_all_dim):
        m = get_mscale(rs.factor, rs.mscale_all_dim)
        s *= m * m
    return s


def apply_rope_interleaved(x: torch.Tensor, positions: torch.Tensor,
                           inv_freq: torch.Tensor,
                           scaling: float = 1.0) -> torch.Tensor:
    """x [T, ..., d] with the pair (2i, 2i+1) rotated by pos * inv_freq[i];
    positions [T]; ``scaling`` multiplies cos/sin (yarn)."""
    ang = positions[:, None].float() * inv_freq[None, :]        # [T, d/2]
    cos = torch.cos(ang) * scaling
    sin = torch.sin(ang) * scaling
    shape = x.shape
    xp = x.float().reshape(shape[:-1] + (shape[-1] // 2, 2))
    for _ in range(xp.dim() - 3):      # a head axis (q_pe), none for k_pe
        cos, sin = cos[:, None], sin[:, None]
    x0, x1 = xp[..., 0], xp[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.reshape(shape).to(x.dtype)


# rope_params per (rope fields, device), copied to the device once: a
# captured decode program cannot copy from pageable host memory
_ROPE: Dict[tuple, tuple] = {}


def _rope(cfg: ModelConfig, device: torch.device) -> tuple:
    key = (cfg.qk_rope_head_dim, cfg.rope_theta, repr(cfg.rope_scaling),
           str(device))
    r = _ROPE.get(key)
    if r is None:
        inv, att = rope_params(cfg)
        r = _ROPE[key] = (torch.from_numpy(inv).to(device), att)
    return r


# ---------------------------------------------------------------------------
# Parameters and pool
# ---------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Names and shapes of the MLA parameter tree (the JAX package's
    ``mla.param_shapes``): a MoE model stacks its first ``first_k_dense``
    layers' MLP as ``dense_*`` and the rest as ``moe_*`` / ``router`` /
    ``sh_*``."""
    L, D, H = cfg.num_layers, cfg.hidden_size, cfg.num_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    shapes: Dict[str, Tuple[int, ...]] = {
        "embed": (cfg.vocab_size, D),
        "final_norm": (D,),
        "layers.ln1": (L, D),
        "layers.ln2": (L, D),
        "layers.wkv_a": (L, D, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
        "layers.kv_norm": (L, cfg.kv_lora_rank),
        "layers.wkv_b": (L, cfg.kv_lora_rank,
                         H * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
        "layers.wo": (L, H * cfg.v_head_dim, D),
    }
    if cfg.num_experts > 0:
        k = cfg.first_k_dense
        Lm = L - k
        E, F_ = cfg.num_experts, cfg.intermediate_size
        if k > 0:
            Fd = cfg.dense_intermediate_size or F_
            shapes.update({
                "layers.dense_gate": (k, D, Fd),
                "layers.dense_up": (k, D, Fd),
                "layers.dense_down": (k, Fd, D),
            })
        shapes.update({
            "layers.router": (Lm, D, E),
            "layers.moe_gate": (Lm, E, D, F_),
            "layers.moe_up": (Lm, E, D, F_),
            "layers.moe_down": (Lm, E, F_, D),
        })
        if cfg.moe_routing == "sigmoid_noaux":
            shapes["layers.router_bias"] = (Lm, E)
        if cfg.shared_expert_size > 0:
            Fs = cfg.shared_expert_size
            shapes.update({
                "layers.sh_gate": (Lm, D, Fs),
                "layers.sh_up": (Lm, D, Fs),
                "layers.sh_down": (Lm, Fs, D),
            })
    else:
        shapes.update({
            "layers.gate": (L, D, cfg.intermediate_size),
            "layers.up": (L, D, cfg.intermediate_size),
            "layers.down": (L, cfg.intermediate_size, D),
        })
    if cfg.q_lora_rank > 0:
        shapes.update({
            "layers.wq_a": (L, D, cfg.q_lora_rank),
            "layers.q_a_norm": (L, cfg.q_lora_rank),
            "layers.wq_b": (L, cfg.q_lora_rank, H * qk),
        })
    else:
        shapes["layers.wq"] = (L, D, H * qk)
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (D, cfg.vocab_size)
    return shapes


def latent_row_lanes(cfg: ModelConfig, quantization: str = "none") -> int:
    """Pool row width: rank + rope (bf16) or rank + rope + KV_SCALE_LANES
    (int8), padded to a 128-lane multiple (640 / 768 at DeepSeek-V2's
    512 + 64). Pad lanes are written as zeros and never read as values."""
    C = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    if quantization == "int8":
        C = C + KV_SCALE_LANES
    return -(-C // 128) * 128


def init_kv_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                  device, dtype=torch.bfloat16,
                  quantization: str = "none") -> KVCache:
    """Zeroed latent pool ``{"kv": [L, num_blocks * block_size, W]}`` in
    ``dtype``, or int8 rows of the sectioned encoding with
    ``quantization="int8"`` (W: ``latent_row_lanes``)."""
    if quantization not in ("none", "int8"):
        raise ValueError(f"unknown kv quantization {quantization!r} "
                         f"(none|int8)")
    W = latent_row_lanes(cfg, quantization)
    return {"kv": torch.zeros(
        (cfg.num_layers, num_blocks * block_size, W),
        dtype=torch.int8 if quantization == "int8" else dtype,
        device=device)}


# ---------------------------------------------------------------------------
# The layer body
# ---------------------------------------------------------------------------

_DENSE_MLP = ("dense_gate", "dense_up", "dense_down")
_MOE_MLP = ("router", "router_bias", "moe_gate", "moe_up", "moe_down",
            "sh_gate", "sh_up", "sh_down")


def _layer_params(params: Params, li: int, cfg: ModelConfig) -> Params:
    """Layer ``li``'s weights by short name: the dense prefix's MLP as
    gate / up / down, a MoE layer's stacks at ``li - first_k_dense``."""
    k = cfg.first_k_dense if cfg.num_experts > 0 else cfg.num_layers
    lp = {}
    for name, w in params.items():
        if not name.startswith("layers."):
            continue
        n = name[len("layers."):]
        if n in _DENSE_MLP:
            if li < k:
                lp[n[len("dense_"):]] = w[li]
        elif n in _MOE_MLP:
            if li >= k:
                lp[n] = w[li - k]
        else:
            lp[n] = w[li]
    return lp


def _q_proj(lp: Params, hn: torch.Tensor, cfg: ModelConfig) -> tuple:
    """[N, D] → (q_nope [N, H, dn], q_pe [N, H, dr])."""
    dn = cfg.qk_nope_head_dim
    if cfg.q_lora_rank > 0:
        qa = rms_norm(mm(hn, lp["wq_a"]), lp["q_a_norm"], cfg.rms_norm_eps)
        q = mm(qa, lp["wq_b"])
    else:
        q = mm(hn, lp["wq"])
    q = q.reshape(hn.shape[0], cfg.num_heads, dn + cfg.qk_rope_head_dim)
    return q[..., :dn], q[..., dn:]


def _latent_rows(lp: Params, hn: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, inv: torch.Tensor,
                 att: float) -> torch.Tensor:
    """[N, D] → the pool rows [N, rank + rope]: post-norm c_kv, post-rope
    k_pe."""
    rank = cfg.kv_lora_rank
    ckv = mm(hn, lp["wkv_a"])
    c = rms_norm(ckv[..., :rank], lp["kv_norm"], cfg.rms_norm_eps)
    k_pe = apply_rope_interleaved(ckv[..., rank:], positions, inv, att)
    return torch.cat([c, k_pe], dim=-1)


def _moe_mlp(hn: torch.Tensor, lp: Params, cfg: ModelConfig) -> torch.Tensor:
    """The deepseek MoE block. v2: f32 softmax over all experts, greedy (or
    group-limited greedy: the topk_group groups of the best per-group max)
    top-k of the scores, no renormalization, times routed_scaling. v3
    (``moe_routing == "sigmoid_noaux"``): sigmoid scores; the choice uses
    scores + router_bias with groups ranked by the sum of their top-2
    (masked groups zeroed); the weights are the unbiased scores of the
    chosen experts, renormalized (+1e-20) when moe_norm_topk, times
    routed_scaling. Shared experts add a plain swiglu."""
    N, E = hn.shape[0], cfg.num_experts
    logits = hn.float() @ lp["router"].float()                   # [N, E]

    def group_mask(gscore):
        gidx = torch.topk(gscore, cfg.topk_group, dim=-1).indices
        return torch.zeros_like(gscore).scatter_(1, gidx, 1.0)   # [N, g]

    g = cfg.n_group
    if cfg.moe_routing == "sigmoid_noaux":
        scores = torch.sigmoid(logits)
        choice = scores + lp["router_bias"][None, :].float()
        if g > 1:
            top2 = torch.topk(choice.reshape(N, g, E // g), 2, dim=-1).values
            choice = (choice.reshape(N, g, E // g)
                      * group_mask(top2.sum(-1))[..., None]).reshape(N, E)
        top_idx = torch.topk(choice, cfg.num_experts_per_tok, dim=-1).indices
        top_w = torch.gather(scores, 1, top_idx)
        if cfg.moe_norm_topk:
            top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        scores = torch.softmax(logits, dim=-1)
        if g > 1:
            gmax = scores.reshape(N, g, E // g).amax(dim=-1)
            scores = (scores.reshape(N, g, E // g)
                      * group_mask(gmax)[..., None]).reshape(N, E)
        top_w, top_idx = torch.topk(scores, cfg.num_experts_per_tok, dim=-1)
    top_w = top_w * cfg.routed_scaling
    out = run_experts_dense(hn, lp["moe_gate"], lp["moe_up"], lp["moe_down"],
                            top_idx, top_w)
    if cfg.shared_expert_size > 0:
        out = out + swiglu(hn, lp["sh_gate"], lp["sh_up"], lp["sh_down"],
                           cfg.hidden_act)
    return out


def _run_layers(params: Params, kv: KVCache, x: torch.Tensor,
                positions: torch.Tensor, slots: torch.Tensor,
                cfg: ModelConfig, attn_fn) -> torch.Tensor:
    """The stack: per layer the q projection, the latent rows written into
    the pool at ``slots`` (int8: the sectioned encoding, so this token sees
    the quantized row later steps see), ``attn_fn(q_nope, q_pe, pool_l,
    lp)`` → [N, H * v_head_dim], the wo residual and the MLP (dense, or the
    MoE block past first_k_dense). Returns the final-normed states."""
    pool = kv["kv"]
    inv, att = _rope(cfg, x.device)
    sections = (cfg.kv_lora_rank, cfg.qk_rope_head_dim)
    k_dense = cfg.first_k_dense if cfg.num_experts > 0 else cfg.num_layers
    eps = cfg.rms_norm_eps
    for li in range(cfg.num_layers):
        lp = _layer_params(params, li, cfg)
        hn = rms_norm(x, lp["ln1"], eps)
        q_nope, q_pe = _q_proj(lp, hn, cfg)
        q_pe = apply_rope_interleaved(q_pe, positions, inv, att)
        rows = _latent_rows(lp, hn, positions, cfg, inv, att)
        enc = (quantize_kv_rows_sections(rows, sections)
               if pool.dtype == torch.int8 else rows.to(pool.dtype))
        enc = F.pad(enc, (0, pool.shape[2] - enc.shape[1]))
        pool[li].index_copy_(0, slots, enc)
        x = x + mm(attn_fn(q_nope, q_pe, pool[li], lp), lp["wo"])
        hn2 = rms_norm(x, lp["ln2"], eps)
        if li < k_dense:
            x = x + swiglu(hn2, lp["gate"], lp["up"], lp["down"],
                           cfg.hidden_act)
        else:
            x = x + _moe_mlp(hn2, lp, cfg)
    return rms_norm(x, params["final_norm"], eps)


def _split_wkv_b(lp: Params, cfg: ModelConfig) -> tuple:
    """wkv_b [rank, H * (dn + dv)] → (w_k [H, rank, dn], w_v [H, rank,
    dv]) in f32."""
    H, dn = cfg.num_heads, cfg.qk_nope_head_dim
    w = lp["wkv_b"].float().reshape(cfg.kv_lora_rank, H,
                                    dn + cfg.v_head_dim)
    return w[..., :dn].permute(1, 0, 2), w[..., dn:].permute(1, 0, 2)


def _latent_query(q_lat: torch.Tensor, q_pe: torch.Tensor, width: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """[q_lat | q_pe | 0] to ``width`` lanes in ``dtype``."""
    q = torch.cat([q_lat, q_pe.float()], dim=-1)
    return F.pad(q, (0, width - q.shape[-1])).to(dtype)


def _gather_attention(q_lat: torch.Tensor, q_pe: torch.Tensor,
                      pool_l: torch.Tensor, tables: torch.Tensor,
                      seq_lens: torch.Tensor, cfg: ModelConfig,
                      block_size: int, scale: float) -> torch.Tensor:
    """The absorbed attention of rows [N, H] over an int8 pool by gather:
    each row's table dequantized in f32 (sectioned), scores of the f32
    query, masked to ``seq_lens`` → probs . c [N, H, rank] f32."""
    rank, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    idx = flat_token_indices(tables, block_size)
    T = idx.shape[1]
    rows = dequant_kv_rows_sections(pool_l[idx], (rank, dr), torch.float32)
    c, k_pe = rows[..., :rank], rows[..., rank:rank + dr]
    scores = (torch.einsum("bhr,btr->bht", q_lat, c)
              + torch.einsum("bhd,btd->bht", q_pe.float(), k_pe)) * scale
    mask = torch.arange(T, device=q_lat.device)[None, :] < seq_lens[:, None]
    scores = scores.masked_fill(~mask[:, None, :], NEG_INF)
    return torch.einsum("bht,btr->bhr", torch.softmax(scores, dim=-1), c)


# ---------------------------------------------------------------------------
# Forward passes (the contracts of models/llama.py)
# ---------------------------------------------------------------------------


def prefill_forward(params: Params, kv: KVCache, tokens: torch.Tensor,
                    block_table: torch.Tensor, start_pos: int, true_len: int,
                    cfg: ModelConfig, block_size: int) -> torch.Tensor:
    """Single-sequence (chunk) prefill, ``llama.prefill_forward``'s
    contract: writes the chunk's rows, then attends over the whole block
    table with k_nope and v expanded from the latent rows (f32). Returns
    the last valid token's logits [V] f32."""
    T = tokens.shape[0]
    dev = tokens.device
    H, rank, dr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    scale = softmax_scale(cfg)
    positions = start_pos + torch.arange(T, device=dev)
    slots = _chunk_slots(block_table, positions, true_len, block_size)
    seq_len = start_pos + true_len
    idx = flat_token_indices(block_table[None, :], block_size)[0]   # [S]
    kpos = torch.arange(idx.shape[0], device=dev)
    mask = (kpos[None, :] <= positions[:, None]) & (kpos[None, :] < seq_len)

    def attn(q_nope, q_pe, pool_l, lp):
        rows = pool_l[idx]                                        # [S, W]
        if rows.dtype == torch.int8:
            rows = dequant_kv_rows_sections(rows, (rank, dr), torch.float32)
        c, k_pe = rows[..., :rank].float(), rows[..., rank:rank + dr].float()
        w_k, w_v = _split_wkv_b(lp, cfg)
        k_nope = torch.einsum("sr,hrd->hsd", c, w_k)
        v = torch.einsum("sr,hrd->hsd", c, w_v)
        scores = (torch.einsum("thd,hsd->hts", q_nope.float(), k_nope)
                  + torch.einsum("thd,sd->hts", q_pe.float(), k_pe)) * scale
        scores = scores.masked_fill(~mask[None], NEG_INF)
        out = torch.einsum("hts,hsd->thd", torch.softmax(scores, dim=-1), v)
        return out.reshape(T, H * cfg.v_head_dim).to(q_nope.dtype)

    x = _embed(params, tokens, cfg)
    x = _run_layers(params, kv, x, positions, slots, cfg, attn)
    return _logits(params, x[max(true_len - 1, 0)], cfg)


def decode_forward(params: Params, kv: KVCache, tokens: torch.Tensor,
                   positions: torch.Tensor, block_tables: torch.Tensor,
                   cfg: ModelConfig, block_size: int) -> torch.Tensor:
    """Batched single-token decode step, ``llama.decode_forward``'s
    contract, in the absorbed form (module docstring). Returns logits
    [B, V] f32."""
    B = tokens.shape[0]
    dev = tokens.device
    H, rank, dr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    scale = softmax_scale(cfg)
    pos = positions.long()
    slots = (block_tables.long()[torch.arange(B, device=dev),
                                 pos // block_size]
             * block_size + pos % block_size)
    seq_lens = (positions + 1).to(torch.int32)
    vl = rank if rank % 128 == 0 else None

    def attn(q_nope, q_pe, pool_l, lp):
        w_k, w_v = _split_wkv_b(lp, cfg)
        q_lat = torch.einsum("bhd,hrd->bhr", q_nope.float(), w_k)
        if pool_l.dtype != torch.int8:
            # the query rounds to the pool's dtype on every device, as in
            # JAX (its kernel dots in the pool dtype)
            qc = _latent_query(q_lat, q_pe, pool_l.shape[-1], pool_l.dtype)
            ctx = paged_attention(qc, pool_l, pool_l, block_tables, seq_lens,
                                  block_size=block_size, scale=scale,
                                  v_lanes=vl)[..., :rank].float()
        elif pool_l.is_cuda:
            # the sectioned kernel mode takes a bf16 query (JAX's TPU path);
            # a rank it does not cover (not 128-aligned) raises there
            qc = _latent_query(q_lat, q_pe, -(-(rank + dr) // 128) * 128,
                               torch.bfloat16)
            ctx = paged_attention(qc, pool_l, pool_l, block_tables, seq_lens,
                                  block_size=block_size, scale=scale,
                                  v_lanes=rank,
                                  quant_sections=(rank, dr)).float()
        else:
            ctx = _gather_attention(q_lat, q_pe, pool_l, block_tables,
                                    seq_lens, cfg, block_size, scale)
        out = torch.einsum("bhr,hrd->bhd", ctx, w_v)
        return out.reshape(B, H * cfg.v_head_dim).to(q_nope.dtype)

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
    """Ragged mixed prefill+decode step, ``llama.ragged_forward``'s
    contract: every row is the decode form over its sequence's table. A
    bf16 pool attends through ``ragged_paged_attention`` with ``v_lanes``
    (K4-MLA on the card); an int8 pool gathers per row (the JAX package
    leaves its sectioned ragged kernel mode unwired). Returns logits [S,
    V] f32, or [TT, V] of every row with ``sample_all_rows``."""
    TT = tokens.shape[0]
    dev = tokens.device
    H, rank = cfg.num_heads, cfg.kv_lora_rank
    scale = softmax_scale(cfg)
    pos = positions.long()
    row_tables = block_tables[row_slot.long()]                    # [TT, M]
    slots = (row_tables.long()[torch.arange(TT, device=dev),
                               pos // block_size]
             * block_size + pos % block_size)
    last_rows = torch.clamp(seq_starts.long()
                            + torch.clamp(seq_counts.long() - 1, min=0),
                            max=TT - 1)
    seq_ctx = torch.where(seq_counts > 0, positions[last_rows] + 1,
                          torch.zeros_like(seq_counts)).to(torch.int32)
    vl = rank if rank % 128 == 0 else None

    def attn(q_nope, q_pe, pool_l, lp):
        w_k, w_v = _split_wkv_b(lp, cfg)
        q_lat = torch.einsum("bhd,hrd->bhr", q_nope.float(), w_k)
        if pool_l.dtype != torch.int8:
            qc = _latent_query(q_lat, q_pe, pool_l.shape[-1], pool_l.dtype)
            ctx = ragged_paged_attention(
                qc, pool_l, pool_l, block_tables, seq_starts, seq_counts,
                seq_ctx, block_size=block_size, scale=scale,
                max_rows=max_rows, v_lanes=vl)[..., :rank].float()
        else:
            ctx = _gather_attention(q_lat, q_pe, pool_l, row_tables,
                                    positions + 1, cfg, block_size, scale)
        out = torch.einsum("bhr,hrd->bhd", ctx, w_v)
        return out.reshape(TT, H * cfg.v_head_dim).to(q_nope.dtype)

    x = _embed(params, tokens, cfg)
    x = _run_layers(params, kv, x, positions, slots, cfg, attn)
    if sample_all_rows:
        # the row-sampled form (speculative spans): logits [TT, V] of every
        # row, sample_rows unread
        return _logits(params, x, cfg)
    return _logits(params, x[sample_rows.long()], cfg)
