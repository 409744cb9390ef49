"""Attention for the PyTorch engine: causal prefill and paged decode.

Counterpart of ``dynamo_tpu.engine.attention``. The KV pool keeps the
JAX package's BLOCK-MAJOR layout: per layer ``[NTOK, KVH*Dh]`` where
``NTOK = num_blocks * block_size`` and a token's row holds every KV head
side by side.

Each kernel has a plain PyTorch version of the same function in this
module (``flash_prefill_ref``, ``paged_attention_ref``). The public
functions dispatch on the tensor's device alone: a CPU tensor takes the
plain version, a CUDA tensor launches the hand-written kernel
(``engine/kernels.py``, sources under ``csrc/``) or raises. There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def softcap_scores(scores: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2 logit soft-capping: cap·tanh(x/cap)."""
    return cap * torch.tanh(scores / cap)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: float, start_pos: int, seq_len: int,
                      sliding: bool = False, window: Optional[int] = None,
                      softcap: Optional[float] = None) -> torch.Tensor:
    """Plain version of ``flash_prefill``: the dense-score einsum of the
    llama prefill path (scores in the input dtype, softmax in f32, probs
    cast back to v's dtype). q [T, H, Dh] at positions start_pos + t;
    k/v [S, KVH, Dh] at positions 0..S; keys >= seq_len are masked."""
    T, H, Dh = q.shape
    S, KVH, _ = k.shape
    g = H // KVH
    qg = q.reshape(T, KVH, g, Dh)
    scores = torch.einsum("tkgd,skd->kgts", qg, k).float() * scale
    if softcap:
        scores = softcap_scores(scores, softcap)
    positions = start_pos + torch.arange(T, device=q.device)
    kv_pos = torch.arange(S, device=q.device)
    mask = (kv_pos[None, :] <= positions[:, None]) & (kv_pos[None, :] < seq_len)
    if window is not None and sliding:
        mask = mask & (kv_pos[None, :] > (positions - window)[:, None])
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("kgts,skd->tkgd", probs, v).reshape(T, H, Dh)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, start_pos: int, seq_len: int,
                  sliding: bool = False, window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """Causal attention for one prefill chunk (contract of
    ``dynamo_tpu.engine.attention.flash_prefill``). CPU tensors take the
    plain version; CUDA tensors run ``csrc/flash_prefill.cu``, which
    implements the global-window, uncapped case and refuses the rest."""
    if not q.is_cuda:
        return flash_prefill_ref(q, k, v, scale=scale, start_pos=start_pos,
                                 seq_len=seq_len, sliding=sliding,
                                 window=window, softcap=softcap)
    if softcap or (window is not None and sliding):
        raise NotImplementedError(
            "the CUDA flash_prefill kernel implements neither logit "
            "soft-capping nor sliding windows")
    from .kernels import flash_prefill_cuda
    return flash_prefill_cuda(q, k, v, scale=scale, start_pos=start_pos,
                              seq_len=seq_len)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def flat_token_indices(block_tables: torch.Tensor,
                       block_size: int) -> torch.Tensor:
    """[B, M] block ids → [B, M*BS] flat token-pool indices."""
    B, M = block_tables.shape
    offs = torch.arange(block_size, device=block_tables.device)
    return (block_tables.long()[:, :, None] * block_size
            + offs[None, None, :]).reshape(B, M * block_size)


def paged_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, block_tables: torch.Tensor,
                        seq_lens: torch.Tensor, *, block_size: int,
                        scale: float, softcap: Optional[float] = None,
                        win_lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``paged_attention``: the gather form of
    ``dynamo_tpu.engine.attention.paged_attention_xla``. q: [B, H, Dh];
    k_cache/v_cache: [NTOK, KVH*Dh]; block_tables: [B, M]; seq_lens: [B]
    (kv length incl. the current token; 0 gives zeros); win_lo: [B] or
    None (keys at or below it are masked). Returns [B, H, Dh]."""
    B, H, Dh = q.shape
    KVH = k_cache.shape[1] // Dh
    g = H // KVH
    idx = flat_token_indices(block_tables, block_size)          # [B, T]
    T = idx.shape[1]
    k = k_cache[idx].reshape(B, T, KVH, Dh)
    v = v_cache[idx].reshape(B, T, KVH, Dh)
    qg = q.reshape(B, KVH, g, Dh)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k).float() * scale
    if softcap:
        scores = softcap_scores(scores, softcap)
    kv_pos = torch.arange(T, device=q.device)[None, :]
    mask = kv_pos < seq_lens.long()[:, None]                      # [B, T]
    if win_lo is not None:
        mask = mask & (kv_pos > win_lo.long()[:, None])
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v).reshape(B, H, Dh)
    # a zero-length (padded) slot gets zeros, as from the kernels
    return out * (seq_lens > 0).to(out.dtype)[:, None, None]


def paged_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor, *, block_size: int, scale: float,
                    softcap: Optional[float] = None,
                    win_lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention over the paged pool (contract of
    ``dynamo_tpu.engine.attention.paged_attention``). CPU tensors take the
    plain version; CUDA tensors run ``csrc/paged_attention.cu``, which
    implements the global-window, uncapped bf16 case and refuses the
    rest."""
    if not q.is_cuda:
        return paged_attention_ref(q, k_cache, v_cache, block_tables,
                                   seq_lens, block_size=block_size,
                                   scale=scale, softcap=softcap,
                                   win_lo=win_lo)
    if softcap or win_lo is not None:
        raise NotImplementedError(
            "the CUDA paged_attention kernel implements neither logit "
            "soft-capping nor sliding windows")
    from .kernels import paged_attention_cuda
    return paged_attention_cuda(q, k_cache, v_cache, block_tables, seq_lens,
                                block_size=block_size, scale=scale)
