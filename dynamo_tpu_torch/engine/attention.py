"""Attention for the PyTorch engine: causal prefill, its partial form for
ring attention, paged decode and ragged mixed prefill+decode.

Counterpart of ``dynamo_tpu.engine.attention``. The KV pool keeps the
JAX package's BLOCK-MAJOR layout: per layer ``[NTOK, KVH*Dh]`` where
``NTOK = num_blocks * block_size`` and a token's row holds every KV head
side by side. An int8 pool's row is ``[KVH*Dh + KV_SCALE_LANES]`` int8:
the values, then the row's scale as an (exponent, mantissa) byte pair,
then pad lanes, in the JAX package's exact encoding (``quantize_kv_rows``).

Each kernel has a plain PyTorch version of the same function in this
module (``flash_prefill_ref``, ``flash_prefill_partial_ref``,
``paged_attention_ref``, ``ragged_paged_attention_ref``), and the split
arithmetic of K3 and K4 (``paged_attention_partials_ref``,
``ragged_attention_partials_ref``, ``merge_split_partials``) is kept in
plain form for the tests. The public
functions dispatch on the tensor's device alone: a CPU tensor takes the
plain version, a CUDA tensor launches the hand-written kernel
(``engine/kernels.py``, sources under ``csrc/``) or raises. There is no
fallback from the kernel to the plain version. Both take every mode a
gemma2 model needs (logit soft-capping, sliding windows, head dim 256),
and K3 and K4 the MLA modes of the JAX kernels: ``v_lanes`` (one KV head
whose row is both K and V, V its first ``v_lanes`` lanes) and
``quant_sections`` (int8 latent rows with one in-row scale pair per
section, ``quantize_kv_rows_sections``), which run the latent kernels of
``csrc/latent_attention.cu`` on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30

# int8 KV rows carry their per-token scale in-row: exponent at lane C,
# mantissa at C+1 (scale = 2^e * (1 + m/256)), padded to one 128-lane group
# (a TPU tiling rule the port keeps so pool bytes equal the JAX package's)
KV_SCALE_LANES = 128


def kv_value_lanes(k_cache: torch.Tensor) -> int:
    """C (= KVH*Dh value lanes) of a pool row, without the in-row scale
    group of an int8 pool."""
    lanes = k_cache.shape[-1]
    return lanes - KV_SCALE_LANES if k_cache.dtype == torch.int8 else lanes


def _encode_scale(absmax: torch.Tensor):
    """absmax → (e, m 0..255, scale f32) with scale = 2^e * (1 + m/256)
    ~ absmax/127; the JAX package's formula, step for step."""
    target = torch.clamp(absmax, min=1e-30) / 127.0
    e = torch.floor(torch.log2(target))
    m = torch.clamp(torch.round((target / torch.exp2(e) - 1.0) * 256.0),
                    0, 255)
    return e, m, torch.exp2(e) * (1.0 + m / 256.0)


def _decode_scale(e_lane: torch.Tensor, m_lane: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_encode_scale`` from the stored int8 lanes (m is
    stored uint8-wrapped)."""
    e = e_lane.float()
    m = (m_lane.to(torch.int32) & 0xFF).float()
    return torch.exp2(e) * (1.0 + m / 256.0)


def quantize_kv_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row int8 with in-row scale lanes: x ``[N, C]`` → int8
    ``[N, C + KV_SCALE_LANES]`` (the JAX package's ``groups=1``
    encoding)."""
    N, C = x.shape
    xf = x.float()
    e, m, scale = _encode_scale(xf.abs().amax(dim=1))
    q = torch.clamp(torch.round(xf / scale[:, None]), -127, 127)
    rows = torch.zeros((N, C + KV_SCALE_LANES), dtype=torch.int8,
                       device=x.device)
    rows[:, :C] = q.to(torch.int8)
    rows[:, C] = torch.clamp(e, -127, 127).to(torch.int8)
    rows[:, C + 1] = m.to(torch.uint8).view(torch.int8)
    return rows


def dequant_kv_rows(rows: torch.Tensor, C: int,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``quantize_kv_rows`` for gathered rows
    ``[..., C + KV_SCALE_LANES]``."""
    if rows.shape[-1] != C + KV_SCALE_LANES:
        raise ValueError(f"int8 pool row width {rows.shape[-1]} is not the "
                         f"value lanes C={C} plus one {KV_SCALE_LANES}-lane "
                         f"scale group")
    scale = _decode_scale(rows[..., C], rows[..., C + 1])
    return (rows[..., :C].float() * scale[..., None]).to(out_dtype)


def quantize_kv_rows_sections(x: torch.Tensor,
                              sections: tuple) -> torch.Tensor:
    """Per-row int8 with one (e, m) scale pair per section, all in the one
    KV_SCALE_LANES group: x ``[N, C]`` → int8 ``[N, C + KV_SCALE_LANES]``,
    section i's scale at lanes C + 2i, C + 2i + 1 (the JAX package's
    encoding of MLA latent rows, byte for byte: the RMS-normed c_kv and the
    unnormalized k_pe do not share an absmax)."""
    N, C = x.shape
    if sum(sections) != C or 2 * len(sections) > KV_SCALE_LANES:
        raise ValueError(f"sections {sections} do not cover {C} lanes")
    xf = x.float()
    rows = torch.zeros((N, C + KV_SCALE_LANES), dtype=torch.int8,
                       device=x.device)
    off = 0
    for i, w in enumerate(sections):
        seg = xf[:, off:off + w]
        e, m, scale = _encode_scale(seg.abs().amax(dim=1))
        rows[:, off:off + w] = torch.clamp(
            torch.round(seg / scale[:, None]), -127, 127).to(torch.int8)
        rows[:, C + 2 * i] = torch.clamp(e, -127, 127).to(torch.int8)
        rows[:, C + 2 * i + 1] = m.to(torch.uint8).view(torch.int8)
        off += w
    return rows


def dequant_kv_rows_sections(rows: torch.Tensor, sections: tuple,
                             out_dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``quantize_kv_rows_sections`` for gathered rows
    ``[..., sum(sections) + KV_SCALE_LANES]`` (lanes past that are
    ignored)."""
    C = sum(sections)
    outs, off = [], 0
    for i, w in enumerate(sections):
        scale = _decode_scale(rows[..., C + 2 * i], rows[..., C + 2 * i + 1])
        outs.append(rows[..., off:off + w].float() * scale[..., None])
        off += w
    return torch.cat(outs, dim=-1).to(out_dtype)


def check_latent_modes(q: torch.Tensor, k_cache: torch.Tensor,
                       v_lanes: Optional[int],
                       quant_sections: Optional[tuple]) -> None:
    """The JAX kernels' rule for the MLA modes (``paged_attention_pallas``
    and ``ragged_paged_attention_pallas``): ``v_lanes`` only over one KV
    head (the query as wide as the row's value lanes) at a 128-aligned
    width within it; ``quant_sections`` only over an int8 pool with
    ``v_lanes``, its row pad128(sum + KV_SCALE_LANES) and the query
    pad128(sum) wide; ``v_lanes`` over a single-scale int8 pool is
    refused. Raises ValueError."""
    Dh = q.shape[-1]
    quantized = k_cache.dtype == torch.int8
    if quant_sections is not None:
        if not quantized or v_lanes is None:
            raise ValueError("quant_sections needs an int8 pool and "
                             "v_lanes (the MLA sectioned layout)")
        C = Dh          # dequant gives query-width rows (KVH == 1)
    else:
        C = kv_value_lanes(k_cache)
    KVH = C // Dh
    if v_lanes is not None and (KVH != 1 or v_lanes % 128 != 0
                                or v_lanes > C):
        raise ValueError(
            f"v_lanes={v_lanes} needs an MQA-shaped pool (KVH == 1, got "
            f"{KVH}) and a 128-aligned width <= {C}")
    if quant_sections is not None:
        Cs = sum(quant_sections)
        if (-(-(Cs + KV_SCALE_LANES) // 128) * 128 != k_cache.shape[-1]
                or -(-Cs // 128) * 128 != Dh):
            raise ValueError(
                f"quant_sections {quant_sections} (sum {Cs}) does not "
                f"match row width {k_cache.shape[-1]} = pad128(sum + "
                f"{KV_SCALE_LANES}) / query width {Dh} = pad128(sum)")
    if v_lanes is not None and quantized and quant_sections is None:
        raise ValueError("v_lanes on a single-scale int8 pool is not "
                         "supported (sectioned MLA pools pass "
                         "quant_sections)")


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
    ``dynamo_tpu.engine.attention.flash_prefill``; ``window`` applies where
    ``sliding`` is set, ``softcap`` None or 0 is off). CPU tensors take the
    plain version; CUDA tensors run ``csrc/flash_prefill.cu``."""
    if not q.is_cuda:
        return flash_prefill_ref(q, k, v, scale=scale, start_pos=start_pos,
                                 seq_len=seq_len, sliding=sliding,
                                 window=window, softcap=softcap)
    from .kernels import flash_prefill_cuda
    return flash_prefill_cuda(
        q, k, v, scale=scale, start_pos=start_pos, seq_len=seq_len,
        window=window if window is not None and sliding else 0,
        softcap=softcap or 0.0)


def flash_prefill_partial_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, scale: float,
                              start_pos: int, seq_len: int) -> tuple:
    """Plain version of ``flash_prefill_partial``: the dense-score formula
    with the JAX partial kernel's arithmetic. Scores are taken in f32 (m
    and l are compared as numbers, so they are not rounded to q's dtype
    first), masked to NEG_INF, m is their row max, p = exp(s - m) is
    zeroed on rows whose m is still NEG_INF (a row that sees no key), l
    is p's row sum, and acc is p cast to v's dtype times v, summed in
    f32. Returns (acc [T, H, Dh], m [T, H], l [T, H]), all f32."""
    T, H, Dh = q.shape
    S, KVH, _ = k.shape
    g = H // KVH
    qg = q.reshape(T, KVH, g, Dh).float()
    s = torch.einsum("tkgd,skd->kgts", qg, k.float()) * scale
    positions = start_pos + torch.arange(T, device=q.device)
    kv_pos = torch.arange(S, device=q.device)
    mask = (kv_pos[None, :] <= positions[:, None]) & (kv_pos[None, :] < seq_len)
    s = s.masked_fill(~mask[None, None], NEG_INF)
    m = s.amax(dim=-1)                                        # [KVH, g, T]
    p = torch.exp(s - m[..., None])
    p = torch.where((m > NEG_INF / 2)[..., None], p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    acc = torch.einsum("kgts,skd->tkgd", p.to(v.dtype).float(), v.float())
    return (acc.reshape(T, H, Dh), m.permute(2, 0, 1).reshape(T, H),
            l.permute(2, 0, 1).reshape(T, H))


def flash_prefill_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, start_pos: int,
                          seq_len: int) -> tuple:
    """One ring hop of sequence-parallel attention (contract of
    ``dynamo_tpu.engine.attention.flash_prefill_partial``): q [T, H, Dh]
    at positions start_pos + t (start_pos may be NEGATIVE: those queries
    come before this KV chunk and see nothing), k/v [S, KVH, Dh] at
    positions 0..seq_len. Returns the UNNORMALIZED (acc [T, H, Dh], m
    [T, H], l [T, H]) in f32; a row that sees no key gets acc = 0, l = 0,
    m = NEG_INF. CPU tensors take the plain version; CUDA tensors run the
    partial mode of ``csrc/flash_prefill.cu`` (K2)."""
    if not q.is_cuda:
        return flash_prefill_partial_ref(q, k, v, scale=scale,
                                         start_pos=start_pos, seq_len=seq_len)
    from .kernels import flash_prefill_partial_cuda
    return flash_prefill_partial_cuda(q, k, v, scale=scale,
                                      start_pos=start_pos, seq_len=seq_len)


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


def _latent_keys(k_cache: torch.Tensor, idx: torch.Tensor, width: int,
                 quant_sections: tuple, dtype: torch.dtype) -> torch.Tensor:
    """The rows ``idx`` of a sectioned int8 pool dequantized to ``dtype``,
    zero lanes after the sections up to ``width`` (the query's)."""
    k = dequant_kv_rows_sections(k_cache[idx], quant_sections, dtype)
    return torch.nn.functional.pad(k, (0, width - k.shape[-1]))


def paged_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, block_tables: torch.Tensor,
                        seq_lens: torch.Tensor, *, block_size: int,
                        scale: float, softcap: Optional[float] = None,
                        win_lo: Optional[torch.Tensor] = None,
                        v_lanes: Optional[int] = None,
                        quant_sections: Optional[tuple] = None
                        ) -> torch.Tensor:
    """Plain version of ``paged_attention``: the gather form of
    ``dynamo_tpu.engine.attention.paged_attention_xla``. q: [B, H, Dh];
    k_cache/v_cache: [NTOK, KVH*Dh]; block_tables: [B, M]; seq_lens: [B]
    (kv length incl. the current token; 0 gives zeros); win_lo: [B] or
    None (keys at or below it are masked). An int8 pool
    ([NTOK, KVH*Dh + KV_SCALE_LANES]) is dequantized to q's dtype after
    the gather. ``v_lanes``: V is the first v_lanes lanes of each K row
    (v_cache is not read); ``quant_sections``: the int8 rows are sectioned
    (``dequant_kv_rows_sections``, zero lanes up to Dh). Returns [B, H,
    Dh], or [B, H, v_lanes]."""
    B, H, Dh = q.shape
    C = Dh if quant_sections is not None else kv_value_lanes(k_cache)
    KVH = C // Dh
    g = H // KVH
    idx = flat_token_indices(block_tables, block_size)          # [B, T]
    T = idx.shape[1]
    if quant_sections is not None:
        k = _latent_keys(k_cache, idx, Dh, quant_sections, q.dtype)
    else:
        k = k_cache[idx]
        if k_cache.dtype == torch.int8:
            k = dequant_kv_rows(k, C, q.dtype)
    if v_lanes is not None:
        v, Dv = k[..., :v_lanes], v_lanes
    else:
        v, Dv = v_cache[idx], Dh
        if v_cache.dtype == torch.int8:
            v = dequant_kv_rows(v, C, q.dtype)
    k = k.reshape(B, T, KVH, Dh)
    v = v.reshape(B, T, KVH, Dv)
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
    out = torch.einsum("bkgt,btkd->bkgd", probs, v).reshape(B, H, Dv)
    # a zero-length (padded) slot gets zeros, as from the kernels
    return out * (seq_lens > 0).to(out.dtype)[:, None, None]


# K3 cuts each sequence into chunks of this many keys (rounded up to whole
# blocks), one CTA per chunk and KV head, and merges the chunks' partial
# softmaxes (csrc/paged_attention.cu, kChunkTarget); K4 cuts each row
# tile's keys the same way (csrc/ragged_paged_attention.cu)
DECODE_CHUNK_TOKENS = 128


def decode_split_plan(max_blocks: int, block_size: int) -> tuple:
    """(chunk tokens, splits) of K3 for a table of ``max_blocks`` entries:
    the kernel's plan, sized from the table width alone (seq_lens live on
    the device)."""
    chunk = block_size * -(-DECODE_CHUNK_TOKENS // block_size)
    return chunk, -(-(max_blocks * block_size) // chunk)


# The latent kernels (csrc/latent_attention.cu) split a row tile's keys in
# whole LATENT_KEY_TILE-key tiles, spread evenly from the keys the tile
# sees (on the device). K4-MLA: LATENT_TILE_ROWS consecutive rows of one
# sequence a CTA, all their heads, so that every key tile feeds them all;
# the LATENT_SPLITS CTAs of one thread-block cluster are a tile's splits
# and merge in the cluster's shared memory. K3-MLA: one decode row in two
# key streams a CTA (two splits), LATENT_DECODE_CLUSTER CTAs a cluster and
# latent_decode_clusters(B) clusters a row, so that a call keeps about
# LATENT_DECODE_CTAS CTAs busy whatever its batch; the last cluster of a
# row to finish merges the clusters' partials
LATENT_TILE_ROWS = 4
LATENT_SPLITS = 8
LATENT_DECODE_CLUSTER = 2
LATENT_DECODE_CTAS = 120
LATENT_KEY_TILE = 32


def latent_decode_clusters(B: int) -> int:
    """K3-MLA's clusters a row at batch ``B``: about LATENT_DECODE_CTAS
    CTAs in all, 1 to 16 a row (a function of the batch alone, so that a
    CUDA graph can capture the launch)."""
    return max(1, min(16, LATENT_DECODE_CTAS // (LATENT_DECODE_CLUSTER * B)))


def latent_decode_splits(B: int) -> int:
    """K3-MLA's splits a row at batch ``B``: two key streams in each CTA of
    each of its clusters."""
    return 2 * LATENT_DECODE_CLUSTER * latent_decode_clusters(B)


def latent_split_plan(n_keys: int, splits: int = LATENT_SPLITS) -> tuple:
    """(chunk in keys, live splits) of a latent row tile that sees
    ``n_keys`` keys: its LATENT_KEY_TILE-key tiles spread over ``splits``
    splits, so at K4-MLA's 8 a 129-key row is five one-tile splits and a
    4096-key row eight of 512 keys; 0 keys: no live split."""
    tiles = max(-(-n_keys // LATENT_KEY_TILE), 1)
    chunk = LATENT_KEY_TILE * -(-tiles // splits)
    return chunk, -(-max(n_keys, 0) // chunk)


def split_scratch_views(scratch: torch.Tensor, B: int, KVH: int, S: int,
                        g: int, Dh: int) -> tuple:
    """K3's f32 scratch as (m [B, KVH, S, g], l [B, KVH, S, g], acc [B, KVH,
    S, g, Dh]): acc first, then m, then l, as the kernel lays them out."""
    n = B * KVH * S * g
    acc = scratch[:n * Dh].view(B, KVH, S, g, Dh)
    m = scratch[n * Dh:n * (Dh + 1)].view(B, KVH, S, g)
    l = scratch[n * (Dh + 1):n * (Dh + 2)].view(B, KVH, S, g)
    return m, l, acc


def paged_attention_partials_ref(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 seq_lens: torch.Tensor, *, block_size: int,
                                 scale: float,
                                 chunk: Optional[int] = None,
                                 v_lanes: Optional[int] = None,
                                 quant_sections: Optional[tuple] = None,
                                 splits: Optional[int] = None) -> tuple:
    """The split form of ``paged_attention_ref`` with K3's arithmetic, for
    the tests (``merge_split_partials`` completes it): each (sequence, KV
    head, split of ``decode_split_plan``) gives f32 (m, l, acc) over its
    chunk of keys, with scores in the exp2
    domain (s = scale·log2(e)·q·k, an int8 key's scale taken out of the
    dot), m their max, p = exp2(s - m), l = Σp and acc = Σ p·v (an int8
    value's scale folded into p). A split that sees no key gives (-inf, 0,
    0). ``chunk``: keys per split in place of the plan's; the split axis
    keeps the plan's length, the splits past the table empty.
    ``v_lanes`` / ``quant_sections``: the MLA modes of
    ``paged_attention_ref`` (a sectioned row dequantized in f32, exact,
    before the dot), cut as K3-MLA cuts them: ``latent_decode_splits(B)``
    splits, each row's chunk from the keys it sees (``latent_split_plan``),
    unless ``chunk`` is given (then LATENT_SPLITS splits, K4-MLA's, or
    ``splits``). Returns (m [B, KVH, S, g], l [B, KVH, S, g], acc [B, KVH,
    S, g, Dv]), Dv = v_lanes or Dh."""
    B, H, Dh = q.shape
    C = Dh if quant_sections is not None else kv_value_lanes(k_cache)
    KVH = C // Dh
    g = H // KVH
    M = block_tables.shape[1]
    if v_lanes is not None:
        S_plan = splits or (LATENT_SPLITS if chunk
                            else latent_decode_splits(B))
        if chunk is None:         # each row its own chunk: group by it
            chunks = [latent_split_plan(min(n, M * block_size), S_plan)[0]
                      for n in seq_lens.tolist()]
            parts = [None] * 3
            for c in sorted(set(chunks)):
                sel = torch.tensor([x == c for x in chunks],
                                   device=q.device)
                got = paged_attention_partials_ref(
                    q[sel], k_cache, v_cache, block_tables[sel],
                    seq_lens[sel], block_size=block_size, scale=scale,
                    chunk=c, v_lanes=v_lanes, quant_sections=quant_sections,
                    splits=S_plan)
                for i, t in enumerate(got):
                    if parts[i] is None:
                        parts[i] = t.new_empty((B,) + t.shape[1:])
                    parts[i][sel] = t
            return tuple(parts)
    else:
        plan_chunk, S_plan = decode_split_plan(M, block_size)
        chunk = chunk or plan_chunk
    S = -(-(M * block_size) // chunk)
    idx = flat_token_indices(block_tables, block_size)          # [B, T]
    T = idx.shape[1]

    def rows(cache):
        r = cache[idx]
        if cache.dtype != torch.int8:
            return r.float().reshape(B, T, KVH, Dh), None
        sc = _decode_scale(r[..., C], r[..., C + 1])             # [B, T]
        return r[..., :C].float().reshape(B, T, KVH, Dh), sc
    if quant_sections is not None:
        k, ks = _latent_keys(k_cache, idx, Dh, quant_sections,
                             torch.float32).reshape(B, T, 1, Dh), None
    else:
        k, ks = rows(k_cache)
    if v_lanes is not None:
        v, vs = k[..., :v_lanes], None
    else:
        v, vs = rows(v_cache)
    Dv = v.shape[-1]
    qg = q.float().reshape(B, KVH, g, Dh)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k)
    if ks is not None:
        s = s * ks[:, None, None, :]
    s = s * (scale * 1.4426950408889634)
    live = torch.arange(T, device=q.device)[None, :] < seq_lens.long()[:, None]
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    pad = S * chunk - T                     # the plan covers the table
    s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    s = s.reshape(B, KVH, g, S, chunk)
    m = s.amax(-1)                                             # [B, KVH, g, S]
    p = torch.exp2(s - m[..., None])
    p = torch.where(torch.isneginf(s), torch.zeros_like(p), p)
    l = p.sum(-1)
    if vs is not None:
        p = p * torch.nn.functional.pad(vs, (0, pad)).reshape(
            B, 1, 1, S, chunk)
    vpad = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).reshape(
        B, S, chunk, KVH, Dv)
    acc = torch.einsum("bkgsc,bsckd->bksgd", p, vpad)
    m, l = m.permute(0, 1, 3, 2), l.permute(0, 1, 3, 2)
    if S > S_plan:      # a latent chunk's splits past the keys it covers
        m, l, acc = m[:, :, :S_plan], l[:, :, :S_plan], acc[:, :, :S_plan]
    if S < S_plan:                          # empty splits past the table
        extra = S_plan - S
        m = torch.nn.functional.pad(m, (0, 0, 0, extra), value=float("-inf"))
        l = torch.nn.functional.pad(l, (0, 0, 0, extra))
        acc = torch.nn.functional.pad(acc, (0, 0, 0, 0, 0, extra))
    return m, l, acc


def merge_split_partials(m: torch.Tensor, l: torch.Tensor,
                         acc: torch.Tensor) -> torch.Tensor:
    """K3's merge of the splits' (m, l, acc) (layout of
    ``paged_attention_partials_ref``) → [B, KVH*g, Dv] f32: weights
    exp2(m_s - max m), a split with m = -inf weighing 0 (not NaN), and 0
    where no split saw a key."""
    B, KVH, S, g, Dv = acc.shape
    mx = m.amax(2, keepdim=True)
    w = torch.where(torch.isneginf(m), torch.zeros_like(m),
                    torch.exp2(m - mx))
    num = (w[..., None] * acc).sum(2)                          # [B, KVH, g, Dh]
    den = (w * l).sum(2)[..., None]
    out = torch.where(den > 0, num / torch.where(den > 0, den,
                                                  torch.ones_like(den)),
                      torch.zeros_like(num))
    return out.reshape(B, KVH * g, Dv)


def paged_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor, *, block_size: int, scale: float,
                    softcap: Optional[float] = None,
                    win_lo: Optional[torch.Tensor] = None,
                    v_lanes: Optional[int] = None,
                    quant_sections: Optional[tuple] = None) -> torch.Tensor:
    """Decode attention over the paged pool (contract of
    ``dynamo_tpu.engine.attention.paged_attention_pallas``; ``win_lo`` None
    is a global layer; ``v_lanes`` and ``quant_sections`` as there, checked
    by ``check_latent_modes`` on either device). CPU tensors take the plain
    version; CUDA tensors run ``csrc/paged_attention.cu`` over a bf16 pool
    or an int8 pool with in-row scales, and in the MLA modes
    ``csrc/latent_attention.cu`` (K3-MLA), which takes neither a soft-cap
    nor a window."""
    check_latent_modes(q, k_cache, v_lanes, quant_sections)
    if not q.is_cuda:
        return paged_attention_ref(q, k_cache, v_cache, block_tables,
                                   seq_lens, block_size=block_size,
                                   scale=scale, softcap=softcap,
                                   win_lo=win_lo, v_lanes=v_lanes,
                                   quant_sections=quant_sections)
    from . import kernels
    if v_lanes is not None:
        if softcap or win_lo is not None:
            raise ValueError("the latent kernels take neither a soft-cap "
                             "nor a sliding window")
        return kernels.latent_paged_attention_cuda(
            q, k_cache, block_tables, seq_lens, block_size=block_size,
            scale=scale, v_lanes=v_lanes, quant_sections=quant_sections)
    fn = (kernels.paged_attention_int8_cuda if k_cache.dtype == torch.int8
          else kernels.paged_attention_cuda)
    return fn(q, k_cache, v_cache, block_tables, seq_lens,
              block_size=block_size, scale=scale, softcap=softcap or 0.0,
              win_lo=win_lo)


# ---------------------------------------------------------------------------
# Ragged mixed prefill+decode
# ---------------------------------------------------------------------------

# per-sequence sliding-window base for GLOBAL layers: hugely negative so
# win_base + row never masks anything
RAGGED_WIN_SENTINEL = -(1 << 30)


def ragged_paged_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor,
                               block_tables: torch.Tensor,
                               seq_starts: torch.Tensor,
                               seq_counts: torch.Tensor,
                               seq_lens: torch.Tensor, *, block_size: int,
                               scale: float, max_rows: int,
                               softcap: Optional[float] = None,
                               win_base: Optional[torch.Tensor] = None,
                               v_lanes: Optional[int] = None,
                               quant_sections: Optional[tuple] = None
                               ) -> torch.Tensor:
    """Plain version of ``ragged_paged_attention``: the JAX package's row
    path (``llama.ragged_forward`` without the kernel). Each owned row r
    of sequence s is expanded to s's block table and attends as one
    decode query with ``seq_len = pos0 + r + 1`` (pos0 = seq_lens[s] -
    seq_counts[s]) and, with ``win_base``, ``win_lo = win_base[s] + r``,
    through ``paged_attention_ref`` (in its MLA modes with ``v_lanes`` /
    ``quant_sections``). Rows no sequence owns get zeros, as from the
    kernel. A count above ``max_rows`` is refused: the kernel computes at
    most ``max_rows`` rows of a sequence."""
    if int(seq_counts.max()) > max_rows:
        raise ValueError(f"a sequence owns more than max_rows={max_rows} "
                         f"rows")
    # each flat row's owning sequence and its index r in that span (rows
    # no sequence owns: sequence 0, r 0, not owned)
    t = torch.arange(q.shape[0], device=q.device)[:, None]
    starts = seq_starts.long()[None, :]
    inside = (t >= starts) & (t < starts + seq_counts.long()[None, :])
    owned = inside.any(dim=1)
    owner = inside.to(torch.int8).argmax(dim=1)
    r = torch.where(owned, t[:, 0] - seq_starts.long()[owner],
                    torch.zeros_like(owner))
    pos0 = seq_lens.long()[owner] - seq_counts.long()[owner]
    row_lens = torch.where(owned, pos0 + r + 1, torch.zeros_like(r))
    win_lo = None
    if win_base is not None:
        win_lo = win_base.long()[owner] + r
    return paged_attention_ref(q, k_cache, v_cache, block_tables[owner],
                               row_lens, block_size=block_size, scale=scale,
                               softcap=softcap, win_lo=win_lo,
                               v_lanes=v_lanes,
                               quant_sections=quant_sections)


# K4 takes 64 (row, head) query vectors per CTA: 64 / g rows of one
# sequence times the g query heads of one KV head
RAGGED_CTA_VECTORS = 64


def ragged_row_tiles(max_rows: int, g: int) -> int:
    """K4's row tiles per sequence: ``max_rows`` rows at 64 / g a tile."""
    per = RAGGED_CTA_VECTORS // g
    return -(-max_rows // per)


def ragged_row_plan(seq_starts: torch.Tensor, seq_counts: torch.Tensor,
                    seq_lens: torch.Tensor, TT: int, g: int, M: int,
                    block_size: int,
                    tile_rows: Optional[int] = None) -> tuple:
    """K4's plan per flat row: (its tile's chunk in keys, its tile's live
    splits: the keys the tile's last row sees, in those chunks), both
    [TT] long, 0 for rows no sequence owns. A tile of at most 16 live
    (row, head) query vectors takes the chunk of ``decode_split_plan``, a
    wider one twice that: where many rows share each key, longer chunks
    leave fewer partials to merge. Where a tile has 2 or more live splits,
    K4 writes its rows' partials of those splits to its scratch.
    ``tile_rows``: K4-MLA's plan (LATENT_TILE_ROWS): tiles of that many
    rows, each cut by ``latent_split_plan`` of the keys its last owned row
    sees."""
    base, _ = decode_split_plan(M, block_size)
    per = tile_rows or RAGGED_CTA_VECTORS // g
    chunks = torch.zeros(TT, dtype=torch.long)
    live = torch.zeros(TT, dtype=torch.long)
    for st, n, ln in zip(seq_starts.tolist(), seq_counts.tolist(),
                         seq_lens.tolist()):
        for r in range(n):
            r0 = r - r % per
            rows = min(per, n - r0)
            keys = min(ln - n + r0 + rows, M * block_size)
            if tile_rows:
                chunk, n_live = latent_split_plan(keys)
            else:
                chunk = base * (2 if rows * g > 16 else 1)
                n_live = -(-keys // chunk)
            chunks[st + r], live[st + r] = chunk, n_live
    return chunks, live


def ragged_attention_partials_ref(q: torch.Tensor, k_cache: torch.Tensor,
                                  v_cache: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  seq_starts: torch.Tensor,
                                  seq_counts: torch.Tensor,
                                  seq_lens: torch.Tensor, *, block_size: int,
                                  scale: float, max_rows: int,
                                  v_lanes: Optional[int] = None,
                                  quant_sections: Optional[tuple] = None
                                  ) -> tuple:
    """The split form of ``ragged_paged_attention_ref`` with K4's
    arithmetic, for the tests (``merge_split_partials`` completes it): each
    owned row r of sequence s is a decode query over s's table that sees
    ``pos0 + r + 1`` keys, cut into splits of its row tile's chunk
    (``ragged_row_plan``) as K3 cuts a sequence
    (``paged_attention_partials_ref``: exp2-domain scores, an int8 row's
    scale taken out of the dot and folded into p). A split a row cannot
    see, and every split of a row no sequence owns, gives (-inf, 0, 0).
    In the MLA modes (``v_lanes``, ``quant_sections``) a tile is
    LATENT_TILE_ROWS rows cut into LATENT_SPLITS splits by the keys its
    last row sees, as in K4-MLA. Returns (m [TT, KVH, S, g], l [TT, KVH,
    S, g], acc [TT, KVH, S, g, Dv]) with S from ``decode_split_plan`` (the
    MLA modes: LATENT_SPLITS) and Dv = v_lanes or Dh, the layout
    ``split_scratch_views`` reads from K4's scratch and K4-MLA's
    partials."""
    if int(seq_counts.max()) > max_rows:
        raise ValueError(f"a sequence owns more than max_rows={max_rows} "
                         f"rows")
    t = torch.arange(q.shape[0], device=q.device)[:, None]
    starts = seq_starts.long()[None, :]
    inside = (t >= starts) & (t < starts + seq_counts.long()[None, :])
    owned = inside.any(dim=1)
    owner = inside.to(torch.int8).argmax(dim=1)
    r = t[:, 0] - seq_starts.long()[owner]
    row_lens = torch.where(
        owned, seq_lens.long()[owner] - seq_counts.long()[owner] + r + 1,
        torch.zeros_like(r)).to(torch.int32)
    TT, H, Dh = q.shape
    latent = v_lanes is not None
    g = H if latent else H // (kv_value_lanes(k_cache) // Dh)
    chunks, _ = ragged_row_plan(seq_starts, seq_counts, seq_lens, TT, g,
                                block_tables.shape[1], block_size,
                                LATENT_TILE_ROWS if latent else None)
    chunks = chunks.to(q.device)
    parts = None
    for chunk in sorted(set(chunks.tolist()) - {0}) or [0]:
        rows = (chunks == chunk) if chunk else torch.ones_like(owned)
        got = paged_attention_partials_ref(
            q[rows], k_cache, v_cache, block_tables[owner[rows]],
            row_lens[rows], block_size=block_size, scale=scale,
            chunk=chunk or None, v_lanes=v_lanes,
            quant_sections=quant_sections)
        if parts is None:
            parts = [torch.empty((TT,) + t.shape[1:], dtype=t.dtype,
                                 device=t.device) for t in got]
            parts[0].fill_(float("-inf"))
            parts[1].zero_()
            parts[2].zero_()
        for dst, src in zip(parts, got):
            dst[rows] = src
    return tuple(parts)


def ragged_paged_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, block_tables: torch.Tensor,
                           seq_starts: torch.Tensor, seq_counts: torch.Tensor,
                           seq_lens: torch.Tensor, *, block_size: int,
                           scale: float, max_rows: int,
                           softcap: Optional[float] = None,
                           win_base: Optional[torch.Tensor] = None,
                           v_lanes: Optional[int] = None,
                           quant_sections: Optional[tuple] = None
                           ) -> torch.Tensor:
    """Ragged mixed prefill+decode attention in one call (contract of
    ``dynamo_tpu.engine.attention.ragged_paged_attention_pallas``).

    q: [TT, H, Dh] flat token rows; block_tables: [S, M]; sequence s
    owns rows [seq_starts[s], seq_starts[s] + seq_counts[s]) at the
    consecutive positions ending at seq_lens[s] - 1 (a decode step is a
    count of 1, a prefill chunk a longer span, a count of 0 skips the
    sequence); ``max_rows`` bounds any count. ``win_base``: [S] first-row
    sliding floor (pos0 - window), or RAGGED_WIN_SENTINEL / None for
    global layers. The pool is bf16 or int8 rows with in-row scales.
    ``v_lanes`` and ``quant_sections``: the MLA modes, as in
    ``paged_attention`` (``check_latent_modes``). Returns [TT, H, Dh] (or
    [TT, H, v_lanes]) in q's dtype; rows no sequence owns are zeros.

    CPU tensors take the plain version; CUDA tensors run
    ``csrc/ragged_paged_attention.cu`` (K4), and in the MLA modes
    ``csrc/latent_attention.cu`` (K4-MLA, no soft-cap, no window). K4's
    shape rule (not the TPU kernel's VMEM budget, ``ragged_supported``):
    Dh 64, 96, 128 or 256, H/KVH in ``kernels.GROUPS`` of that head dim
    (1-8 at 64 and 128; 1, 2, 4 or 8 at 96 and 256), the pool's rows a
    whole number of blocks; any row budget."""
    check_latent_modes(q, k_cache, v_lanes, quant_sections)
    if not q.is_cuda:
        return ragged_paged_attention_ref(
            q, k_cache, v_cache, block_tables, seq_starts, seq_counts,
            seq_lens, block_size=block_size, scale=scale, max_rows=max_rows,
            softcap=softcap, win_base=win_base, v_lanes=v_lanes,
            quant_sections=quant_sections)
    from . import kernels
    if v_lanes is not None:
        if softcap or win_base is not None:
            raise ValueError("the latent kernels take neither a soft-cap "
                             "nor a sliding window")
        return kernels.latent_ragged_attention_cuda(
            q, k_cache, block_tables, seq_starts, seq_counts, seq_lens,
            block_size=block_size, scale=scale, max_rows=max_rows,
            v_lanes=v_lanes, quant_sections=quant_sections)
    fn = (kernels.ragged_paged_attention_int8_cuda
          if k_cache.dtype == torch.int8
          else kernels.ragged_paged_attention_cuda)
    return fn(q, k_cache, v_cache, block_tables, seq_starts, seq_counts,
              seq_lens, block_size=block_size, scale=scale,
              max_rows=max_rows, softcap=softcap or 0.0, win_base=win_base)
