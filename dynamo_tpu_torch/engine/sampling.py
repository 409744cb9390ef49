"""Batched sampling: temperature / top-k / top-p / greedy with per-slot
parameters, and the chosen token's logprob.

Counterpart of ``dynamo_tpu.engine.sampling``. ``sample_tokens`` takes its
Gumbel noise as an argument. On the engine path the noise is the JAX
engine's, bit for bit up to the last two float ops: row b is keyed by
``make_slot_key(engine seed, request seed, key_step)`` (JAX's
``PRNGKey`` → ``fold_in`` → ``fold_in`` on threefry2x32) and drawn as
``jax.random.gumbel(key, (V,), float32)`` draws it (the partitionable
counter layout of ``jax_threefry_partitionable=True``, the
uniform-from-mantissa map, then ``-log(-log(u))``). The noise of a row is a
pure function of those three integers.

Inside a decode or ragged program (``engine/programs.py``, a CUDA graph on
the card) nothing may read a device value on the host: the keys come from
``make_slot_keys`` on the device, the noise from ``gumbel_noise_from_keys``,
and the caller passes ``sample_tokens`` its filtered-or-plain decision,
which the host knows from the slots' parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

NEG_INF = -1e30


@dataclasses.dataclass
class SlotSampling:
    """Host-side per-request sampling parameters."""

    temperature: float = 0.0  # 0 → greedy
    top_k: int = 0            # 0 → disabled
    top_p: float = 1.0
    seed: int = 0

    @classmethod
    def from_options(cls, opts, default_temperature: float = 0.7) -> "SlotSampling":
        if opts is None:
            return cls(temperature=default_temperature)
        if getattr(opts, "greedy", False):
            return cls(temperature=0.0, seed=opts.seed or 0)
        t = opts.temperature if opts.temperature is not None else default_temperature
        return cls(temperature=float(t),
                   top_k=int(opts.top_k or 0),
                   top_p=float(opts.top_p if opts.top_p is not None else 1.0),
                   seed=int(opts.seed or 0))


_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) of ``jax._src.prng``, on uint32
    values held in Python ints or int64 tensors (broadcasting)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl32(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in``: the block applied to the counter pair
    ``(0, data)``."""
    return threefry2x32(key[0], key[1], 0, data & _M32)


def make_slot_key(base_seed: int, request_seed: int,
                  step: int) -> Tuple[int, int]:
    """The JAX engine's per-(request seed, key_step) key
    (``make_slot_keys``): ``fold_in(fold_in(PRNGKey(base), seed), step)``."""
    return fold_in(fold_in(prng_key(base_seed), request_seed), step)


def make_slot_keys(base_seed: int, seeds: torch.Tensor,
                   steps: torch.Tensor) -> torch.Tensor:
    """``make_slot_key`` over tensors: seeds [B] and steps [B] int64 (on
    any device) → keys [B, 2] int64 holding uint32 words, bit-equal to the
    scalar form row by row. A negative step folds in as its low 32 bits,
    as JAX folds an int32 (a lane admission keys its planned steps below
    its ``key_step``)."""
    k1, k2 = prng_key(base_seed)
    zero = torch.zeros_like(seeds)
    a1, a2 = threefry2x32(k1, k2, zero, seeds & _M32)
    b1, b2 = threefry2x32(a1, a2, zero, steps & _M32)
    return torch.stack([b1, b2], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit ``random_bits(key, (n,))`` for each key row: keys ``[B, 2]``
    int64 → ``[B, n]`` int64 holding uint32 values. Partitionable layout:
    counters (hi, lo) = (0, i), bits = both output words xor-ed."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    return b1 ^ b2


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel``'s low-resolution map: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, then JAX's ``uniform(minval=
    tiny, maxval=1)`` lift ``max(tiny, f * (1 - tiny) + tiny)`` (1 - tiny
    rounds to 1 in f32), then ``-log(-log(u))``."""
    tiny = torch.finfo(torch.float32).tiny
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    u = (floats + tiny).clamp_min(tiny)
    return -torch.log(-torch.log(u))


def gumbel_noise(vocab: int, keys: Sequence[Optional[Tuple[int, int]]],
                 device) -> torch.Tensor:
    """[B, V] standard Gumbel noise, row b drawn from ``keys[b]``
    (``make_slot_key``); rows whose key is None (greedy slots) are
    zeros."""
    out = torch.zeros((len(keys), vocab), dtype=torch.float32, device=device)
    rows = [b for b, k in enumerate(keys) if k is not None]
    if rows:
        kt = torch.tensor([keys[b] for b in rows], dtype=torch.int64,
                          device=device)
        out[rows] = gumbel_from_bits(random_bits(kt, vocab))
    return out


def gumbel_noise_from_keys(vocab: int, keys: torch.Tensor) -> torch.Tensor:
    """[B, V] standard Gumbel noise, row b drawn from ``keys[b]`` ([B, 2]
    int64, ``make_slot_keys``): the same bits as ``gumbel_noise`` for the
    same keys, with no host value read."""
    return gumbel_from_bits(random_bits(keys, vocab))


def greedy_tokens(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``sample_tokens`` for a batch whose every row is greedy: (argmax
    tokens [B] int64, their logprobs [B] f32), the same bits."""
    tok = torch.argmax(logits, dim=-1)
    chosen = torch.gather(torch.log_softmax(logits, dim=-1), 1,
                          tok[:, None])[:, 0]
    return tok, chosen


def sample_tokens(logits: torch.Tensor, gumbel: torch.Tensor,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor, filtered: Optional[bool] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """logits: [B, V] f32; gumbel: [B, V] noise; per-slot params [B].
    Returns (tokens [B] int64, logprobs [B] f32 of the chosen token under
    the unscaled distribution). ``filtered``: whether any row has top-k or
    top-p, which picks the sorted branch (JAX's ``lax.cond``; a row with
    neither gets the same token from both); None reads it from the
    tensors, a device-to-host sync."""
    B, V = logits.shape
    logprobs_all = torch.log_softmax(logits, dim=-1)
    greedy_tok = torch.argmax(logits, dim=-1)
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits / temp
    if filtered is None:
        filtered = bool(((top_p < 1.0) | (top_k > 0)).any())
    if filtered:
        order = torch.argsort(-scaled, dim=-1, stable=True)       # [B, V] desc
        sorted_logits = torch.gather(scaled, 1, order)
        sorted_probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(sorted_probs, dim=-1)
        keep_p = (cum - sorted_probs) < top_p[:, None]
        k_eff = torch.where(top_k > 0, top_k, torch.full_like(top_k, V))[:, None]
        keep_k = torch.arange(V, device=logits.device)[None, :] < k_eff
        keep = keep_p & keep_k
        keep[:, 0] = True
        masked = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, NEG_INF))
        sorted_gumbel = torch.gather(gumbel, 1, order)
        choice_sorted = torch.argmax(masked + sorted_gumbel, dim=-1)
        sampled_tok = torch.gather(order, 1, choice_sorted[:, None])[:, 0]
    else:
        # no top-k/top-p anywhere in the batch: Gumbel-argmax IS exact
        # temperature sampling, and skips the [B, V] sort
        sampled_tok = torch.argmax(scaled + gumbel, dim=-1)
    tok = torch.where(temperature <= 0.0, greedy_tok, sampled_tok)
    chosen = torch.gather(logprobs_all, 1, tok[:, None])[:, 0]
    return tok, chosen
