"""Batched sampling: temperature / top-k / top-p / greedy with per-slot
parameters, and the chosen token's logprob.

Counterpart of ``dynamo_tpu.engine.sampling``. ``sample_tokens`` takes its
Gumbel noise as an argument, so a test can hand both packages the same
noise and expect the same tokens; on the engine path the noise comes from
a per-request ``torch.Generator`` on the device (``gumbel_noise``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

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


def gumbel_noise(vocab: int, generators: Sequence[Optional[torch.Generator]],
                 device) -> torch.Tensor:
    """[B, V] standard Gumbel noise, row b drawn from ``generators[b]``;
    rows whose generator is None (greedy slots) are zeros."""
    out = torch.zeros((len(generators), vocab), dtype=torch.float32,
                      device=device)
    for b, gen in enumerate(generators):
        if gen is not None:
            u = torch.rand(vocab, generator=gen, device=device,
                           dtype=torch.float32)
            out[b] = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return out


def sample_tokens(logits: torch.Tensor, gumbel: torch.Tensor,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """logits: [B, V] f32; gumbel: [B, V] noise; per-slot params [B].
    Returns (tokens [B] int64, logprobs [B] f32 of the chosen token under
    the unscaled distribution)."""
    B, V = logits.shape
    logprobs_all = torch.log_softmax(logits, dim=-1)
    greedy_tok = torch.argmax(logits, dim=-1)
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits / temp
    if bool(((top_p < 1.0) | (top_k > 0)).any()):
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
