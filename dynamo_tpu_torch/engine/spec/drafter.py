"""Drafters: propose the next k tokens from a request's own history.

Counterpart of ``dynamo_tpu.engine.spec.drafter``. The verify side is
drafter-agnostic. The shipped drafter is prompt lookup (n-gram): match the
history's trailing n-gram against an earlier occurrence in the same
history and propose its continuation. It needs no second model and costs
microseconds of host time a step.

Acceptance contract ("lockstep acceptance"): the verify program samples
position t with the key (engine seed, request seed, key_step + t) that
plain decode would use at that stream index, so the sampled token s_t is
the token plain decode would emit there, greedy or sampled. A draft
d_{t+1} is accepted iff d_{t+1} == s_t, and the emitted stream is always
s_0..s_m.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


class Drafter:
    """Interface: propose up to ``k`` draft tokens given the request's
    token history (prompt + everything emitted so far, most recent last).
    Return [] to skip speculation this step: the engine then runs plain
    decode."""

    def draft(self, history: Sequence[int], k: int) -> List[int]:
        raise NotImplementedError


class PromptLookupDrafter(Drafter):
    """N-gram prompt lookup: find the most recent earlier occurrence of the
    history's trailing n-gram (longest n first) and propose the k tokens
    that followed it.

    ``window`` bounds the searched suffix, so drafting stays O(window·n) a
    step whatever the context length. The continuation may overlap the
    trailing n-gram itself, which lets a length-p cycle extend
    periodically."""

    def __init__(self, max_ngram: int = 4, min_ngram: int = 1,
                 window: int = 1024):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram "
                f"(got {min_ngram}..{max_ngram})")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.window = window

    def draft(self, history: Sequence[int], k: int) -> List[int]:
        h = list(history[-self.window:])
        n_hi = min(self.max_ngram, len(h) - 1)
        for n in range(n_hi, self.min_ngram - 1, -1):
            pattern = h[-n:]
            # candidate starts strictly before the trailing occurrence; the
            # most recent match wins, except that one flush against the
            # end can only propose a truncated continuation, so the scan
            # goes on for one with all k tokens
            best: List[int] = []
            for start in range(len(h) - n - 1, -1, -1):
                if h[start:start + n] == pattern:
                    cont = h[start + n:start + n + k]
                    if len(cont) == k:
                        return list(cont)
                    if len(cont) > len(best):
                        best = list(cont)
            if best:
                return best
        return []


def accept_lockstep(drafts: Sequence[int],
                    sampled: Sequence[int]) -> Tuple[int, List[int]]:
    """The acceptance rule. ``sampled`` is the verify dispatch's output
    s_0..s_k at lockstep keys; ``drafts`` is d_1..d_k. Returns (accepted
    draft count m, emitted tokens s_0..s_m): accepted drafts equal their
    samples, so the emission is always a prefix of ``sampled``."""
    m = 0
    while m < len(drafts) and int(sampled[m]) == int(drafts[m]):
        m += 1
    return m, [int(t) for t in sampled[:m + 1]]
