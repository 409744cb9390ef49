"""Ragged dispatch: the mixed prefill+decode batch builder and its
metadata contract.

Counterpart of ``dynamo_tpu.engine.ragged`` (a line-for-line copy: the
module is pure numpy). One ragged dispatch serves a flat ``[sum(T_i)]``
token batch through ONE forward pass (the model family's
``ragged_forward``: ``models/llama.py`` or ``models/mla.py``): every
participating slot contributes a contiguous
row span described by ``(start, len, mode)`` —

- ``mode == "decode"``: one row, the slot's last token at its current
  position (a plain continuous-batching decode step);
- ``mode == "prefill"``: up to ``max_seq_rows`` consecutive prompt
  tokens (a prefill chunk riding the same dispatch; the row consuming
  the LAST prompt token is the one whose sample becomes the first
  generation);
- ``mode == "spec"``: a speculative verify span (the last token plus up
  to k draft tokens). The packing policy keeps it because the policy is
  one function; the port's engine does not produce spec spans yet.

The kernel math never reads ``mode`` — a decode step IS a length-1
chunk — but the scheduler and its metrics do: mode is what makes
"dispatches saved" and the mixed-batch ratio well-defined.

Packing policy (deterministic, capacity-greedy): decode/spec row-0
rows first (one per decoding slot — a ragged dispatch never starves
token emission), then one MINIMUM row per pending prefill lane
(progress guarantee: every admitted prompt advances every dispatch),
then spec spans take their draft rows in slot order (atomic within the
dispatch), then the remaining capacity round-robins across the prefill
lanes one row at a time (fair sharing — a long prompt cannot lock out a
short one) up to each lane's ``max_seq_rows``/remaining-prompt bound.
Rows are laid out in slot order with ascending starts, and the packing
is deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["RaggedSeq", "RaggedBatch", "build_ragged_batch"]


@dataclasses.dataclass(frozen=True)
class RaggedSeq:
    """One slot's row span in a ragged batch — the (start, len, mode)
    metadata contract. ``pos0`` is the absolute position of the first
    row (rows sit at consecutive positions pos0 .. pos0+length-1)."""

    slot: int
    start: int
    length: int
    mode: str          # "prefill" | "decode" | "spec"
    pos0: int


@dataclasses.dataclass
class RaggedBatch:
    """Device-ready arrays for one ragged dispatch over ``n_slots``
    engine slots. Array shapes: tokens/positions/row_slot are
    [capacity] (dead rows: token 0, position 0, row_slot == n_slots —
    the all-zeros trash table row the engine appends);
    seq_starts/seq_counts/sample_rows are [n_slots + 1] (the trailing
    trash sequence has count 0)."""

    capacity: int
    n_slots: int
    tokens: np.ndarray
    positions: np.ndarray
    row_slot: np.ndarray
    seq_starts: np.ndarray
    seq_counts: np.ndarray
    sample_rows: np.ndarray
    seqs: List[RaggedSeq]

    @property
    def rows_used(self) -> int:
        return int(sum(s.length for s in self.seqs))

    @property
    def fill_ratio(self) -> float:
        return self.rows_used / max(self.capacity, 1)

    @property
    def n_prefill(self) -> int:
        return sum(1 for s in self.seqs if s.mode == "prefill")

    @property
    def n_decode(self) -> int:
        return sum(1 for s in self.seqs if s.mode == "decode")

    @property
    def n_spec(self) -> int:
        return sum(1 for s in self.seqs if s.mode == "spec")

    @property
    def prefill_rows(self) -> int:
        return int(sum(s.length for s in self.seqs
                       if s.mode == "prefill"))

    @property
    def spec_rows(self) -> int:
        """Draft rows riding this dispatch (rows BEYOND each spec
        span's mandatory row 0 — the ragged_spec_rows metric feed)."""
        return int(sum(s.length - 1 for s in self.seqs
                       if s.mode == "spec"))

    @property
    def mixed(self) -> bool:
        """True when prefill chunks and decode steps share the
        dispatch — the batch-boundary bubble the split path pays."""
        return self.n_prefill > 0 and (self.n_decode + self.n_spec) > 0

    @property
    def dispatches_replaced(self) -> int:
        """How many split-path dispatches this one batch stands in
        for: each prefill chunk would be its own prefill-program
        dispatch and the decode/verify rows together one decode (or
        verify) dispatch."""
        return self.n_prefill + (1 if self.n_decode + self.n_spec
                                 else 0)

    def seqs_meta(self) -> List[Tuple[int, int, int, str]]:
        """(slot, start, len, mode) rows — the wire form of the
        metadata contract."""
        return [(s.slot, s.start, s.length, s.mode) for s in self.seqs]


def build_ragged_batch(
        capacity: int, n_slots: int,
        decode_rows: Sequence[Tuple[int, int, int]],
        prefill_lanes: Sequence[Tuple[int, Sequence[int], int]],
        max_seq_rows: int,
        spec_lanes: Sequence[Tuple[int, Sequence[int], int]] = ()
        ) -> Optional[RaggedBatch]:
    """Pack pending work into one token-capacity-filled ragged batch.

    ``decode_rows``: (slot, input_token, position) per decoding slot.
    ``prefill_lanes``: (slot, remaining_prompt_tokens, position) per
    slot still consuming its prompt (position = absolute position of
    remaining_prompt_tokens[0]).
    ``spec_lanes``: (slot, [last_token, draft_1..draft_k], position)
    per decoding slot with a live draft chain — row 0 is the slot's
    mandatory decode row, draft rows ride as surplus (module
    docstring: atomic within the dispatch, truncated — never split —
    under capacity pressure; a span truncated to 1 row degrades to a
    plain decode row).

    Returns None when there is nothing to dispatch. Raises when the
    decode rows alone exceed capacity (an EngineConfig validation
    failure — ragged_max_tokens must cover max_num_seqs)."""
    n_decode = len(decode_rows) + len(spec_lanes)
    if n_decode + len(prefill_lanes) == 0:
        return None
    if n_decode + len(prefill_lanes) > capacity:
        raise ValueError(
            f"ragged capacity {capacity} cannot hold even one row for "
            f"each of {n_decode} decode + {len(prefill_lanes)} prefill "
            f"slots — raise ragged_max_tokens")
    budget = capacity - n_decode
    # minimum one row per prefill lane first (progress guarantee) ...
    lane_rows = []
    for slot, toks, _pos in prefill_lanes:
        cap = min(len(toks), max_seq_rows)
        lane_rows.append(max(min(1, cap), 0))
        budget -= lane_rows[-1]
    # ... then spec draft rows in slot order (accepted drafts multiply
    # tokens/dispatch — a better use of a marginal row than one more
    # prompt row, which only moves admission latency) ...
    spec_rows = []
    for slot, toks, _pos in sorted(spec_lanes):
        want = min(len(toks), max_seq_rows) - 1
        take = max(min(want, budget), 0)
        spec_rows.append(1 + take)
        budget -= take
    # ... then round-robin the surplus one prompt row at a time
    # (fairness across prompt lengths)
    grew = True
    while budget > 0 and grew:
        grew = False
        for li, (slot, toks, _pos) in enumerate(prefill_lanes):
            if budget <= 0:
                break
            if lane_rows[li] < min(len(toks), max_seq_rows):
                lane_rows[li] += 1
                budget -= 1
                grew = True

    tokens = np.zeros((capacity,), np.int32)
    positions = np.zeros((capacity,), np.int32)
    row_slot = np.full((capacity,), n_slots, np.int32)   # dead → trash
    seq_starts = np.zeros((n_slots + 1,), np.int32)
    seq_counts = np.zeros((n_slots + 1,), np.int32)
    sample_rows = np.zeros((n_slots + 1,), np.int32)
    seqs: List[RaggedSeq] = []

    per_slot: dict = {}
    for slot, tok, pos in decode_rows:
        per_slot[slot] = ("decode", [int(tok)], int(pos))
    for si, (slot, toks, pos) in enumerate(sorted(spec_lanes)):
        mode = "spec" if spec_rows[si] > 1 else "decode"
        per_slot[slot] = (mode,
                          [int(t) for t in toks[:spec_rows[si]]],
                          int(pos))
    for li, (slot, toks, pos) in enumerate(prefill_lanes):
        per_slot[slot] = ("prefill",
                          [int(t) for t in toks[:lane_rows[li]]],
                          int(pos))

    cursor = 0
    for slot in sorted(per_slot):            # slot order → ascending starts
        mode, toks, pos0 = per_slot[slot]
        L = len(toks)
        if L == 0:
            continue
        tokens[cursor:cursor + L] = toks
        positions[cursor:cursor + L] = pos0 + np.arange(L)
        row_slot[cursor:cursor + L] = slot
        seq_starts[slot] = cursor
        seq_counts[slot] = L
        sample_rows[slot] = cursor + L - 1
        seqs.append(RaggedSeq(slot=slot, start=cursor, length=L,
                              mode=mode, pos0=pos0))
        cursor += L
    # the trash sequence starts past every live row so the kernel's
    # ascending-starts contract holds for it too
    seq_starts[n_slots] = cursor
    if not seqs:
        return None
    return RaggedBatch(capacity=capacity, n_slots=n_slots,
                       tokens=tokens, positions=positions,
                       row_slot=row_slot, seq_starts=seq_starts,
                       seq_counts=seq_counts, sample_rows=sample_rows,
                       seqs=seqs)
