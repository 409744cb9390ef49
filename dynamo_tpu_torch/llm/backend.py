"""Backend operator: incremental detokenization + stop handling ("jail").

A copy of ``dynamo_tpu.llm.backend``. Reference: `Backend` (lib/llm/src/backend.rs:66-247) and its
`Decoder`/`StopTrigger`/`StepResult` machinery (backend.rs:253-507). Sits
between the preprocessor and the engine: the engine emits raw token ids; this
operator turns them into UTF-8-safe text deltas, watches for stop sequences
(holding back — "jailing" — text that might be the prefix of a stop string so
it is never surfaced), recognizes hidden stop tokens (model EOS ids, which
produce no text), and converts all of that into finish reasons. When a stop
triggers, it calls `ctx.stop_generating()` so the engine halts at the next
step boundary (engines cancel between decode steps).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import AsyncIterator, List, Optional, Sequence

from ..runtime.engine import AsyncEngine, ManyOut, ResponseStream, SingleIn
from ..runtime.pipeline import Operator
from .model_card import ModelDeploymentCard
from .protocols.annotated import Annotated
from .protocols.common import BackendOutput, FinishReason, PreprocessedRequest


class StopTrigger(enum.Enum):
    """Why the decoder declared the stream finished (reference backend.rs)."""

    HIDDEN_STOP_TOKEN = "hidden_stop_token"
    STOP_SEQUENCE = "stop_sequence"
    MAX_TOKENS = "max_tokens"

    def finish_reason(self) -> FinishReason:
        if self is StopTrigger.HIDDEN_STOP_TOKEN:
            return FinishReason.EOS
        if self is StopTrigger.STOP_SEQUENCE:
            return FinishReason.STOP
        return FinishReason.LENGTH


@dataclasses.dataclass
class StepResult:
    """Outcome of feeding one token to the decoder."""

    text: Optional[str] = None
    stop_trigger: Optional[StopTrigger] = None

    @property
    def is_complete(self) -> bool:
        return self.stop_trigger is not None


def _longest_jail_suffix(buffer: str, stops: Sequence[str]) -> int:
    """Length of the longest suffix of `buffer` that is a proper prefix of any
    stop sequence — that many chars must stay jailed. (The reference uses a
    galil-seiferas search over a bounded jail, backend.rs:253+; for serving-
    sized stop lists a direct scan is equivalent and simpler.)"""
    best = 0
    for stop in stops:
        limit = min(len(buffer), len(stop) - 1)
        for k in range(limit, 0, -1):
            if buffer[-k:] == stop[:k]:
                best = max(best, k)
                break
    return best


class Decoder:
    """Per-request decode state: incremental detok + stop-jail.

    Reference `Decoder` (backend.rs:253-507).
    """

    def __init__(self, tokenizer, stop_sequences: Optional[List[str]] = None,
                 hidden_stop_ids: Optional[List[int]] = None,
                 max_tokens: Optional[int] = None,
                 min_tokens: Optional[int] = None,
                 skip_special_tokens: bool = True):
        self._stream = tokenizer.decode_stream(skip_special_tokens=skip_special_tokens)
        self._stops = [s for s in (stop_sequences or []) if s]
        self._hidden = set(hidden_stop_ids or [])
        self._max_tokens = max_tokens
        self._min_tokens = min_tokens or 0
        self._jail = ""
        self._emitted_tokens = 0

    def step(self, token_id: int) -> StepResult:
        self._emitted_tokens += 1
        past_min = self._emitted_tokens > self._min_tokens
        if token_id in self._hidden and past_min:
            # Hidden stop tokens never surface text (backend.rs hidden stops);
            # jailed text stays hidden too (it may be a partial stop prefix).
            self._discard_jail()
            return StepResult(text=None,
                              stop_trigger=StopTrigger.HIDDEN_STOP_TOKEN)
        delta = self._stream.step(token_id)
        text_out: Optional[str] = None
        trigger: Optional[StopTrigger] = None
        if delta:
            self._jail += delta
            if self._stops:
                hit_pos = -1
                for stop in self._stops:
                    pos = self._jail.find(stop)
                    if pos != -1 and (hit_pos == -1 or pos < hit_pos):
                        hit_pos = pos
                if hit_pos != -1 and past_min:
                    # Emit text before the stop match; swallow the rest.
                    text_out = self._jail[:hit_pos] or None
                    self._jail = ""
                    return StepResult(text=text_out,
                                      stop_trigger=StopTrigger.STOP_SEQUENCE)
                keep = _longest_jail_suffix(self._jail, self._stops)
                if keep:
                    text_out = self._jail[:-keep] or None
                    self._jail = self._jail[-keep:]
                else:
                    text_out = self._jail or None
                    self._jail = ""
            else:
                text_out = self._jail or None
                self._jail = ""
        if (self._max_tokens is not None
                and self._emitted_tokens >= self._max_tokens):
            trigger = StopTrigger.MAX_TOKENS
            self._discard_jail()
        return StepResult(text=text_out, stop_trigger=trigger)

    def _discard_jail(self) -> None:
        # A partial stop-sequence prefix at end-of-stream stays hidden
        # (reference: jailed text is only released when disambiguated).
        self._jail = ""


class Backend(Operator):
    """The detokenizing operator (reference `Backend`, backend.rs:66-247)."""

    def __init__(self, mdc: ModelDeploymentCard, validate_engine_decode: bool = False):
        self.mdc = mdc
        self.tokenizer = mdc.tokenizer()
        self.validate_engine_decode = validate_engine_decode

    async def generate(self, request: SingleIn, next_engine: AsyncEngine) -> ManyOut:
        pre: PreprocessedRequest = request.data
        sc = pre.stop_conditions
        decoder = Decoder(
            self.tokenizer,
            stop_sequences=sc.stop,
            hidden_stop_ids=sc.stop_token_ids_hidden,
            max_tokens=sc.max_tokens,
            min_tokens=sc.min_tokens,
            skip_special_tokens=pre.output_options.skip_special_tokens,
        )
        downstream = await next_engine.generate(request)
        ctx = request.ctx

        async def backward() -> AsyncIterator[Annotated[BackendOutput]]:
            finished = False
            async for item in downstream:
                ann = item if isinstance(item, Annotated) else Annotated.from_data(item)
                if ann.data is None:
                    yield ann
                    continue
                out: BackendOutput = ann.data
                texts: List[str] = []
                trigger: Optional[StopTrigger] = None
                consumed: List[int] = []
                for tid in out.token_ids:
                    consumed.append(tid)
                    res = decoder.step(tid)
                    if res.text:
                        texts.append(res.text)
                    if res.is_complete:
                        trigger = res.stop_trigger
                        break
                new = BackendOutput(
                    # truncate to what the decoder consumed so usage
                    # accounting matches the visible completion
                    token_ids=consumed,
                    text="".join(texts) if texts else None,
                    cum_log_probs=out.cum_log_probs,
                    log_probs=out.log_probs,
                    top_logprobs=out.top_logprobs,
                    tokens=out.tokens,
                    finish_reason=out.finish_reason,
                )
                if self.validate_engine_decode and out.text is not None:
                    if new.text != out.text:
                        ann.comment = (ann.comment or []) + [
                            f"detok mismatch: engine={out.text!r} local={new.text!r}"]
                if trigger is not None:
                    new.finish_reason = trigger.finish_reason()
                    finished = True
                    # Step-granular cancellation: tell the engine to halt.
                    ctx.stop_generating()
                yield Annotated(data=new, id=ann.id, event=ann.event,
                                comment=ann.comment)
                if finished:
                    break

        return ResponseStream(backward(), ctx)
