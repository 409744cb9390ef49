"""Echo engines — the no-hardware test engines (a copy of
``dynamo_tpu.llm.engines.echo``).

Reference: launch/dynamo-run/src/output/echo_{full,core}.rs and
docs/guides/dynamo_run.md:388-415. `EchoEngineCore` speaks the engine-internal
token protocol (sits behind preprocessor+backend); `EchoEngineFull` speaks
OpenAI directly. Token pacing via DYN_TOKEN_ECHO_DELAY_MS, matching the
reference's env knob.
"""

from __future__ import annotations

import asyncio
import os
from typing import AsyncIterator

from ...runtime.engine import AsyncEngine, ManyOut, ResponseStream, SingleIn
from ..protocols.annotated import Annotated
from ..protocols.common import BackendOutput, FinishReason, PreprocessedRequest
from ..protocols.openai import (ChatCompletionRequest, ChatDeltaGenerator,
                                CompletionDeltaGenerator, CompletionRequest,
                                usage_dict)


def _delay_s() -> float:
    return float(os.environ.get("DYN_TOKEN_ECHO_DELAY_MS", "0")) / 1000.0


class EchoEngineCore(AsyncEngine):
    """Echo the prompt's token ids back, one per step."""

    async def generate(self, request: SingleIn) -> ManyOut:
        pre: PreprocessedRequest = request.data
        ctx = request.ctx
        delay = _delay_s()
        max_tokens = pre.stop_conditions.max_tokens

        async def stream() -> AsyncIterator[Annotated[BackendOutput]]:
            emitted = 0
            for tid in pre.token_ids:
                if ctx.is_stopped:
                    break
                if max_tokens is not None and emitted >= max_tokens:
                    break
                if delay:
                    await asyncio.sleep(delay)
                emitted += 1
                yield Annotated.from_data(BackendOutput(token_ids=[tid]))
            if not ctx.is_stopped:
                yield Annotated.from_data(BackendOutput.final(FinishReason.STOP))

        return ResponseStream(stream(), ctx)


class EchoEngineFull(AsyncEngine):
    """Echo the raw prompt text as OpenAI chunks (no tokenizer involved)."""

    async def generate(self, request: SingleIn) -> ManyOut:
        req = request.data
        if isinstance(req, dict):
            req = (ChatCompletionRequest.from_dict(req)
                   if "messages" in req else CompletionRequest.from_dict(req))
        ctx = request.ctx
        delay = _delay_s()
        if isinstance(req, ChatCompletionRequest):
            text = req.messages[-1].text() if req.messages else ""
            gen = ChatDeltaGenerator(req.model, request_id=f"chatcmpl-{request.id}")
        else:
            text = req.prompt if isinstance(req.prompt, str) else ""
            gen = CompletionDeltaGenerator(req.model, request_id=f"cmpl-{request.id}")

        async def stream() -> AsyncIterator[Annotated[dict]]:
            words = text.split(" ")
            emitted = 0
            for word in words:
                if ctx.is_stopped:
                    break
                if delay:
                    await asyncio.sleep(delay)
                yield Annotated.from_data(gen.text_chunk(word + " "))
                emitted += 1
            # word counts stand in for token counts (echo has no tokenizer)
            if isinstance(gen, ChatDeltaGenerator):
                yield Annotated.from_data(gen.finish_chunk(FinishReason.STOP))
                yield Annotated.from_data(gen.usage_chunk(len(words),
                                                          emitted))
            else:
                yield Annotated.from_data(gen.finish_chunk(
                    FinishReason.STOP,
                    usage=usage_dict(len(words), emitted)))

        return ResponseStream(stream(), ctx)
