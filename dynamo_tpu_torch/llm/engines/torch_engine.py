"""PyTorch engine adapter: EngineCore → AsyncEngine[PreprocessedRequest, ...].

Counterpart of ``dynamo_tpu.llm.engines.jax_engine``: maps the request,
streams sampled tokens out of the request's queue, and honors
step-granular cancellation.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator

from ...engine.core import FINISH_SENTINEL, EngineCore, EngineRequest
from ...engine.sampling import SlotSampling
from ...runtime.engine import AsyncEngine, ManyOut, ResponseStream, SingleIn
from ..protocols.annotated import Annotated
from ..protocols.common import BackendOutput, FinishReason, PreprocessedRequest


class TorchEngine(AsyncEngine):
    """Serves the engine-internal token protocol from an EngineCore."""

    def __init__(self, core: EngineCore):
        self.core = core

    def build_request(self, request: SingleIn) -> EngineRequest:
        pre: PreprocessedRequest = request.data
        sc = pre.stop_conditions
        return EngineRequest(
            rid=request.id,
            prompt=list(pre.token_ids),
            sampling=SlotSampling.from_options(pre.sampling_options),
            max_new_tokens=sc.max_tokens or 16384,
            eos_ids=frozenset(() if sc.ignore_eos else
                              (sc.stop_token_ids_hidden or pre.eos_token_ids)),
            ctx=request.ctx,
        )

    async def generate(self, request: SingleIn) -> ManyOut:
        req = self.build_request(request)
        await self.core.submit(req)
        return self.stream_response(req, request)

    def stream_response(self, req: EngineRequest,
                        request: SingleIn) -> ManyOut:
        async def stream() -> AsyncIterator[Annotated[BackendOutput]]:
            while True:
                # bounded receive: every request ends in a FINISH sentinel
                # (even loop death routes through _fail_pending), but a hung
                # loop must not hang this stream forever — each timeout
                # polls the request's cancellation
                try:
                    item, payload = req.out_queue.get_nowait()
                except asyncio.QueueEmpty:
                    try:
                        item, payload = await asyncio.wait_for(
                            req.out_queue.get(), timeout=30.0)
                    except asyncio.TimeoutError:
                        if req.ctx is not None and req.ctx.is_killed:
                            return
                        continue
                if item is FINISH_SENTINEL:
                    reason: FinishReason = payload
                    yield Annotated.from_data(BackendOutput.final(reason))
                    return
                yield Annotated.from_data(BackendOutput(
                    token_ids=[item], log_probs=[payload],
                    cum_log_probs=None))

        return ResponseStream(stream(), request.ctx)
