"""OpenAI completions → engine-internal preprocessing (and the backward
delta path).

Counterpart of the completion path of ``dynamo_tpu.llm.preprocessor``
(``preprocess_completion``): a text prompt is tokenized, a token-id prompt
is taken as it is, and the request's sampling / stop options merge with
the model's EOS ids into a ``PreprocessedRequest``. On the way back,
``BackendOutput`` deltas become ``text_completion`` chunks, the last one
carrying the finish reason and usage. Chat templates are not ported yet.
"""

from __future__ import annotations

from typing import AsyncIterator, List, Optional

from ..runtime.engine import AsyncEngine, ManyOut, ResponseStream, SingleIn
from ..runtime.pipeline import Operator
from .model_card import ModelDeploymentCard
from .protocols.annotated import Annotated
from .protocols.common import (BackendOutput, FinishReason, OutputOptions,
                               PreprocessedRequest, SamplingOptions,
                               StopConditions)
from .protocols.openai import (CompletionDeltaGenerator, CompletionRequest,
                               usage_dict)

ANNOTATION_TOKEN_IDS = "token_ids"


class OpenAIPreprocessor(Operator):
    """Completions → PreprocessedRequest operator.

    forward: validate + tokenize + merge options
    backward: BackendOutput deltas → OpenAI chunks via the delta generator
    """

    def __init__(self, mdc: ModelDeploymentCard):
        self.mdc = mdc
        self.tokenizer = mdc.tokenizer()

    def preprocess_completion(self, req: CompletionRequest) -> PreprocessedRequest:
        if isinstance(req.prompt, str):
            token_ids = self.tokenizer.encode(req.prompt).ids
        else:
            token_ids = list(req.prompt)  # pre-tokenized
        vocab = self.mdc.model_info.vocab_size
        if vocab and any(t >= vocab for t in token_ids):
            raise ValueError(f"prompt token id out of range (vocab {vocab})")
        pre = self._common(req, token_ids, req.max_tokens, req.stop_list())
        pre.annotations = list((req.nvext.annotations if req.nvext else None)
                               or [])
        return pre

    def _common(self, req: CompletionRequest, token_ids: List[int],
                max_tokens: Optional[int],
                stops: List[str]) -> PreprocessedRequest:
        info = self.mdc.model_info
        budget = info.context_length - len(token_ids)
        if budget <= 0:
            raise ValueError(
                f"prompt length {len(token_ids)} exceeds model context "
                f"{info.context_length}")
        nvext = req.nvext
        stop_conditions = StopConditions(
            max_tokens=min(max_tokens, budget) if max_tokens is not None else budget,
            stop=stops or None,
            stop_token_ids_hidden=list(info.eos_token_ids),
            ignore_eos=bool(nvext and nvext.ignore_eos),
        )
        stop_conditions.apply_ignore_eos()
        sampling = SamplingOptions(
            n=req.n or 1,
            temperature=req.temperature,
            top_p=req.top_p,
            top_k=(nvext.top_k if nvext else None),
            seed=req.seed,
            frequency_penalty=req.frequency_penalty,
            presence_penalty=req.presence_penalty,
            greedy=bool(nvext and nvext.greed_sampling),
        )
        return PreprocessedRequest(
            token_ids=token_ids,
            stop_conditions=stop_conditions,
            sampling_options=sampling,
            output_options=OutputOptions(logprobs=req.logprobs),
            eos_token_ids=list(info.eos_token_ids),
        )

    async def generate(self, request: SingleIn, next_engine: AsyncEngine) -> ManyOut:
        req = request.data
        if isinstance(req, dict):
            req = CompletionRequest.from_dict(req)
        if (req.n or 1) != 1:
            raise ValueError("'n' > 1 is not supported")
        pre = self.preprocess_completion(req)
        prompt_len = len(pre.token_ids)
        annotations: List[Annotated] = []
        if ANNOTATION_TOKEN_IDS in pre.annotations:
            annotations.append(Annotated.from_annotation(
                ANNOTATION_TOKEN_IDS, pre.token_ids))
        downstream = await next_engine.generate(request.transfer(pre))
        gen = CompletionDeltaGenerator(req.model,
                                       request_id=f"cmpl-{request.id}")
        # engines report chosen-token logprobs unconditionally; the wire
        # only carries them when the client asked (OpenAI conformance)
        want_logprobs = pre.output_options.logprobs is not None

        async def backward() -> AsyncIterator[Annotated[dict]]:
            for ann in annotations:
                yield ann
            completion_tokens = 0
            finished = False
            async for item in downstream:
                if isinstance(item, Annotated):
                    if item.data is None:
                        yield item  # pass through errors/annotations
                        continue
                    out: BackendOutput = item.data
                else:
                    out = item
                completion_tokens += len(out.token_ids)
                text = out.text
                logprobs = None
                if want_logprobs and out.log_probs is not None:
                    logprobs = {"token_logprobs": list(out.log_probs),
                                "tokens": list(out.tokens or [])}
                if text or logprobs is not None:
                    yield Annotated.from_data(
                        gen.text_chunk(text or "", logprobs=logprobs))
                if out.finish_reason is not None:
                    finished = True
                    yield Annotated.from_data(gen.finish_chunk(
                        out.finish_reason,
                        usage=usage_dict(prompt_len, completion_tokens)))
            if not finished and not request.ctx.is_killed:
                reason = (FinishReason.CANCELLED if request.ctx.is_stopped
                          else FinishReason.STOP)
                yield Annotated.from_data(gen.finish_chunk(
                    reason, usage=usage_dict(prompt_len, completion_tokens)))

        return ResponseStream(backward(), request.ctx)
