"""OpenAI chat / completions → engine-internal preprocessing (and the
backward delta path).

Counterpart of ``dynamo_tpu.llm.preprocessor``: a chat request's messages
are rendered through the model's chat template (``chat_template.py``, no
jinja2) and tokenized, a completion's text prompt is tokenized and a
token-id prompt taken as it is; the request's sampling / stop options
merge with the model's EOS ids into a ``PreprocessedRequest``, with the
``token_ids`` / ``formatted_prompt`` annotations on request. On the way
back, ``BackendOutput`` deltas become ``chat.completion.chunk`` or
``text_completion`` chunks; a chat request with tools buffers its text
and ends in the tool calls it parses (``tools.py``). ``n`` > 1 is the HTTP
layer's fan-out, as in the JAX package.
"""

from __future__ import annotations

from typing import AsyncIterator, List, Optional, Tuple

from ..runtime.engine import AsyncEngine, ManyOut, ResponseStream, SingleIn
from ..runtime.pipeline import Operator
from .chat_template import ChatTemplate
from .model_card import ModelDeploymentCard
from .protocols.annotated import Annotated
from .protocols.common import (BackendOutput, FinishReason, OutputOptions,
                               PreprocessedRequest, SamplingOptions,
                               StopConditions)
from .protocols.openai import (ChatCompletionRequest, ChatDeltaGenerator,
                               CompletionDeltaGenerator, CompletionRequest,
                               usage_dict)
from .tools import ToolCallingMatcher, ToolChoice

ANNOTATION_TOKEN_IDS = "token_ids"
ANNOTATION_FORMATTED_PROMPT = "formatted_prompt"

_FALLBACK_TEMPLATE = (
    "{% for message in messages %}"
    "<|{{ message.role }}|>\n{{ message.content }}\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
)


class PromptFormatter:
    """HF chat-template renderer (reference template/oai.rs +
    formatters.rs), on ``chat_template.ChatTemplate``."""

    def __init__(self, template: Optional[str], bos_token: str = "",
                 eos_token: str = ""):
        self._template = ChatTemplate(template or _FALLBACK_TEMPLATE)
        self.bos_token = bos_token
        self.eos_token = eos_token

    def render(self, messages: List[dict], add_generation_prompt: bool = True,
               tools: Optional[List[dict]] = None, **extra) -> str:
        return self._template.render(
            messages=messages,
            add_generation_prompt=add_generation_prompt,
            bos_token=self.bos_token, eos_token=self.eos_token,
            tools=tools, **extra)


class OpenAIPreprocessor(Operator):
    """Chat/completions → PreprocessedRequest operator.

    forward: validate + render + tokenize + merge options
    backward: BackendOutput deltas → OpenAI chunks via the delta generators
    """

    def __init__(self, mdc: ModelDeploymentCard):
        self.mdc = mdc
        self.tokenizer = mdc.tokenizer()
        bos = ""
        if mdc.model_info.bos_token_id is not None:
            bos = self.tokenizer.id_to_token(mdc.model_info.bos_token_id) or ""
        eos = ""
        if mdc.model_info.eos_token_ids:
            eos = self.tokenizer.id_to_token(mdc.model_info.eos_token_ids[0]) or ""
        self.formatter = PromptFormatter(
            mdc.prompt_format.chat_template, bos_token=bos, eos_token=eos)

    def _preprocess_chat(self, req: ChatCompletionRequest
                         ) -> Tuple[PreprocessedRequest, str]:
        """Returns (request, formatted_prompt) — kept stateless so one
        operator instance serves concurrent requests."""
        use_raw = bool(req.nvext and req.nvext.use_raw_prompt)
        if use_raw and len(req.messages) == 1:
            prompt = req.messages[0].text()
        else:
            messages = []
            for m in req.messages:
                d = {"role": m.role, "content": m.text()}
                if m.name:
                    d["name"] = m.name
                if m.tool_calls:
                    d["tool_calls"] = m.tool_calls
                messages.append(d)
            prompt = self.formatter.render(messages, tools=req.tools)
        token_ids = self.tokenizer.encode(prompt).ids
        pre = self._common(req, token_ids, req.effective_max_tokens(),
                           req.stop_list())
        pre.annotations = list((req.nvext.annotations if req.nvext else None)
                               or [])
        return pre, prompt

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

    def _common(self, req, token_ids: List[int], max_tokens: Optional[int],
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
            repetition_penalty=(nvext.repetition_penalty if nvext else None),
            greedy=bool(nvext and nvext.greed_sampling),
        )
        # chat: `logprobs` is a bool + `top_logprobs` a count;
        # completions: `logprobs` IS the count.
        want = req.logprobs
        if isinstance(want, bool):
            n_logprobs = (getattr(req, "top_logprobs", None) or 1) if want else None
        else:
            n_logprobs = want
        return PreprocessedRequest(
            token_ids=token_ids,
            stop_conditions=stop_conditions,
            sampling_options=sampling,
            output_options=OutputOptions(logprobs=n_logprobs),
            eos_token_ids=list(info.eos_token_ids),
            # the request's draft budget (engine/spec/); None: the
            # serving engine's default
            speculation=(nvext.speculation if nvext else None),
        )

    async def generate(self, request: SingleIn, next_engine: AsyncEngine) -> ManyOut:
        req = request.data
        if isinstance(req, dict):
            req = (ChatCompletionRequest.from_dict(req) if "messages" in req
                   else CompletionRequest.from_dict(req))
        is_chat = isinstance(req, ChatCompletionRequest)
        if is_chat:
            pre, formatted_prompt = self._preprocess_chat(req)
        else:
            pre = self.preprocess_completion(req)
            formatted_prompt = None
        prompt_len = len(pre.token_ids)
        annotations: List[Annotated] = []
        if ANNOTATION_TOKEN_IDS in pre.annotations:
            annotations.append(Annotated.from_annotation(
                ANNOTATION_TOKEN_IDS, pre.token_ids))
        if is_chat and ANNOTATION_FORMATTED_PROMPT in pre.annotations:
            annotations.append(Annotated.from_annotation(
                ANNOTATION_FORMATTED_PROMPT, formatted_prompt))

        # Tool calling (reference preprocessor/tools.rs): when tools are in
        # play the full message must be inspected, so text is buffered and
        # either re-emitted verbatim or replaced by tool_calls at finish.
        # Validation happens BEFORE engine dispatch — a malformed request
        # must not leak an orphaned in-flight generation.
        matcher = None
        if is_chat:
            choice = ToolChoice(req.tool_choice, has_tools=bool(req.tools))
            if choice.active and not req.tools:
                raise ValueError(
                    "tool_choice requires a non-empty tools list")
            if req.tools and choice.active:
                matcher = ToolCallingMatcher(choice)

        downstream = await next_engine.generate(request.transfer(pre))
        gen = (ChatDeltaGenerator(req.model, request_id=f"chatcmpl-{request.id}")
               if is_chat else
               CompletionDeltaGenerator(req.model,
                                        request_id=f"cmpl-{request.id}"))
        # engines report chosen-token logprobs unconditionally; the wire
        # only carries them when the client asked (OpenAI conformance)
        want_logprobs = pre.output_options.logprobs is not None

        async def backward() -> AsyncIterator[Annotated[dict]]:
            for ann in annotations:
                yield ann
            completion_tokens = 0
            finished = False
            buffered: List[str] = []
            buffered_logprobs: List[dict] = []

            def chat_end_chunks(reason: FinishReason) -> List[dict]:
                """Finish-time chunks for the chat path, applying the tool
                matcher to the buffered message when active. Raises
                ValueError when a required tool call is missing — but only
                for clean finishes: a cancelled or truncated generation is
                reported as its real finish reason, not a tool error."""
                chunks: List[dict] = []
                if matcher is not None:
                    full = "".join(buffered)
                    clean = reason in (FinishReason.EOS, FinishReason.STOP)
                    try:
                        calls = matcher.get_calls(full)
                    except ValueError:
                        if clean:
                            raise
                        calls = []
                    if calls:
                        chunks.append(gen.tool_calls_chunk(calls))
                        reason = FinishReason.TOOL_CALLS
                    elif full:
                        merged = None
                        if buffered_logprobs:
                            merged = {"content": [
                                e for lp in buffered_logprobs
                                for e in lp.get("content", [])]}
                        chunks.append(gen.text_chunk(full, logprobs=merged))
                chunks.append(gen.finish_chunk(reason))
                # Usage always rides the stream; the HTTP layer drops it for
                # SSE clients that didn't opt in, and the unary aggregator
                # folds it into the response.
                chunks.append(gen.usage_chunk(prompt_len, completion_tokens))
                return chunks

            def end(reason: FinishReason) -> List[Annotated]:
                if not is_chat:
                    return [Annotated.from_data(gen.finish_chunk(
                        reason,
                        usage=usage_dict(prompt_len, completion_tokens)))]
                try:
                    return [Annotated.from_data(c)
                            for c in chat_end_chunks(reason)]
                except ValueError as e:
                    return [Annotated.from_error(str(e))]

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
                if text is None and out.tokens:
                    text = "".join(out.tokens)
                logprobs = (_format_logprobs(out, is_chat)
                            if want_logprobs else None)
                if matcher is not None and (text or logprobs is not None):
                    # nothing escapes mid-buffer: empty-text deltas carrying
                    # logprobs are buffered too
                    if text:
                        buffered.append(text)
                    if logprobs is not None:
                        buffered_logprobs.append(logprobs)
                elif text or logprobs is not None:
                    yield Annotated.from_data(
                        gen.text_chunk(text or "", logprobs=logprobs))
                if out.finish_reason is not None:
                    finished = True
                    for ann in end(out.finish_reason):
                        yield ann
            if not finished and not request.ctx.is_killed:
                reason = (FinishReason.CANCELLED if request.ctx.is_stopped
                          else FinishReason.STOP)
                for ann in end(reason):
                    yield ann

        return ResponseStream(backward(), request.ctx)


def _format_logprobs(out: BackendOutput, is_chat: bool) -> Optional[dict]:
    if out.log_probs is None:
        return None
    if is_chat:
        content = []
        for i, lp in enumerate(out.log_probs):
            tok = (out.tokens[i] if out.tokens and i < len(out.tokens) else "")
            entry = {"token": tok, "logprob": lp, "top_logprobs": []}
            if out.top_logprobs and i < len(out.top_logprobs):
                entry["top_logprobs"] = [
                    {"token": str(t), "logprob": p}
                    for t, p in out.top_logprobs[i].items()]
            content.append(entry)
        return {"content": content}
    return {"token_logprobs": list(out.log_probs),
            "tokens": list(out.tokens or [])}
