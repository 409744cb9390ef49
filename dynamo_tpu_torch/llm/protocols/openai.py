"""OpenAI wire protocol: chat and completion requests, streaming chunks,
aggregation of a chunk stream into one response.

Counterpart of ``dynamo_tpu.llm.protocols.openai``, on dataclasses with
explicit validation instead of pydantic (the GPU machine has no pydantic):
``ChatCompletionRequest.from_dict`` and ``CompletionRequest.from_dict``
raise ``ValueError`` on a malformed body, which the HTTP layer turns into
a 400.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Any, Dict, List, Optional, Union

from .annotated import Annotated
from .common import FinishReason


def _opt(d: dict, key: str, types, what: str):
    """d[key] if present and not None, type-checked (bools are not ints)."""
    v = d.get(key)
    if v is None:
        return None
    if isinstance(v, bool) and bool not in (types if isinstance(types, tuple)
                                            else (types,)):
        raise ValueError(f"'{key}' must be {what}")
    if not isinstance(v, types):
        raise ValueError(f"'{key}' must be {what}")
    return v


@dataclasses.dataclass
class NvExt:
    """Framework extension fields (reference nvext.rs)."""

    ignore_eos: Optional[bool] = None
    use_raw_prompt: Optional[bool] = None
    annotations: Optional[List[str]] = None
    greed_sampling: Optional[bool] = None
    top_k: Optional[int] = None
    repetition_penalty: Optional[float] = None
    # speculative decoding: the most draft tokens verified a step (None =
    # the engine's default, 0 = off; clamped to the engine's spec_k)
    speculation: Optional[int] = None

    @classmethod
    def from_dict(cls, d: Any) -> "NvExt":
        if not isinstance(d, dict):
            raise ValueError("'nvext' must be an object")
        ann = _opt(d, "annotations", list, "a list of strings")
        if ann is not None and not all(isinstance(a, str) for a in ann):
            raise ValueError("'nvext.annotations' must be a list of strings")
        return cls(ignore_eos=_opt(d, "ignore_eos", bool, "a boolean"),
                   use_raw_prompt=_opt(d, "use_raw_prompt", bool,
                                       "a boolean"),
                   annotations=ann,
                   greed_sampling=_opt(d, "greed_sampling", bool, "a boolean"),
                   top_k=_opt(d, "top_k", int, "an integer"),
                   repetition_penalty=_opt(d, "repetition_penalty",
                                           (int, float), "a number"),
                   speculation=_opt(d, "speculation", int, "an integer"))


@dataclasses.dataclass
class StreamOptions:
    include_usage: Optional[bool] = None


def _stop(d: dict):
    stop = d.get("stop")
    if stop is not None and not (
            isinstance(stop, str)
            or (isinstance(stop, list)
                and all(isinstance(s, str) for s in stop))):
        raise ValueError("'stop' must be a string or a list of strings")
    return stop


def _stream_options(d: dict) -> Optional[StreamOptions]:
    so = d.get("stream_options")
    if so is None:
        return None
    if not isinstance(so, dict):
        raise ValueError("'stream_options' must be an object")
    return StreamOptions(include_usage=_opt(so, "include_usage", bool,
                                            "a boolean"))


def _max_tokens(d: dict, key: str, default: Optional[int]) -> Optional[int]:
    v = d.get(key, default)
    if v is not None and (not isinstance(v, int) or isinstance(v, bool)
                          or v < 1):
        raise ValueError(f"'{key}' must be a positive integer")
    return v


def _model(d: Any) -> str:
    if not isinstance(d, dict):
        raise ValueError("request body must be a JSON object")
    model = d.get("model")
    if not isinstance(model, str) or not model:
        raise ValueError("'model' must be a non-empty string")
    return model


@dataclasses.dataclass
class ChatMessage:
    role: str
    content: Optional[Union[str, List[Dict[str, Any]]]] = None
    name: Optional[str] = None
    tool_calls: Optional[List[Dict[str, Any]]] = None
    tool_call_id: Optional[str] = None

    @classmethod
    def from_dict(cls, d: Any) -> "ChatMessage":
        if not isinstance(d, dict):
            raise ValueError("each message must be an object")
        role = d.get("role")
        if not isinstance(role, str):
            raise ValueError("'messages[].role' must be a string")
        content = d.get("content")
        if content is not None and not (
                isinstance(content, str)
                or (isinstance(content, list)
                    and all(isinstance(p, dict) for p in content))):
            raise ValueError("'messages[].content' must be a string or a "
                             "list of content parts")
        calls = _opt(d, "tool_calls", list, "a list of objects")
        if calls is not None and not all(isinstance(c, dict) for c in calls):
            raise ValueError("'messages[].tool_calls' must be a list of "
                             "objects")
        return cls(role=role, content=content,
                   name=_opt(d, "name", str, "a string"),
                   tool_calls=calls,
                   tool_call_id=_opt(d, "tool_call_id", str, "a string"))

    def text(self) -> str:
        if self.content is None:
            return ""
        if isinstance(self.content, str):
            return self.content
        return "".join(part.get("text", "") for part in self.content
                       if part.get("type") == "text")


@dataclasses.dataclass
class ChatCompletionRequest:
    """`POST /v1/chat/completions` body (reference
    NvCreateChatCompletionRequest: async-openai CreateChatCompletionRequest +
    nvext)."""

    model: str
    messages: List[ChatMessage]
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    n: Optional[int] = 1
    stream: Optional[bool] = False
    stream_options: Optional[StreamOptions] = None
    stop: Optional[Union[str, List[str]]] = None
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    logprobs: Optional[bool] = None
    top_logprobs: Optional[int] = None
    seed: Optional[int] = None
    tools: Optional[List[Dict[str, Any]]] = None
    tool_choice: Optional[Union[str, Dict[str, Any]]] = None
    nvext: Optional[NvExt] = None

    @classmethod
    def from_dict(cls, d: Any) -> "ChatCompletionRequest":
        model = _model(d)
        messages = d.get("messages")
        if not isinstance(messages, list):
            raise ValueError("'messages' must be a list of messages")
        tools = _opt(d, "tools", list, "a list of objects")
        if tools is not None and not all(isinstance(t, dict) for t in tools):
            raise ValueError("'tools' must be a list of objects")
        choice = d.get("tool_choice")
        if choice is not None and not isinstance(choice, (str, dict)):
            raise ValueError("'tool_choice' must be a string or an object")
        num = (int, float)
        return cls(
            model=model,
            messages=[ChatMessage.from_dict(m) for m in messages],
            temperature=_opt(d, "temperature", num, "a number"),
            top_p=_opt(d, "top_p", num, "a number"),
            n=_opt(d, "n", int, "an integer") or 1,
            stream=bool(_opt(d, "stream", bool, "a boolean")),
            stream_options=_stream_options(d),
            stop=_stop(d),
            max_tokens=_max_tokens(d, "max_tokens", None),
            max_completion_tokens=_max_tokens(d, "max_completion_tokens",
                                              None),
            presence_penalty=_opt(d, "presence_penalty", num, "a number"),
            frequency_penalty=_opt(d, "frequency_penalty", num, "a number"),
            logprobs=_opt(d, "logprobs", bool, "a boolean"),
            top_logprobs=_opt(d, "top_logprobs", int, "an integer"),
            seed=_opt(d, "seed", int, "an integer"),
            tools=tools, tool_choice=choice,
            nvext=(NvExt.from_dict(d["nvext"])
                   if d.get("nvext") is not None else None))

    def stop_list(self) -> List[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)

    def effective_max_tokens(self) -> Optional[int]:
        if self.max_completion_tokens is not None:
            return self.max_completion_tokens
        return self.max_tokens


@dataclasses.dataclass
class CompletionRequest:
    """`POST /v1/completions` body."""

    model: str
    prompt: Union[str, List[int]]
    max_tokens: Optional[int] = 16
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    n: Optional[int] = 1
    stream: Optional[bool] = False
    stream_options: Optional[StreamOptions] = None
    logprobs: Optional[int] = None
    echo: Optional[bool] = False
    stop: Optional[Union[str, List[str]]] = None
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    seed: Optional[int] = None
    nvext: Optional[NvExt] = None

    @classmethod
    def from_dict(cls, d: Any) -> "CompletionRequest":
        model = _model(d)
        prompt = d.get("prompt")
        if isinstance(prompt, str):
            pass
        elif (isinstance(prompt, list) and prompt
              and all(isinstance(t, int) and not isinstance(t, bool)
                      and t >= 0 for t in prompt)):
            prompt = list(prompt)
        elif isinstance(prompt, list) and prompt and all(
                isinstance(p, (str, list)) for p in prompt):
            raise ValueError("batch prompts are not supported; send one "
                             "prompt per request")
        else:
            raise ValueError("'prompt' must be a string or a non-empty list "
                             "of token ids")
        num = (int, float)
        return cls(
            model=model, prompt=prompt,
            max_tokens=_max_tokens(d, "max_tokens", 16),
            temperature=_opt(d, "temperature", num, "a number"),
            top_p=_opt(d, "top_p", num, "a number"),
            n=_opt(d, "n", int, "an integer") or 1,
            stream=bool(_opt(d, "stream", bool, "a boolean")),
            stream_options=_stream_options(d),
            logprobs=_opt(d, "logprobs", int, "an integer"),
            echo=bool(_opt(d, "echo", bool, "a boolean")),
            stop=_stop(d),
            presence_penalty=_opt(d, "presence_penalty", num, "a number"),
            frequency_penalty=_opt(d, "frequency_penalty", num, "a number"),
            seed=_opt(d, "seed", int, "an integer"),
            nvext=(NvExt.from_dict(d["nvext"])
                   if d.get("nvext") is not None else None))

    def stop_list(self) -> List[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)


def _now() -> int:
    return int(time.time())


def usage_dict(prompt_tokens: int, completion_tokens: int) -> dict:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


class ChatDeltaGenerator:
    """Builds `chat.completion.chunk` dicts from engine text deltas.

    Reference: the chat delta generator (protocols/openai/chat_completions/delta.rs).
    One generator per request; the first text chunk carries the role.
    """

    def __init__(self, model: str, request_id: Optional[str] = None):
        self.id = request_id or f"chatcmpl-{uuid.uuid4().hex}"
        self.model = model
        self.created = _now()
        self._sent_role = False
        self.object = "chat.completion.chunk"

    def _chunk(self, choices: List[dict], usage: Optional[dict] = None) -> dict:
        out = {"id": self.id, "object": self.object, "created": self.created,
               "model": self.model, "choices": choices}
        if usage is not None:
            out["usage"] = usage
        return out

    def _delta(self, delta: dict) -> dict:
        if not self._sent_role:
            delta["role"] = "assistant"
            self._sent_role = True
        return delta

    def text_chunk(self, text: str, index: int = 0,
                   logprobs: Optional[dict] = None) -> dict:
        choice: dict = {"index": index,
                        "delta": self._delta({"content": text}),
                        "finish_reason": None}
        if logprobs is not None:
            choice["logprobs"] = logprobs
        return self._chunk([choice])

    def tool_calls_chunk(self, calls: List[dict], index: int = 0) -> dict:
        """One delta carrying the parsed tool calls, followed (by the
        caller) by a finish chunk with reason "tool_calls"."""
        delta = self._delta({"tool_calls": [
            {**call, "index": i} for i, call in enumerate(calls)]})
        return self._chunk([{"index": index, "delta": delta,
                             "finish_reason": None}])

    def finish_chunk(self, reason: FinishReason, index: int = 0) -> dict:
        return self._chunk([{"index": index, "delta": {},
                             "finish_reason": reason.to_openai()}])

    def usage_chunk(self, prompt_tokens: int, completion_tokens: int) -> dict:
        return self._chunk([], usage=usage_dict(prompt_tokens,
                                                completion_tokens))


class CompletionDeltaGenerator:
    """Builds `text_completion` streaming chunks."""

    def __init__(self, model: str, request_id: Optional[str] = None):
        self.id = request_id or f"cmpl-{uuid.uuid4().hex}"
        self.model = model
        self.created = _now()
        self.object = "text_completion"

    def text_chunk(self, text: str, index: int = 0,
                   logprobs: Optional[dict] = None) -> dict:
        choice: dict = {"index": index, "text": text, "finish_reason": None}
        if logprobs is not None:
            choice["logprobs"] = logprobs
        return {
            "id": self.id, "object": self.object, "created": self.created,
            "model": self.model, "choices": [choice],
        }

    def finish_chunk(self, reason: FinishReason, index: int = 0,
                     usage: Optional[dict] = None) -> dict:
        out = {
            "id": self.id, "object": self.object, "created": self.created,
            "model": self.model,
            "choices": [{"index": index, "text": "",
                         "finish_reason": reason.to_openai()}],
        }
        if usage is not None:
            out["usage"] = usage
        return out


def _chunks(stream):
    """The chunk dicts of an ``Annotated`` stream; an error item raises
    ``RuntimeError``."""
    async def gen():
        async for ann in stream:
            if isinstance(ann, Annotated):
                if ann.is_error:
                    raise RuntimeError(ann.error_message())
                chunk = ann.data
            else:
                chunk = ann
            if chunk is not None:
                yield chunk
    return gen()


async def aggregate_chat_stream(stream) -> dict:
    """Fold `Annotated[chunk-dict]` into one `chat.completion` response."""
    base: Optional[dict] = None
    texts: Dict[int, List[str]] = {}
    roles: Dict[int, str] = {}
    finish: Dict[int, Optional[str]] = {}
    tool_calls: Dict[int, list] = {}
    logprobs: Dict[int, list] = {}
    usage: Optional[dict] = None
    async for chunk in _chunks(stream):
        if base is None:
            base = {k: chunk.get(k) for k in ("id", "created", "model")}
        if chunk.get("usage"):
            usage = chunk["usage"]
        for choice in chunk.get("choices", []):
            idx = choice.get("index", 0)
            delta = choice.get("delta", {})
            if delta.get("role"):
                roles[idx] = delta["role"]
            if delta.get("content"):
                texts.setdefault(idx, []).append(delta["content"])
            if delta.get("tool_calls"):
                tool_calls.setdefault(idx, []).extend(delta["tool_calls"])
            if (choice.get("logprobs") or {}).get("content"):
                logprobs.setdefault(idx, []).extend(
                    choice["logprobs"]["content"])
            if choice.get("finish_reason"):
                finish[idx] = choice["finish_reason"]
    if base is None:
        raise RuntimeError("empty response stream")
    choices = []
    for idx in sorted(set(texts) | set(finish) | set(roles) | {0}):
        message: dict = {"role": roles.get(idx, "assistant"),
                         "content": "".join(texts.get(idx, []))}
        if tool_calls.get(idx):
            message["tool_calls"] = tool_calls[idx]
        choice = {"index": idx, "message": message,
                  "finish_reason": finish.get(idx, "stop")}
        if logprobs.get(idx):
            choice["logprobs"] = {"content": logprobs[idx]}
        choices.append(choice)
    out = {"id": base["id"], "object": "chat.completion",
           "created": base["created"], "model": base["model"],
           "choices": choices}
    if usage is not None:
        out["usage"] = usage
    return out


async def aggregate_completion_stream(stream) -> dict:
    """Fold `Annotated[chunk-dict]` into one `text_completion` response."""
    base: Optional[dict] = None
    texts: Dict[int, List[str]] = {}
    finish: Dict[int, Optional[str]] = {}
    lp_tokens: Dict[int, list] = {}
    lp_values: Dict[int, list] = {}
    usage: Optional[dict] = None
    async for chunk in _chunks(stream):
        if base is None:
            base = {k: chunk.get(k) for k in ("id", "created", "model")}
        if chunk.get("usage"):
            usage = chunk["usage"]
        for choice in chunk.get("choices", []):
            idx = choice.get("index", 0)
            if choice.get("text"):
                texts.setdefault(idx, []).append(choice["text"])
            lp = choice.get("logprobs") or {}
            if lp.get("token_logprobs"):
                lp_values.setdefault(idx, []).extend(lp["token_logprobs"])
                lp_tokens.setdefault(idx, []).extend(lp.get("tokens", []))
            if choice.get("finish_reason"):
                finish[idx] = choice["finish_reason"]
    if base is None:
        raise RuntimeError("empty response stream")
    choices = []
    for idx in sorted(set(texts) | set(finish) | {0}):
        choice = {
            "index": idx,
            "text": "".join(texts.get(idx, [])),
            "finish_reason": finish.get(idx, "stop"),
        }
        if lp_values.get(idx):
            choice["logprobs"] = {"token_logprobs": lp_values[idx],
                                  "tokens": lp_tokens.get(idx, [])}
        choices.append(choice)
    out = {
        "id": base["id"], "object": "text_completion",
        "created": base["created"], "model": base["model"],
        "choices": choices,
    }
    if usage is not None:
        out["usage"] = usage
    return out
