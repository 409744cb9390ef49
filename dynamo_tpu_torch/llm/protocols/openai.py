"""OpenAI completions wire protocol: request validation, streaming chunks,
aggregation of a chunk stream into one response.

Counterpart of the completions half of ``dynamo_tpu.llm.protocols.openai``,
on dataclasses with explicit validation instead of pydantic (the GPU
machine has no pydantic): ``CompletionRequest.from_dict`` raises
``ValueError`` on a malformed body, which the HTTP layer turns into a 400.
Chat completions are not ported yet.
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
    annotations: Optional[List[str]] = None
    greed_sampling: Optional[bool] = None
    top_k: Optional[int] = None

    @classmethod
    def from_dict(cls, d: Any) -> "NvExt":
        if not isinstance(d, dict):
            raise ValueError("'nvext' must be an object")
        ann = _opt(d, "annotations", list, "a list of strings")
        if ann is not None and not all(isinstance(a, str) for a in ann):
            raise ValueError("'nvext.annotations' must be a list of strings")
        return cls(ignore_eos=_opt(d, "ignore_eos", bool, "a boolean"),
                   annotations=ann,
                   greed_sampling=_opt(d, "greed_sampling", bool, "a boolean"),
                   top_k=_opt(d, "top_k", int, "an integer"))


@dataclasses.dataclass
class StreamOptions:
    include_usage: Optional[bool] = None


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
        if not isinstance(d, dict):
            raise ValueError("request body must be a JSON object")
        model = d.get("model")
        if not isinstance(model, str) or not model:
            raise ValueError("'model' must be a non-empty string")
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
        stop = d.get("stop")
        if stop is not None and not (
                isinstance(stop, str)
                or (isinstance(stop, list)
                    and all(isinstance(s, str) for s in stop))):
            raise ValueError("'stop' must be a string or a list of strings")
        so = d.get("stream_options")
        if so is not None and not isinstance(so, dict):
            raise ValueError("'stream_options' must be an object")
        max_tokens = d.get("max_tokens", 16)
        if max_tokens is not None and (
                not isinstance(max_tokens, int) or isinstance(max_tokens, bool)
                or max_tokens < 1):
            raise ValueError("'max_tokens' must be a positive integer")
        return cls(
            model=model, prompt=prompt, max_tokens=max_tokens,
            temperature=_opt(d, "temperature", num, "a number"),
            top_p=_opt(d, "top_p", num, "a number"),
            n=_opt(d, "n", int, "an integer") or 1,
            stream=bool(_opt(d, "stream", bool, "a boolean")),
            stream_options=(StreamOptions(include_usage=_opt(
                so, "include_usage", bool, "a boolean"))
                if so is not None else None),
            logprobs=_opt(d, "logprobs", int, "an integer"),
            echo=bool(_opt(d, "echo", bool, "a boolean")),
            stop=stop,
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


async def aggregate_completion_stream(stream) -> dict:
    """Fold `Annotated[chunk-dict]` into one `text_completion` response."""
    base: Optional[dict] = None
    texts: Dict[int, List[str]] = {}
    finish: Dict[int, Optional[str]] = {}
    lp_tokens: Dict[int, list] = {}
    lp_values: Dict[int, list] = {}
    usage: Optional[dict] = None
    async for ann in stream:
        if isinstance(ann, Annotated):
            if ann.is_error:
                raise RuntimeError(ann.error_message())
            chunk = ann.data
        else:
            chunk = ann
        if chunk is None:
            continue
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
