"""User python-file engines: ``pystr:<file.py>`` / ``pytok:<file.py>`` (a
copy of ``dynamo_tpu.llm.engines.python_file``).

Reference: lib/llm/src/engines/python.rs:57-354 — `dynamo-run out=pystr:f.py`
loads a user file exposing ``async def generate(request)`` and adapts its
async generator to the engine stream. `pystr` speaks strings at the OpenAI
level (each yield is a text delta); `pytok` speaks the engine-internal token
protocol (each yield is token ids), sitting behind the preprocessor/
detokenizer link like any core engine.

The user file may optionally expose ``async def init(engine_args: dict)``,
called once before the first request (the reference passes model metadata to
the loaded module the same way).

Example pystr file::

    async def generate(request):
        prompt = request["messages"][-1]["content"]
        for word in prompt.split():
            yield word + " "

Example pytok file::

    async def generate(request):
        for tid in request["token_ids"]:
            yield {"token_ids": [tid]}
"""

from __future__ import annotations

import asyncio
import dataclasses
import importlib.util
import inspect
import os
from typing import Any, AsyncIterator, Optional

from ...runtime.engine import AsyncEngine, ManyOut, ResponseStream, SingleIn
from ..protocols.annotated import Annotated
from ..protocols.common import (BackendOutput, FinishReason,
                                PreprocessedRequest)
from ..protocols.openai import ChatDeltaGenerator, CompletionDeltaGenerator

__all__ = ["load_user_generate", "PythonFileEngineFull",
           "PythonFileEngineCore"]


def load_user_generate(path: str) -> tuple:
    """Import ``path`` as a module; returns (generate, init|None)."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"python engine file not found: {path}")
    name = f"_dyn_user_engine_{abs(hash(path)) & 0xFFFFFF:x}"
    spec = importlib.util.spec_from_file_location(name, path)
    assert spec is not None and spec.loader is not None
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    gen = getattr(mod, "generate", None)
    if gen is None or not (inspect.isasyncgenfunction(gen)
                           or inspect.iscoroutinefunction(gen)):
        raise TypeError(
            f"{path} must define `async def generate(request)` "
            "(async generator)")
    return gen, getattr(mod, "init", None)


class _PythonFileEngineBase(AsyncEngine):
    def __init__(self, path: str, engine_args: Optional[dict] = None):
        self.path = path
        self.engine_args = engine_args or {}
        self._generate, self._init = load_user_generate(path)
        self._initialized = self._init is None
        self._init_lock: Optional[asyncio.Lock] = None

    async def _ensure_init(self) -> None:
        if self._initialized:
            return
        if self._init_lock is None:
            self._init_lock = asyncio.Lock()
        async with self._init_lock:
            if not self._initialized:
                await self._init(dict(self.engine_args))
                self._initialized = True  # only a successful init latches

    def _user_stream(self, request: Any) -> AsyncIterator[Any]:
        out = self._generate(request)
        if inspect.isasyncgen(out):
            return out

        async def once():  # plain coroutine returning one item
            yield await out
        return once()


class PythonFileEngineFull(_PythonFileEngineBase):
    """`pystr:` — user yields add to the response text; request arrives as
    the raw OpenAI dict (chat or completion)."""

    async def generate(self, request: SingleIn) -> ManyOut:
        await self._ensure_init()
        req = request.data      # the OpenAI body, as the HTTP layer got it
        ctx = request.ctx
        is_chat = "messages" in req
        gen_cls = ChatDeltaGenerator if is_chat else CompletionDeltaGenerator
        prefix = "chatcmpl" if is_chat else "cmpl"
        delta_gen = gen_cls(req.get("model", "python"),
                            request_id=f"{prefix}-{request.id}")
        user = self._user_stream(req)

        async def stream() -> AsyncIterator[Annotated[dict]]:
            async for item in user:
                if ctx.is_stopped:
                    await user.aclose()
                    break
                yield Annotated.from_data(delta_gen.text_chunk(str(item)))
            yield Annotated.from_data(delta_gen.finish_chunk(FinishReason.STOP))

        return ResponseStream(stream(), ctx)


class PythonFileEngineCore(_PythonFileEngineBase):
    """`pytok:` — token-in/token-out. The user sees the PreprocessedRequest
    as a dict; each yield is `{"token_ids": [...], ...}` or a bare list of
    token ids. Honors max_tokens like a real engine would."""

    async def generate(self, request: SingleIn) -> ManyOut:
        await self._ensure_init()
        pre: PreprocessedRequest = request.data
        req_dict = dataclasses.asdict(pre)
        ctx = request.ctx
        max_tokens = pre.stop_conditions.max_tokens
        user = self._user_stream(req_dict)

        async def stream() -> AsyncIterator[Annotated[BackendOutput]]:
            emitted = 0
            finish = FinishReason.STOP
            async for item in user:
                if ctx.is_stopped:
                    await user.aclose()
                    finish = None
                    break
                if isinstance(item, dict):
                    out = BackendOutput.from_dict(item)
                else:
                    toks = item if isinstance(item, (list, tuple)) else [item]
                    out = BackendOutput(token_ids=[int(t) for t in toks])
                if max_tokens is not None \
                        and emitted + len(out.token_ids) > max_tokens:
                    out.token_ids = out.token_ids[:max_tokens - emitted]
                emitted += len(out.token_ids)
                yield Annotated.from_data(out)
                if out.finish_reason is not None:
                    finish = None  # user already closed the stream
                    break
                if max_tokens is not None and emitted >= max_tokens:
                    await user.aclose()
                    finish = FinishReason.LENGTH  # cap cut the stream
                    break
            if finish is not None:
                yield Annotated.from_data(BackendOutput.final(finish))

        return ResponseStream(stream(), ctx)
