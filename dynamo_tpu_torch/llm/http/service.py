"""OpenAI-compatible HTTP frontend on the standard library.

Counterpart of ``dynamo_tpu.llm.http.service``, built on
``asyncio.start_server`` because the GPU machine has no aiohttp:
``POST /v1/chat/completions`` and ``POST /v1/completions`` as one JSON body
or as Server-Sent Events ending in ``data: [DONE]``, ``GET /v1/models``,
``GET /metrics`` (``metrics.py``), ``GET /health``, ``GET /live`` and
``GET /debug?last=N`` (every engine's flight recorder in this process:
its stats and last N per-dispatch records, JAX's ``flight_recorders``
layout).
``n`` > 1 fans out into n single-choice requests merged into one stream;
``nvext.deadline_ms`` or the ``X-Request-Deadline-Ms`` header arms the
request's deadline. Status codes and error bodies
(``{"error": {"message", "type", "code"}}``) are the JAX service's. Each
connection serves one request (``Connection: close``). A client that
disconnects mid-stream kills the request's context, so the engine frees its
slot at the next step. A stream whose source fails mid-way (a remote worker
lost) ends in an SSE ``event: error`` carrying the message and no
``[DONE]``; the JAX service drops the connection there. ``/traces`` and ``/debug``'s ``tracer`` member wait
for the port's tracing (ROADMAP A10).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
import urllib.parse
from typing import Dict, Optional, Tuple

from ...runtime.engine import AsyncEngine, Context, EngineContext
from ..protocols.annotated import Annotated
from ..protocols.openai import (aggregate_chat_stream,
                                aggregate_completion_stream, usage_dict)
from ..protocols.sse import encode_annotated, encode_done
from .metrics import ServiceMetrics

logger = logging.getLogger("dynamo_tpu_torch.http")

MAX_BODY = 16 << 20       # request bodies above this are refused (413)
_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            500: "Internal Server Error"}


class ModelManager:
    """Named engine registry (reference `ModelManager`, service_v2.rs)."""

    def __init__(self) -> None:
        self._chat: Dict[str, AsyncEngine] = {}
        self._completion: Dict[str, AsyncEngine] = {}

    def add_chat_model(self, name: str, engine: AsyncEngine) -> None:
        self._chat[name] = engine

    def add_completion_model(self, name: str, engine: AsyncEngine) -> None:
        self._completion[name] = engine

    def chat_engine(self, name: str) -> Optional[AsyncEngine]:
        return self._chat.get(name)

    def completion_engine(self, name: str) -> Optional[AsyncEngine]:
        return self._completion.get(name)

    def list_models(self) -> list:
        return sorted(set(self._chat) | set(self._completion))


class _HttpError(Exception):
    def __init__(self, status: int, message: str,
                 err_type: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.message = message
        self.err_type = err_type


def _head(status: int, headers: Dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Status')}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    lines.append("Connection: close")
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


def _json_response(status: int, payload, extra: Optional[dict] = None) -> bytes:
    body = json.dumps(payload).encode()
    headers = {"Content-Type": "application/json",
               "Content-Length": str(len(body)), **(extra or {})}
    return _head(status, headers) + body


def _error_response(status: int, message: str,
                    err_type: str = "invalid_request_error") -> bytes:
    return _json_response(status, {"error": {
        "message": message, "type": err_type, "code": status}})


def _chunk_token_count(chunk) -> int:
    """Text-bearing choices in an OpenAI chunk (for the output-token metric)."""
    if not isinstance(chunk, dict):
        return 0
    n = 0
    for choice in chunk.get("choices") or []:
        delta = choice.get("delta")
        if delta is not None:
            if delta.get("content"):
                n += 1
        elif choice.get("text"):
            n += 1
    return n


MAX_N = 16          # parallel-sampling fan-out cap (engine slots are finite)


class _FanoutContext(EngineContext):
    """Parent context of an n>1 request: cancellation fans out to every
    per-choice child generation."""

    __slots__ = ("children",)

    def __init__(self):
        super().__init__()
        self.children: list = []

    def stop_generating(self) -> None:
        super().stop_generating()
        for c in self.children:
            c.stop_generating()

    def kill(self) -> None:
        super().kill()
        for c in self.children:
            c.kill()


async def _merge_choice_streams(streams, ectx: _FanoutContext):
    """n independent single-choice streams → one multi-choice stream
    (OpenAI `n` semantics): choice indices are rewritten to the sub-stream
    slot, chunk identity (id/created/model) is normalized to one stream's
    (each child pipeline minted its own), and per-stream usage folds into
    ONE trailing usage chunk — prompt counted once, completions summed.
    A child failure kills the sibling generations (their slots must not
    stay held) before the error surfaces."""
    q: asyncio.Queue = asyncio.Queue(maxsize=4)   # backpressure: children
    done = object()                               # run at consumer speed

    async def pump(i, s):
        try:
            async for item in s:
                await q.put((i, item, None))
        except Exception as e:  # noqa: BLE001 — surfaced to the consumer
            await q.put((i, None, e))
        finally:
            await q.put((i, done, None))

    tasks = [asyncio.create_task(pump(i, s))
             for i, s in enumerate(streams)]
    usages: Dict[int, dict] = {}
    template: Optional[dict] = None
    pending = len(streams)
    try:
        while pending:
            i, item, err = await q.get()
            if err is not None:
                ectx.kill()               # reap the sibling generations
                raise err
            if item is done:
                pending -= 1
                continue
            ann = (item if isinstance(item, Annotated)
                   else Annotated.from_data(item))
            chunk = ann.data
            if isinstance(chunk, dict):
                if template is None and chunk.get("id"):
                    template = {k: chunk.get(k)
                                for k in ("id", "object", "created",
                                          "model")}
                elif template is not None and chunk.get("id"):
                    # one id per SSE stream (OpenAI contract) — children
                    # minted their own
                    chunk.update(template)
                for c in chunk.get("choices") or []:
                    c["index"] = i
                if chunk.get("usage") is not None:
                    usages[i] = chunk.pop("usage")
                    if not chunk.get("choices"):
                        continue          # combined usage emitted at the end
            yield ann
        if usages:
            vals = list(usages.values())
            combined = usage_dict(
                vals[0].get("prompt_tokens", 0),
                sum(v.get("completion_tokens", 0) for v in vals))
            yield Annotated.from_data({**(template or {}), "choices": [],
                                       "usage": combined})
    finally:
        for t in tasks:
            t.cancel()


async def _start_fanout(engine, body: dict, ectx: _FanoutContext, n: int):
    """Launch n single-choice generations concurrently for one request.
    Seeded requests get seed+i per choice (reproducible but decorrelated);
    unseeded requests get a fresh random base per request. The prompt
    prefills n times and holds n engine slots (the prefix cache absorbs
    the repeats)."""
    import random

    base = (int(body["seed"]) if body.get("seed") is not None
            else random.getrandbits(31))

    async def one(i: int):
        sub = dict(body)
        sub["n"] = 1
        sub["seed"] = base + i
        sctx = EngineContext(f"{ectx.id}-c{i}")
        sctx.deadline_s = ectx.deadline_s   # children inherit the budget
        ectx.children.append(sctx)
        return await engine.generate(Context(sub, sctx))

    results = await asyncio.gather(*(one(i) for i in range(n)),
                                   return_exceptions=True)
    errs = [r for r in results if isinstance(r, BaseException)]
    if errs:
        ectx.kill()          # reap the children that did start
        raise errs[0]
    return _merge_choice_streams(list(results), ectx)


def _debug(query: str) -> dict:
    """``GET /debug``: each in-process engine's flight recorder (stats and
    its last ``last`` records, 64 by default), as the JAX service lays
    them out."""
    from ...engine.flight_recorder import all_recorders
    params = urllib.parse.parse_qs(query)
    try:
        last = int(params.get("last", ["64"])[0])
    except ValueError:
        last = 64
    return {"flight_recorders": {
        name: {"stats": fr.stats(), "records": fr.dump(last=last)}
        for name, fr in all_recorders().items()}}


async def _read_request(reader: asyncio.StreamReader
                        ) -> Tuple[str, str, Dict[str, str], bytes]:
    line = await reader.readline()
    if not line:
        raise ConnectionError("client closed before sending a request")
    parts = line.decode("latin-1").split()
    if len(parts) != 3:
        raise _HttpError(400, "malformed request line")
    method, target, _version = parts
    headers: Dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    try:
        n = int(headers.get("content-length", "0"))
    except ValueError:
        raise _HttpError(400, "invalid Content-Length") from None
    if n < 0 or n > MAX_BODY:
        raise _HttpError(413, f"body larger than {MAX_BODY} bytes")
    body = await reader.readexactly(n) if n else b""
    return method, target, headers, body


class HttpService:
    """The frontend server (reference `HttpService`)."""

    def __init__(self, port: int = 8080, host: str = "0.0.0.0",
                 manager: Optional[ModelManager] = None,
                 metrics: Optional[ServiceMetrics] = None):
        self.port = port
        self.host = host
        self.manager = manager or ModelManager()
        self.metrics = metrics or ServiceMetrics()
        self._server: Optional[asyncio.AbstractServer] = None
        self._tasks: set = set()

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        if self._server is not None:
            return
        self._server = await asyncio.start_server(self._on_client, self.host,
                                                  self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        logger.info("HTTP service listening on %s:%s", self.host, self.port)

    async def stop(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.close()
            for t in list(self._tasks):
                t.cancel()
            await asyncio.gather(*self._tasks, return_exceptions=True)
            await server.wait_closed()

    async def run_forever(self) -> None:
        await self.start()
        try:
            while True:
                await asyncio.sleep(3600)
        finally:
            await self.stop()

    # ------------------------------------------------------------- handlers
    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._tasks.add(task)
        try:
            try:
                method, target, headers, body = await _read_request(reader)
                await self._route(method, target, headers, body, reader,
                                  writer)
            except _HttpError as e:
                writer.write(_error_response(e.status, e.message, e.err_type))
            except (ConnectionError, asyncio.IncompleteReadError):
                return
            await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass
        except Exception:  # noqa: BLE001 — one connection's failure must
            # not take the server down; it is logged with its traceback
            logger.exception("HTTP connection failed")
        finally:
            self._tasks.discard(task)
            writer.close()

    async def _route(self, method: str, target: str,
                     headers: Dict[str, str], body: bytes,
                     reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        path, _, query = target.partition("?")
        endpoint = {"/v1/chat/completions": "chat_completions",
                    "/v1/completions": "completions"}.get(path)
        want = "POST" if endpoint else "GET"
        if endpoint is None and path not in ("/health", "/live",
                                             "/v1/models", "/metrics",
                                             "/debug"):
            raise _HttpError(404, f"no route for {path}", "not_found")
        if method != want:
            raise _HttpError(405, f"{method} not allowed on {path}")
        if path in ("/health", "/live"):
            writer.write(_json_response(200, {
                "status": "healthy", "models": self.manager.list_models()}))
        elif path == "/v1/models":
            now = int(time.time())
            writer.write(_json_response(200, {"object": "list", "data": [
                {"id": m, "object": "model", "created": now,
                 "owned_by": "dynamo-tpu-torch"}
                for m in self.manager.list_models()]}))
        elif path == "/metrics":
            text = self.metrics.render()
            writer.write(_head(200, {
                "Content-Type": "text/plain; charset=utf-8",
                "Content-Length": str(len(text))}) + text)
        elif path == "/debug":
            writer.write(_json_response(200, _debug(query)))
        else:
            await self._handle(endpoint, headers, body, reader, writer)

    async def _handle(self, endpoint: str, headers: Dict[str, str],
                      raw: bytes, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            body = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise _HttpError(400, f"invalid JSON body: {e}") from None
        if not isinstance(body, dict):
            raise _HttpError(400, "request body must be a JSON object")
        model = body.get("model")
        if not model:
            raise _HttpError(400, "missing 'model'")
        is_chat = endpoint == "chat_completions"
        engine = (self.manager.chat_engine(model) if is_chat
                  else self.manager.completion_engine(model))
        if engine is None:
            raise _HttpError(404, f"model '{model}' not found",
                             "model_not_found")
        raw_n = body.get("n")
        if raw_n is None:
            n_choices = 1
        elif isinstance(raw_n, int) and not isinstance(raw_n, bool):
            n_choices = raw_n
        else:
            # 2.9 must not silently truncate to 2, nor true to 1
            raise _HttpError(400, "'n' must be an integer")
        if not 1 <= n_choices <= MAX_N:
            raise _HttpError(400, f"'n' must be between 1 and {MAX_N}")
        streaming = bool(body.get("stream", False))
        guard = self.metrics.inflight_guard(model, endpoint, streaming)
        ectx = EngineContext() if n_choices == 1 else _FanoutContext()
        # end-to-end deadline: nvext.deadline_ms or the
        # X-Request-Deadline-Ms header arms a budget that the engine's
        # per-step cancellation sweep honours
        deadline_ms = ((body.get("nvext") or {}).get("deadline_ms")
                       or headers.get("x-request-deadline-ms"))
        if deadline_ms is not None:
            try:
                ectx.set_deadline_ms(float(deadline_ms))
            except (TypeError, ValueError):
                guard.close()
                raise _HttpError(400, f"invalid deadline_ms: "
                                      f"{deadline_ms!r}") from None
        try:
            if n_choices == 1:
                stream = await engine.generate(Context(body, ectx))
            else:
                stream = await _start_fanout(engine, body, ectx, n_choices)
        except ValueError as e:
            guard.close()
            raise _HttpError(400, str(e)) from None
        except Exception as e:  # noqa: BLE001 — engine boundary
            logger.exception("engine error on %s", endpoint)
            guard.close()
            raise _HttpError(500, f"engine error: {e}", "internal_error") \
                from None
        if streaming:
            include_usage = bool((body.get("stream_options") or {})
                                 .get("include_usage"))
            await self._stream_sse(stream, ectx, guard, reader, writer,
                                   include_usage)
            return
        try:
            folded = await (aggregate_chat_stream(stream) if is_chat
                            else aggregate_completion_stream(stream))
            guard.mark_ok()
        except RuntimeError as e:
            raise _HttpError(500, str(e), "internal_error") from None
        finally:
            guard.close()
        writer.write(_json_response(200, folded, {"X-Request-Id": ectx.id}))

    async def _stream_sse(self, stream, ectx: EngineContext, guard,
                          reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter,
                          include_usage: bool) -> None:
        writer.write(_head(200, {"Content-Type": "text/event-stream",
                                 "Cache-Control": "no-cache",
                                 "X-Accel-Buffering": "no",
                                 "X-Request-Id": ectx.id}))

        async def monitor() -> None:
            # the client sends nothing after its request: EOF means it left
            await reader.read()
            guard.mark_cancelled()
            ectx.kill()

        monitor_task = asyncio.create_task(monitor())
        first_chunk = True
        try:
            async for ann in stream:
                if not isinstance(ann, Annotated):
                    ann = Annotated.from_data(ann)
                chunk = ann.data
                if first_chunk and isinstance(chunk, dict):
                    # nvext.request_id on the first SSE chunk, for clients
                    # that never see the response headers
                    first_chunk = False
                    chunk = {**chunk, "nvext": {**(chunk.get("nvext") or {}),
                                                "request_id": ectx.id}}
                if isinstance(chunk, dict) and not include_usage:
                    # usage chunks / piggybacked usage are opt-in for SSE
                    if chunk.get("usage") is not None \
                            and not chunk.get("choices"):
                        continue
                    if "usage" in chunk:
                        chunk = {k: v for k, v in chunk.items()
                                 if k != "usage"}
                if chunk is not ann.data:
                    ann = Annotated(data=chunk, id=ann.id, event=ann.event,
                                    comment=ann.comment)
                n_tok = _chunk_token_count(chunk)
                if n_tok:
                    guard.note_token(n_tok)
                writer.write(encode_annotated(ann).encode())
                await writer.drain()
            if not ectx.is_killed:
                writer.write(encode_done().encode())
                await writer.drain()
                guard.mark_ok()
        except ConnectionError:
            guard.mark_cancelled()
            ectx.kill()
        except Exception as e:  # noqa: BLE001 — the stream's source failed
            # mid-stream (a remote worker lost): an SSE error event tells
            # the client, and no [DONE] follows
            logger.exception("stream failed")
            try:
                writer.write(encode_annotated(Annotated.from_error(
                    f"stream failed: {e}")).encode())
                await writer.drain()
            except ConnectionError:
                pass
        finally:
            monitor_task.cancel()
            guard.close()
