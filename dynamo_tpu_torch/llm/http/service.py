"""OpenAI-compatible HTTP frontend on the standard library.

Counterpart of ``dynamo_tpu.llm.http.service`` for completions, built on
``asyncio.start_server`` because the GPU machine has no aiohttp:
``GET /v1/models``, ``GET /health`` and ``POST /v1/completions`` as one JSON
body or as Server-Sent Events ending in ``data: [DONE]``. Errors use the
JAX package's body (``{"error": {"message", "type", "code"}}``). Each
connection serves one request (``Connection: close``). A client that
disconnects mid-stream kills the request's context, so the engine frees its
slot at the next step.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Dict, Optional, Tuple

from ...runtime.engine import AsyncEngine, Context, EngineContext
from ..protocols.annotated import Annotated
from ..protocols.openai import aggregate_completion_stream
from ..protocols.sse import encode_annotated, encode_done

logger = logging.getLogger("dynamo_tpu_torch.http")

MAX_BODY = 16 << 20       # request bodies above this are refused (413)
_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            500: "Internal Server Error"}


class ModelManager:
    """Named completion-engine registry (reference `ModelManager`)."""

    def __init__(self) -> None:
        self._completion: Dict[str, AsyncEngine] = {}

    def add_completion_model(self, name: str, engine: AsyncEngine) -> None:
        self._completion[name] = engine

    def completion_engine(self, name: str) -> Optional[AsyncEngine]:
        return self._completion.get(name)

    def list_models(self) -> list:
        return sorted(self._completion)


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
    return method, target.split("?", 1)[0], headers, body


class HttpService:
    """The frontend server (reference `HttpService`)."""

    def __init__(self, port: int = 8080, host: str = "0.0.0.0",
                 manager: Optional[ModelManager] = None):
        self.port = port
        self.host = host
        self.manager = manager or ModelManager()
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
                method, path, headers, body = await _read_request(reader)
                await self._route(method, path, body, reader, writer)
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

    async def _route(self, method: str, path: str, body: bytes,
                     reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        if path == "/health":
            if method != "GET":
                raise _HttpError(405, f"{method} not allowed on {path}")
            writer.write(_json_response(200, {
                "status": "healthy", "models": self.manager.list_models()}))
        elif path == "/v1/models":
            if method != "GET":
                raise _HttpError(405, f"{method} not allowed on {path}")
            now = int(time.time())
            writer.write(_json_response(200, {"object": "list", "data": [
                {"id": m, "object": "model", "created": now,
                 "owned_by": "dynamo-tpu-torch"}
                for m in self.manager.list_models()]}))
        elif path == "/v1/completions":
            if method != "POST":
                raise _HttpError(405, f"{method} not allowed on {path}")
            await self._completions(body, reader, writer)
        else:
            raise _HttpError(404, f"no route for {path}", "not_found")

    async def _completions(self, raw: bytes, reader: asyncio.StreamReader,
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
        engine = self.manager.completion_engine(model)
        if engine is None:
            raise _HttpError(404, f"model '{model}' not found",
                             "model_not_found")
        ectx = EngineContext()
        try:
            stream = await engine.generate(Context(body, ectx))
        except ValueError as e:
            raise _HttpError(400, str(e)) from None
        except Exception as e:  # noqa: BLE001 — engine boundary
            logger.exception("engine error on completions")
            raise _HttpError(500, f"engine error: {e}", "internal_error") \
                from None
        if body.get("stream"):
            include_usage = bool((body.get("stream_options") or {})
                                 .get("include_usage"))
            await self._stream_sse(stream, ectx, reader, writer, include_usage)
            return
        try:
            folded = await aggregate_completion_stream(stream)
        except RuntimeError as e:
            raise _HttpError(500, str(e), "internal_error") from None
        writer.write(_json_response(200, folded, {"X-Request-Id": ectx.id}))

    async def _stream_sse(self, stream, ectx: EngineContext,
                          reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter,
                          include_usage: bool) -> None:
        writer.write(_head(200, {"Content-Type": "text/event-stream",
                                 "Cache-Control": "no-cache",
                                 "X-Request-Id": ectx.id}))

        async def monitor() -> None:
            # the client sends nothing after its request: EOF means it left
            await reader.read()
            ectx.kill()

        monitor_task = asyncio.create_task(monitor())
        try:
            async for ann in stream:
                if not isinstance(ann, Annotated):
                    ann = Annotated.from_data(ann)
                chunk = ann.data
                if isinstance(chunk, dict) and not include_usage \
                        and "usage" in chunk:
                    # usage is opt-in for SSE clients
                    chunk = {k: v for k, v in chunk.items() if k != "usage"}
                    ann = Annotated(data=chunk, id=ann.id, event=ann.event,
                                    comment=ann.comment)
                writer.write(encode_annotated(ann).encode())
                await writer.drain()
            if not ectx.is_killed:
                writer.write(encode_done().encode())
                await writer.drain()
        except ConnectionError:
            ectx.kill()
        finally:
            monitor_task.cancel()
