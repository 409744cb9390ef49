"""Chat on the port (``dynamo_tpu_torch``) against the JAX package, on the
CPU: both HTTP services are built over ``echo_core`` pipelines from one
``tokenizer.json`` model directory and get the same requests; their
answers are compared modulo ids and timestamps (exact matches otherwise):

- chat, unary and SSE, with the token_ids / formatted_prompt annotations;
- tools with ``tool_choice`` none, auto, required and named (a raw prompt
  that is a tool call, and one that is not);
- ``n`` = 3, seeded, unary and streamed;
- malformed bodies: status and error body;
- ``nvext.deadline_ms`` and ``X-Request-Deadline-Ms`` (the deadline the
  engine sees, and a malformed one);
- ``/metrics`` after the same events: the same series, ``_created``
  included, and the same counts;
- the chat SSE replay corpus through the port's parser and aggregator;
- one greedy chat request on the port's engine against the JAX engine,
  tiny model, float32.
"""

import copy
import json
import os

import aiohttp
import jax.numpy as jnp
import pytest
from prometheus_client.parser import text_string_to_metric_families

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.llm.backend import Backend as JBackend
from dynamo_tpu.llm.engines.echo import EchoEngineCore as JEcho
from dynamo_tpu.llm.engines.jax_engine import JaxEngine
from dynamo_tpu.llm.http import HttpService as JService
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JCard
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as JPre
from dynamo_tpu.llm.protocols.openai import \
    aggregate_chat_stream as j_aggregate
from dynamo_tpu.llm.protocols.sse import SseParser as JParser
from dynamo_tpu.llm.protocols.sse import event_to_annotated as j_event
from dynamo_tpu.llm.protocols.sse import parse_sse_stream as j_parse
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu.runtime import ResponseStream as JStream
from dynamo_tpu.runtime import link as jlink
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.engines.echo import EchoEngineCore
from dynamo_tpu_torch.llm.engines.torch_engine import TorchEngine
from dynamo_tpu_torch.llm.http import HttpService
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.protocols.openai import aggregate_chat_stream
from dynamo_tpu_torch.llm.protocols.sse import (SseParser,
                                                event_to_annotated,
                                                parse_sse_stream)
from dynamo_tpu_torch.runtime import Context, ResponseStream, link

pytestmark = pytest.mark.anyio

MSGS = [{"role": "user", "content": "hello tiny world"}]
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "weather <for> a city & region",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string"}}}}}]
CALL = json.dumps({"name": "get_weather", "arguments": {"city": "Paris"}})


class DeadlineProbe:
    """A full engine answering with whether its context has a deadline."""

    def __init__(self, stream_cls):
        self.stream_cls = stream_cls

    async def generate(self, request):
        armed = request.ctx.deadline_s is not None

        async def gen():
            yield {"id": "x", "object": "chat.completion.chunk",
                   "created": 0, "model": "probe",
                   "choices": [{"index": 0, "delta": {
                       "role": "assistant", "content": str(armed)},
                       "finish_reason": "stop"}]}
        return self.stream_cls(gen(), request.ctx)


@pytest.fixture
async def services(tiny_model_dir):
    """(port service, JAX service) over echo_core pipelines of one
    tokenizer.json directory, plus the deadline probe."""
    jmdc = JCard.from_local_path(tiny_model_dir, display_name="tiny")
    mdc = ModelDeploymentCard.from_local_path(tiny_model_dir,
                                              display_name="tiny")
    jsvc = JService(port=0, host="127.0.0.1")
    jpipe = jlink(JPre(jmdc), JBackend(jmdc), JEcho())
    jsvc.manager.add_chat_model("tiny", jpipe)
    jsvc.manager.add_completion_model("tiny", jpipe)
    jsvc.manager.add_chat_model("probe", DeadlineProbe(JStream))
    svc = HttpService(port=0, host="127.0.0.1")
    pipe = link(OpenAIPreprocessor(mdc), Backend(mdc), EchoEngineCore())
    svc.manager.add_chat_model("tiny", pipe)
    svc.manager.add_completion_model("tiny", pipe)
    svc.manager.add_chat_model("probe", DeadlineProbe(ResponseStream))
    await jsvc.start()
    await svc.start()
    yield svc, jsvc
    await svc.stop()
    await jsvc.stop()


def _strip(obj):
    """An answer with its ids and timestamps taken out."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in ("id", "created", "request_id")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


async def _post(port: int, path: str, body, headers=None):
    """(status, JSON body) or, for an SSE answer, (status, its events as
    (data, event, comments) with ids stripped)."""
    data = body if isinstance(body, str) else json.dumps(body)
    async with aiohttp.ClientSession() as s:
        async with s.post(f"http://127.0.0.1:{port}{path}", data=data,
                          headers=headers or {}) as r:
            if r.headers.get("Content-Type", "").startswith(
                    "text/event-stream"):
                parser = SseParser()
                events = list(parser.push(await r.text()))
                return r.status, [
                    (_strip(json.loads(e.data)) if e.data
                     and not e.is_done else e.data, e.event, e.comments)
                    for e in events]
            return r.status, _strip(await r.json(content_type=None))


async def _both(services, path, body, headers=None):
    svc, jsvc = services
    got = await _post(svc.port, path, body, headers)
    want = await _post(jsvc.port, path, body, headers)
    return got, want


CHAT_BODIES = [
    {"messages": MSGS, "max_tokens": 8},
    {"messages": MSGS, "max_tokens": 8, "stream": True},
    {"messages": MSGS, "max_tokens": 8, "stream": True,
     "stream_options": {"include_usage": True},
     "nvext": {"annotations": ["token_ids", "formatted_prompt"]}},
    {"messages": [{"role": "system", "content": "be brief"},
                  {"role": "user", "content": [
                      {"type": "text", "text": "two "},
                      {"type": "text", "text": "parts"}]}],
     "max_completion_tokens": 5, "stop": ["user"]},
    {"messages": MSGS, "max_tokens": 3, "temperature": 0.5, "seed": 4,
     "nvext": {"ignore_eos": True, "top_k": 3}},
]


@pytest.mark.parametrize("i", range(len(CHAT_BODIES)))
async def test_chat_matches_jax(services, i):
    body = {"model": "tiny", **CHAT_BODIES[i]}
    got, want = await _both(services, "/v1/chat/completions", body)
    assert got == want
    assert got[0] == 200


@pytest.mark.parametrize("choice", [None, "none", "auto", "required",
                                    {"type": "function",
                                     "function": {"name": "get_weather"}},
                                    {"type": "function",
                                     "function": {"name": "other"}}])
@pytest.mark.parametrize("content", [CALL, "no call here"])
@pytest.mark.parametrize("stream", [False, True])
async def test_tools_match_jax(services, choice, content, stream):
    body = {"model": "tiny", "messages": [{"role": "user",
                                           "content": content}],
            "tools": TOOLS, "stream": stream, "max_tokens": 64,
            "nvext": {"use_raw_prompt": True}}
    if choice is not None:
        body["tool_choice"] = choice
    got, want = await _both(services, "/v1/chat/completions", body)
    assert got == want


async def test_tool_call_is_parsed(services):
    got, _ = await _both(services, "/v1/chat/completions", {
        "model": "tiny", "messages": [{"role": "user", "content": CALL}],
        "tools": TOOLS, "max_tokens": 64, "nvext": {"use_raw_prompt": True}})
    choice = got[1]["choices"][0]
    assert choice["finish_reason"] == "tool_calls"
    assert choice["message"]["tool_calls"][0]["function"] == {
        "name": "get_weather", "arguments": json.dumps({"city": "Paris"})}


@pytest.mark.parametrize("path", ["/v1/chat/completions", "/v1/completions"])
@pytest.mark.parametrize("stream", [False, True])
async def test_n_choices_match_jax(services, path, stream):
    body = {"model": "tiny", "n": 3, "seed": 7, "max_tokens": 4,
            "temperature": 0.8, "stream": stream,
            "stream_options": {"include_usage": True}}
    body.update({"messages": MSGS} if "chat" in path
                else {"prompt": "hello tiny world"})
    got, want = await _both(services, path, body)
    assert got == want
    if not stream:
        assert [c["index"] for c in got[1]["choices"]] == [0, 1, 2]


MALFORMED = [
    ("/v1/chat/completions", "{not json"),
    ("/v1/chat/completions", {"messages": MSGS}),
    ("/v1/chat/completions", {"model": "nope", "messages": MSGS}),
    ("/v1/completions", {"model": "nope", "prompt": "x"}),
    ("/v1/chat/completions", {"model": "tiny", "messages": MSGS, "n": 0}),
    ("/v1/chat/completions", {"model": "tiny", "messages": MSGS, "n": 17}),
    ("/v1/chat/completions", {"model": "tiny", "messages": MSGS, "n": 2.5}),
    ("/v1/chat/completions", {"model": "tiny", "messages": MSGS,
                              "n": True}),
    ("/v1/chat/completions", {"model": "tiny", "messages": MSGS,
                              "nvext": {"deadline_ms": "soon"}}),
    ("/v1/chat/completions", {"model": "tiny", "messages": MSGS,
                              "tool_choice": "required"}),
    ("/v1/chat/completions", {"model": "tiny", "messages": MSGS,
                              "tool_choice": "sometimes",
                              "tools": TOOLS}),
    ("/v1/chat/completions", {"model": "tiny", "messages": [
        {"role": "user", "content": "x " * 3000}]}),
]


@pytest.mark.parametrize("i", range(len(MALFORMED)))
async def test_malformed_bodies_match_jax(services, i):
    path, body = MALFORMED[i]
    got, want = await _both(services, path, body)
    assert got == want
    assert got[0] in (400, 404)


@pytest.mark.parametrize("body", [
    {"model": "tiny", "messages": "not a list"},
    {"model": "tiny", "messages": [{"content": "no role"}]},
    {"model": "tiny", "messages": MSGS, "max_tokens": "many"},
])
async def test_invalid_fields_are_400_as_in_jax(services, body):
    """Both refuse the body with a 400 invalid_request_error; the message
    is the validator's own (pydantic's in the JAX package)."""
    got, want = await _both(services, "/v1/chat/completions", body)
    assert got[0] == want[0] == 400
    for res in (got, want):
        assert res[1]["error"]["type"] == "invalid_request_error"
        assert res[1]["error"]["code"] == 400


@pytest.mark.parametrize("where", ["body", "header", "none"])
async def test_deadline_reaches_the_engine(services, where):
    body = {"model": "probe", "messages": MSGS}
    headers = {}
    if where == "body":
        body["nvext"] = {"deadline_ms": 5000}
    elif where == "header":
        headers["X-Request-Deadline-Ms"] = "5000"
    got, want = await _both(services, "/v1/chat/completions", body, headers)
    assert got == want
    assert got[1]["choices"][0]["message"]["content"] == \
        str(where != "none")


def _samples(text: str) -> dict:
    out = {}
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


async def test_metrics_match_jax(services):
    svc, jsvc = services
    events = [("/v1/chat/completions", {"model": "tiny", "messages": MSGS,
                                        "max_tokens": 4}),
              ("/v1/chat/completions", {"model": "tiny", "messages": MSGS,
                                        "max_tokens": 4, "stream": True}),
              ("/v1/chat/completions", {"model": "tiny", "messages": MSGS,
                                        "n": 2, "stream": True}),
              ("/v1/completions", {"model": "tiny", "prompt": "hi there",
                                   "max_tokens": 3, "stream": True}),
              ("/v1/completions", {"model": "tiny", "prompt": [1, 2]}),
              ("/v1/chat/completions", {"model": "tiny", "messages": MSGS,
                                        "tool_choice": "required",
                                        "tools": TOOLS,
                                        "nvext": {"use_raw_prompt": True}}),
              ("/v1/chat/completions", {"model": "nope", "messages": MSGS})]
    for path, body in events:
        await _both(services, path, body)
    texts = []
    for port in (svc.port, jsvc.port):
        async with aiohttp.ClientSession() as s:
            async with s.get(f"http://127.0.0.1:{port}/metrics") as r:
                assert r.status == 200
                assert r.headers["Content-Type"].startswith("text/plain")
                texts.append(await r.text())
    got, want = _samples(texts[0]), _samples(texts[1])
    assert set(got) == set(want)
    assert any(name.endswith("_created") for name, _ in got)
    timed = ("_created", "_sum", "_bucket")
    for key, value in want.items():
        if not key[0].endswith(timed):
            assert got[key] == value, key
    # HELP and TYPE lines as prometheus_client writes them
    meta = [ln for ln in texts[1].splitlines() if ln.startswith("#")]
    assert [ln for ln in texts[0].splitlines() if ln.startswith("#")] == meta


async def test_live_and_health_match_jax(services):
    svc, jsvc = services
    for path in ("/live", "/health"):
        res = []
        for port in (svc.port, jsvc.port):
            async with aiohttp.ClientSession() as s:
                async with s.get(f"http://127.0.0.1:{port}{path}") as r:
                    res.append((r.status, await r.json()))
        assert res[0] == res[1]
        assert res[0][0] == 200


REPLAYS = os.path.join(os.path.dirname(__file__), "data", "sse_replays",
                       "chat")


@pytest.mark.parametrize("name", sorted(os.listdir(REPLAYS)))
@pytest.mark.parametrize("chunk", [7, 4096])
async def test_chat_replays_aggregate_as_in_jax(name, chunk):
    raw = open(os.path.join(REPLAYS, name), "rb").read()

    async def chunks():
        for off in range(0, len(raw), chunk):
            yield raw[off:off + chunk]

    async def fold(parse, aggregate):
        try:
            return await aggregate(parse(chunks()))
        except RuntimeError as e:
            return ("error", str(e))
    got = await fold(parse_sse_stream, aggregate_chat_stream)
    assert got == await fold(j_parse, j_aggregate)
    # and event by event
    text = raw.decode()
    fields = ("data", "id", "event", "comment")
    port = [event_to_annotated(e) for e in SseParser().push(text)]
    ref = [j_event(e) for e in JParser().push(text)]
    assert [[getattr(a, f) for f in fields] for a in port] == \
        [[getattr(a, f) for f in fields] for a in ref]


async def test_greedy_chat_on_the_engine_matches_jax(tiny_weighted_model_dir):
    d = tiny_weighted_model_dir
    ecfg = dict(max_model_len=256, kv_block_size=8, num_kv_blocks=64,
                max_num_seqs=4, prefill_buckets=[32, 64, 128])
    jeng = JaxEngine.from_model_dir(d, JEngineConfig(**ecfg),
                                    attn_impl="xla", param_dtype=jnp.float32)
    teng = TorchEngine.from_model_dir(d, EngineConfig(dtype="float32",
                                                      **ecfg), device="cpu")
    jmdc = JCard.from_local_path(d, display_name="tiny")
    mdc = ModelDeploymentCard.from_local_path(d, display_name="tiny")
    body = {"model": "tiny", "temperature": 0, "max_tokens": 12,
            "nvext": {"ignore_eos": True,
                      "annotations": ["token_ids", "formatted_prompt"]},
            "messages": [{"role": "system", "content": "be brief"},
                         {"role": "user", "content": "the quick brown fox"}]}
    try:
        jstream = await jlink(JPre(jmdc), JBackend(jmdc), jeng).generate(
            JContext(copy.deepcopy(body)))
        tstream = await link(OpenAIPreprocessor(mdc), Backend(mdc),
                             teng).generate(Context(copy.deepcopy(body)))
        jitems = [(a.event, a.comment, _strip(a.data)) async for a in jstream]
        titems = [(a.event, a.comment, _strip(a.data)) async for a in tstream]
    finally:
        await jeng.core.stop()
        await teng.core.stop()
    assert titems == jitems
    assert titems[-1][2]["usage"]["completion_tokens"] == 12
