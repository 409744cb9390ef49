"""The PyTorch port's HTTP completions server, on the CPU.

A tiny llama (the JAX package's init, converted) behind the port's
pipeline — preprocessor, detokenizing backend, ``TorchEngine`` — and its
standard-library HTTP server, with the committed SentencePiece fixture
``tests/data/sp/tiny.model`` as the tokenizer. The server answers
``/v1/models``, ``/health`` and ``/v1/completions`` (JSON and SSE with
usage); its greedy tokens equal the JAX ``JaxEngine``'s on the same
weights and prompt; unknown models give 404 and malformed JSON 400; and
the launcher module starts and answers one request.
"""

import asyncio
import http.client
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.core import EngineCore as JEngineCore
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.llm.engines.jax_engine import JaxEngine
from dynamo_tpu.llm.protocols.common import (PreprocessedRequest as
                                             JPreprocessedRequest)
from dynamo_tpu.llm.protocols.common import SamplingOptions as JSampling
from dynamo_tpu.llm.protocols.common import StopConditions as JStop
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.launch import run as launcher
from dynamo_tpu_torch.llm.engines.torch_engine import TorchEngine
from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                   SamplingOptions,
                                                   StopConditions)
from dynamo_tpu_torch.runtime import Context

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP_FIXTURE = os.path.join(REPO, "tests", "data", "sp", "tiny.model")
PROMPT = [5, 17, 42, 99, 7, 250, 3, 11, 64]
MAX_TOKENS = 8


def _engine_cfg(cls, **extra):
    return cls(max_model_len=256, kv_block_size=8, num_kv_blocks=64,
               max_num_seqs=4, prefill_buckets=[32, 64, 128], **extra)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny-sp-llama"))
    shutil.copy(SP_FIXTURE, os.path.join(d, "tokenizer.model"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "vocab_size": 307,
                   "hidden_size": 64, "intermediate_size": 128,
                   "num_hidden_layers": 2, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "head_dim": 16,
                   "max_position_embeddings": 256, "eos_token_id": 2,
                   "bos_token_id": 1}, f)
    return d


@pytest.fixture(scope="module")
def np_params(model_dir):
    p = jllama.init_params(JModelConfig.from_model_dir(model_dir),
                           jax.random.PRNGKey(0), dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def _torch_core(model_dir, np_params):
    cfg = ModelConfig.from_model_dir(model_dir)
    return EngineCore(cfg, _engine_cfg(EngineConfig, dtype="float32"),
                      params=params_from_numpy(np_params, cfg, "cpu",
                                               torch.float32), device="cpu")


@pytest.fixture(scope="module")
def server(model_dir, np_params):
    """The port's server on its own event loop thread; yields its port."""
    args = launcher.build_parser().parse_args(
        ["in=http", "out=torch", "--model-path", model_dir,
         "--model-name", "tiny", "--http-host", "127.0.0.1",
         "--http-port", "0", "--device", "cpu"])
    core = _torch_core(model_dir, np_params)
    ready = threading.Event()
    loop = asyncio.new_event_loop()
    holder = {}

    def runner():
        asyncio.set_event_loop(loop)
        holder["task"] = loop.create_task(launcher.serve(args, core, ready))
        try:
            loop.run_until_complete(holder["task"])
        except asyncio.CancelledError:
            pass

    th = threading.Thread(target=runner, daemon=True)
    th.start()
    assert ready.wait(60), "server did not start"
    yield args.http_port
    loop.call_soon_threadsafe(holder["task"].cancel)
    th.join(30)
    assert not th.is_alive()
    loop.close()


def _request(port, method, path, body=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        data = raw if raw is not None else (
            json.dumps(body) if body is not None else None)
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def test_models_and_health(server):
    status, body = _request(server, "GET", "/v1/models")
    assert status == 200
    assert [m["id"] for m in json.loads(body)["data"]] == ["tiny"]
    status, body = _request(server, "GET", "/health")
    assert status == 200 and json.loads(body)["models"] == ["tiny"]


def test_completion_json_with_usage(server):
    status, body = _request(server, "POST", "/v1/completions", {
        "model": "tiny", "prompt": "hello world", "max_tokens": MAX_TOKENS,
        "temperature": 0, "nvext": {"ignore_eos": True}})
    assert status == 200, body
    out = json.loads(body)
    assert out["object"] == "text_completion"
    assert out["choices"][0]["finish_reason"] == "length"
    assert isinstance(out["choices"][0]["text"], str)
    assert out["usage"]["completion_tokens"] == MAX_TOKENS
    assert out["usage"]["prompt_tokens"] > 0


def test_completion_sse_stream_with_usage(server):
    status, body = _request(server, "POST", "/v1/completions", {
        "model": "tiny", "prompt": PROMPT, "max_tokens": MAX_TOKENS,
        "temperature": 0, "stream": True,
        "stream_options": {"include_usage": True},
        "nvext": {"ignore_eos": True}})
    assert status == 200
    events = [line[6:] for line in body.splitlines()
              if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert all(c["object"] == "text_completion" for c in chunks)
    finishes = [c["choices"][0]["finish_reason"] for c in chunks
                if c["choices"][0]["finish_reason"]]
    assert finishes == ["length"]
    assert chunks[-1]["usage"] == {"prompt_tokens": len(PROMPT),
                                   "completion_tokens": MAX_TOKENS,
                                   "total_tokens": len(PROMPT) + MAX_TOKENS}


def test_errors(server):
    status, body = _request(server, "POST", "/v1/completions",
                            {"model": "nope", "prompt": "x"})
    assert status == 404
    assert json.loads(body)["error"]["type"] == "model_not_found"
    status, body = _request(server, "POST", "/v1/completions",
                            raw="{not json")
    assert status == 400
    assert json.loads(body)["error"]["code"] == 400
    status, _ = _request(server, "POST", "/v1/completions",
                         {"model": "tiny", "prompt": {"a": 1}})
    assert status == 400
    status, _ = _request(server, "GET", "/v1/nowhere")
    assert status == 404


async def _engine_tokens(engine, ctx_cls, pre):
    stream = await engine.generate(ctx_cls(pre))
    toks = []
    async for ann in stream:
        toks.extend(ann.data.token_ids)
    return toks


@pytest.mark.asyncio
async def test_greedy_tokens_match_jax_engine(server, model_dir, np_params):
    """Same weights, same prompt: the port's TorchEngine and the JAX
    JaxEngine produce the same greedy ids, and the HTTP server's text is
    exactly those ids detokenized."""
    jcore = JEngineCore(JModelConfig.from_model_dir(model_dir),
                        _engine_cfg(JEngineConfig),
                        params={k: jnp.asarray(v)
                                for k, v in np_params.items()},
                        attn_impl="xla", param_dtype=jnp.float32)
    tcore = _torch_core(model_dir, np_params)
    try:
        jt = await _engine_tokens(JaxEngine(jcore), JContext,
                                  JPreprocessedRequest(
                                      token_ids=list(PROMPT),
                                      stop_conditions=JStop(
                                          max_tokens=MAX_TOKENS,
                                          ignore_eos=True),
                                      sampling_options=JSampling(
                                          temperature=0.0)))
        tt = await _engine_tokens(TorchEngine(tcore), Context,
                                  PreprocessedRequest(
                                      token_ids=list(PROMPT),
                                      stop_conditions=StopConditions(
                                          max_tokens=MAX_TOKENS,
                                          ignore_eos=True),
                                      sampling_options=SamplingOptions(
                                          temperature=0.0)))
    finally:
        await jcore.stop()
        await tcore.stop()
    assert len(tt) == MAX_TOKENS and tt == jt
    status, body = await asyncio.to_thread(
        _request, server, "POST", "/v1/completions", {
            "model": "tiny", "prompt": PROMPT, "max_tokens": MAX_TOKENS,
            "temperature": 0, "nvext": {"ignore_eos": True}})
    assert status == 200
    from dynamo_tpu_torch.llm.tokenizer import load_tokenizer
    want = load_tokenizer(model_dir).decode(jt)
    assert json.loads(body)["choices"][0]["text"] == want


def test_launcher_serves_one_request(model_dir):
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=http",
         "out=torch", "--model-path", model_dir, "--random-weights",
         "--device", "cpu", "--http-host",
         "127.0.0.1", "--http-port", "0", "--max-model-len", "256",
         "--num-kv-blocks", "64"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        deadline = time.monotonic() + 120
        port = None
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith("READY "):
                port = int(line.rsplit(":", 1)[1].split("/")[0])
                break
        assert port is not None, "launcher never became ready"
        status, body = _request(port, "POST", "/v1/completions", {
            "model": os.path.basename(model_dir), "prompt": "hello",
            "max_tokens": 4, "nvext": {"ignore_eos": True}})
        assert status == 200, body
        assert json.loads(body)["usage"]["completion_tokens"] == 4
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
