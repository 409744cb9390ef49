"""Package-level guarantees of the PyTorch port (``dynamo_tpu_torch``).

- In a fresh interpreter, importing every module of the package, serving
  one completion on the CPU and one chat completion from a directory whose
  only tokenizer is ``tokenizer.json`` loads neither JAX nor the JAX
  package (``dynamo_tpu`` exactly — the port shares its prefix) nor any
  package the GPU machine lacks.
- The pure-Python XXH3-64 equals ``xxhash`` for inputs of 0 to 512 bytes,
  so block hashes equal the JAX package's.
- Entry points default to the card and raise without one.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import xxhash

from dynamo_tpu.llm.kv import blocks as jblocks
from dynamo_tpu_torch.llm.kv import blocks as tblocks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "dynamo_tpu", "aiohttp", "pydantic", "jinja2",
             "tokenizers", "xxhash", "prometheus_client", "safetensors",
             "regex", "transformers")

_SCRIPT = r'''
import asyncio, importlib, json, os, pkgutil, shutil, sys, tempfile
import dynamo_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    dynamo_tpu_torch.__path__, "dynamo_tpu_torch."))
for m in mods:
    importlib.import_module(m)
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.launch import run as launcher
import chip_smoke
d = tempfile.mkdtemp()
shutil.copy(sys.argv[1], os.path.join(d, "tokenizer.model"))
json.dump({"vocab_size": 307, "hidden_size": 32, "intermediate_size": 64,
           "num_hidden_layers": 1, "num_attention_heads": 2,
           "num_key_value_heads": 1, "max_position_embeddings": 128,
           "eos_token_id": 2}, open(os.path.join(d, "config.json"), "w"))
# a directory whose only tokenizer is tokenizer.json, with a chat template
c = os.path.join(d, "chat")
chip_smoke.write_chat_model_dir(c, ModelConfig(
    vocab_size=1280, hidden_size=32, intermediate_size=64, num_layers=1,
    num_heads=2, num_kv_heads=1, head_dim=16, max_position_embeddings=128))


async def serve_once(model_dir, path, body):
    args = launcher.build_parser().parse_args(
        ["in=http", "out=torch", "--model-path", model_dir,
         "--random-weights", "--device", "cpu", "--http-host", "127.0.0.1",
         "--http-port", "0", "--max-model-len", "128",
         "--num-kv-blocks", "32"])
    core = launcher.build_core(args)
    ready = asyncio.Event()
    task = asyncio.create_task(launcher.serve(args, core, ready))
    await ready.wait()
    r, w = await asyncio.open_connection("127.0.0.1", args.http_port)
    body = json.dumps({"model": os.path.basename(model_dir), **body})
    w.write((f"POST {path} HTTP/1.1\r\nHost: x\r\n"
             f"Content-Length: {len(body)}\r\n\r\n{body}").encode())
    raw = await r.read()
    w.close()
    task.cancel()
    try:
        await task
    except asyncio.CancelledError:
        pass
    return json.loads(raw.split(b"\r\n\r\n", 1)[1])

resp = asyncio.run(serve_once(d, "/v1/completions", {
    "prompt": "hello", "max_tokens": 3, "nvext": {"ignore_eos": True}}))
chat = asyncio.run(serve_once(c, "/v1/chat/completions", {
    "messages": [{"role": "user", "content": "hello there"}],
    "max_tokens": 3, "nvext": {"ignore_eos": True}}))
shutil.rmtree(d)
print(json.dumps({"modules": mods, "loaded": sorted(sys.modules),
                  "usage": resp["usage"], "chat": chat}))
'''


def test_package_imports_no_jax_nor_missing_packages():
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT,
         os.path.join(REPO, "tests", "data", "sp", "tiny.model")],
        cwd=REPO, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "dynamo_tpu_torch.launch.run" in res["modules"]
    assert "dynamo_tpu_torch.engine.kernels" in res["modules"]
    assert "dynamo_tpu_torch.engine.ragged" in res["modules"]
    assert res["usage"]["completion_tokens"] == 3
    assert "dynamo_tpu_torch.llm.bpe_model" in res["modules"]
    assert "dynamo_tpu_torch.llm.chat_template" in res["modules"]
    chat = res["chat"]
    assert chat["object"] == "chat.completion"
    assert chat["usage"]["completion_tokens"] == 3
    assert chat["usage"]["prompt_tokens"] > 3
    bad = [m for m in res["loaded"]
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


@pytest.mark.parametrize("seed", [0, tblocks.HASH_SEED])
def test_xxh3_matches_xxhash(seed):
    rng = np.random.default_rng(seed)
    for n in range(0, 513):
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        assert tblocks.xxh3_64(data, seed) == xxhash.xxh3_64_intdigest(
            data, seed=seed), n


def test_block_hashes_match_jax_package():
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 128256, size=100).tolist()
    assert (tblocks.compute_block_hashes(tokens, 16)
            == jblocks.compute_block_hashes(tokens, 16))
    assert tblocks.hash_tokens(tokens[:16]) == jblocks.hash_tokens(tokens[:16])
    assert tblocks.chain_hash(None, 7) == jblocks.chain_hash(None, 7)
    assert tblocks.chain_hash(5, 7) == jblocks.chain_hash(5, 7)


def test_entry_points_default_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults do not raise")
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.core import EngineCore
    from dynamo_tpu_torch.engine.weights import init_params
    from dynamo_tpu_torch.launch import run as launcher
    cfg = ModelConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                      num_layers=1, num_heads=2, num_kv_heads=1, head_dim=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineCore(cfg, EngineConfig(max_model_len=64, num_kv_blocks=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineCore(cfg, EngineConfig(max_model_len=64, num_kv_blocks=8,
                                     ragged_dispatch=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, 0)
    args = launcher.build_parser().parse_args(
        ["--model-path", "unused", "--random-weights"])
    assert args.device == "cuda"
    args = launcher.build_parser().parse_args(
        ["--model-path", "unused", "--random-weights", "--ragged"])
    assert args.device == "cuda" and args.ragged
    # a field of a path the port does not implement is not a field
    with pytest.raises(TypeError):
        EngineConfig(tp=2)


# the JAX EngineConfig's fields the port does not implement yet (ROADMAP A):
# each is not a field of the port's EngineConfig, so passing it raises
UNPORTED_ENGINE_FIELDS = (
    "tp", "dp", "ep", "pp", "kv_remote_dir", "kv_remote_blocks",
    "kv_remote_admission")


@pytest.mark.parametrize("field", UNPORTED_ENGINE_FIELDS)
def test_unported_engine_fields_raise(field):
    import dataclasses
    from dynamo_tpu_torch.engine.config import EngineConfig
    assert len(UNPORTED_ENGINE_FIELDS) == 7
    assert field not in {f.name for f in dataclasses.fields(EngineConfig)}
    with pytest.raises(TypeError):
        EngineConfig(**{field: 1})


# the KV-tier and defrag fields the port took from the JAX EngineConfig,
# each with invalid settings (beside the field itself, what they need)
PORTED_TIER_FIELDS = {
    "host_kv_blocks": [{"kv_disk_dir": "d", "kv_disk_blocks": 4,
                        "host_kv_blocks": 0}],
    "kv_disk_dir": [{"kv_disk_dir": "d"}],
    "kv_disk_blocks": [{"kv_disk_blocks": 4, "host_kv_blocks": 4}],
    "offload_simulated_gbps": [],
    "kv_contig_alloc": [],
    "kv_defrag_threshold": [{"kv_defrag_threshold": -0.1},
                            {"kv_defrag_threshold": 1.5}],
    "kv_defrag_max_blocks": [],
}
# of those, the fields the port accepts only at JAX's default: a setting
# the JAX package takes, which the port refuses
DEFAULT_ONLY_FIELDS = {"offload_simulated_gbps": 1.0,
                       "kv_contig_alloc": False}


@pytest.mark.parametrize("field", list(PORTED_TIER_FIELDS))
def test_ported_tier_fields_follow_jax(field):
    """Each has the JAX default, and each invalid setting raises the JAX
    EngineConfig's error."""
    import re
    from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
    from dynamo_tpu_torch.engine.config import EngineConfig
    assert len(PORTED_TIER_FIELDS) == 7
    assert getattr(EngineConfig(), field) == getattr(JEngineConfig(), field)
    for bad in PORTED_TIER_FIELDS[field]:
        with pytest.raises(ValueError) as want:
            JEngineConfig(**bad)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            EngineConfig(**bad)
    if field in DEFAULT_ONLY_FIELDS:
        JEngineConfig(**{field: DEFAULT_ONLY_FIELDS[field]})
        with pytest.raises(ValueError, match="not ported"):
            EngineConfig(**{field: DEFAULT_ONLY_FIELDS[field]})
