"""Package-level guarantees of the PyTorch port (``dynamo_tpu_torch``).

- In a fresh interpreter, importing every module of the package and
  serving one completion on the CPU loads neither JAX nor the JAX package
  (``dynamo_tpu`` exactly — the port shares its prefix) nor any package the
  GPU machine lacks.
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
             "tokenizers", "xxhash", "prometheus_client", "safetensors")

_SCRIPT = r'''
import asyncio, importlib, json, os, pkgutil, shutil, sys, tempfile
import dynamo_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    dynamo_tpu_torch.__path__, "dynamo_tpu_torch."))
for m in mods:
    importlib.import_module(m)
from dynamo_tpu_torch.launch import run as launcher
d = tempfile.mkdtemp()
shutil.copy(sys.argv[1], os.path.join(d, "tokenizer.model"))
json.dump({"vocab_size": 307, "hidden_size": 32, "intermediate_size": 64,
           "num_hidden_layers": 1, "num_attention_heads": 2,
           "num_key_value_heads": 1, "max_position_embeddings": 128,
           "eos_token_id": 2}, open(os.path.join(d, "config.json"), "w"))
args = launcher.build_parser().parse_args(
    ["in=http", "out=torch", "--model-path", d, "--random-weights",
     "--device", "cpu", "--http-host", "127.0.0.1", "--http-port", "0",
     "--max-model-len", "128", "--num-kv-blocks", "32"])

async def main():
    core = launcher.build_core(args)
    ready = asyncio.Event()
    task = asyncio.create_task(launcher.serve(args, core, ready))
    await ready.wait()
    r, w = await asyncio.open_connection("127.0.0.1", args.http_port)
    body = json.dumps({"model": os.path.basename(d), "prompt": "hello",
                       "max_tokens": 3, "nvext": {"ignore_eos": True}})
    w.write(("POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
             f"Content-Length: {len(body)}\r\n\r\n{body}").encode())
    raw = await r.read()
    w.close()
    task.cancel()
    try:
        await task
    except asyncio.CancelledError:
        pass
    return json.loads(raw.split(b"\r\n\r\n", 1)[1])

resp = asyncio.run(main())
shutil.rmtree(d)
print(json.dumps({"modules": mods, "loaded": sorted(sys.modules),
                  "usage": resp["usage"]}))
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
    assert res["usage"]["completion_tokens"] == 3
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
        init_params(cfg, 0)
    args = launcher.build_parser().parse_args(
        ["--model-path", "unused", "--random-weights"])
    assert args.device == "cuda"
    with pytest.raises(NotImplementedError):
        EngineConfig(spec_k=2)
