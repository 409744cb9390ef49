"""Checkpoint loading of the PyTorch port, on the CPU.

- The port's safetensors reader (``engine/safetensors_file.py``, standard
  library only) reads F32, F16, BF16 and I8 tensors across several files,
  with ``__metadata__``, equal to the ``safetensors`` package's
  ``safe_open``; the port's writer's files read back equal through
  ``safe_open``; a dtype the engine does not load, and a byte range that
  is not its shape's, raise with the tensor's name.
- For each family (llama, qwen2 with qkv bias, qwen3 with qk-norms, gemma2
  tied with its post-norms, phi3 with its fused projections, deepseek_v2
  hybrid MoE with q-LoRA, deepseek_v3 with the router bias and an MTP
  layer) the directory the JAX package writes is loaded by JAX
  ``load_llama_params`` and by the port's ``load_params_auto`` at f32, and
  the two trees are exactly equal; the implicit tie and the beyond-L,
  missing-layer, outside-range and no-file errors are JAX's.
- Quantize-on-load (int8, int8-noembed, int4, int4-noembed; untied,
  tied, fused, biased) is bit-equal to ``quant.quantize_params`` of the
  bf16 load, with chunks small enough that every tensor takes several;
  the engine takes such a tree as it is; host staging is one buffer of the
  largest checkpoint tensor.
- ``TorchEngine.from_model_dir`` and ``JaxEngine.from_model_dir`` on
  ``tests/fixtures.py``'s weighted tiny model give the same greedy and
  seeded tokens; the launcher without ``--random-weights`` serves that
  directory with the in-process engine's tokens in bf16 and in int4 +
  int8 KV ``--ragged``, and exits non-zero with the loader's message on a
  directory without safetensors.
"""

import asyncio
import http.client
import json
import os
import shutil
import struct
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import save_file as torch_save_file

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.models import mla as jmla
from dynamo_tpu.engine.weights import load_llama_params as jload
from dynamo_tpu.engine.weights import save_hf_style as jsave
from dynamo_tpu.llm.engines.jax_engine import JaxEngine
from dynamo_tpu_torch.engine import weights as tw
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.engine.models import family as family_of
from dynamo_tpu_torch.engine.quant import (QuantizedTensor, quantize_params,
                                           tree_quantization)
from dynamo_tpu_torch.engine.safetensors_file import (SafetensorsFile,
                                                      save_file, write_file)
from dynamo_tpu_torch.llm.engines.torch_engine import TorchEngine
from tests.fixtures import build_tiny_weighted_model_dir
from tests.test_mla import _moe_cfg, _to_hf_moe, _to_hf_v3, _v3_cfg
from tests.test_torch_engine import GREEDY, SAMPLED, run_both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# the file format
# ---------------------------------------------------------------------------


def _mixed_tensors(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "a.f32": torch.randn(3, 5, generator=g),
        "b.f16": torch.randn(7, generator=g).half(),
        "c.bf16": torch.randn(4, 2, 3, generator=g).bfloat16(),
        "d.i8": torch.randint(-128, 127, (6, 4), generator=g,
                              dtype=torch.int8),
        "e.scalar": torch.tensor(2.5),
        "f.empty": torch.zeros(0, 3),
    }


def test_reader_matches_safe_open_across_files(tmp_path):
    for k in range(3):
        torch_save_file(_mixed_tensors(k), str(tmp_path / f"m{k}.safetensors"),
                        metadata={"format": "pt", "part": str(k)})
    for k in range(3):
        path = str(tmp_path / f"m{k}.safetensors")
        ours = SafetensorsFile(path)
        with safe_open(path, framework="pt") as f:
            assert ours.keys() == list(f.keys())
            assert ours.metadata == f.metadata()
            for name in f.keys():
                want = f.get_tensor(name)
                got = ours.get_tensor(name)
                assert got.dtype == want.dtype and got.shape == want.shape
                assert torch.equal(got, want), name
        # data order: the byte ranges follow one another
        infos = list(ours.tensors.values())
        assert all(a.end == b.begin for a, b in zip(infos, infos[1:]))


def test_writer_reads_back_through_safe_open(tmp_path):
    tensors = _mixed_tensors(7)
    path = str(tmp_path / "w.safetensors")
    n = save_file(tensors, path, {"format": "pt", "note": "x"})
    assert n == os.path.getsize(path)
    with open(path, "rb") as f:
        assert struct.unpack("<Q", f.read(8))[0] % 8 == 0
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt", "note": "x"}
        assert sorted(f.keys()) == sorted(tensors)
        for name, t in tensors.items():
            assert torch.equal(f.get_tensor(name), t), name


def test_writer_produces_each_tensor_when_due(tmp_path):
    made = []

    def make(i):
        made.append(i)
        return torch.full((2, 2), float(i), dtype=torch.bfloat16)
    entries = [(f"t{i}", torch.bfloat16, (2, 2), lambda i=i: make(i))
               for i in range(3)]
    write_file(str(tmp_path / "x.safetensors"), entries)
    assert made == [0, 1, 2]
    with pytest.raises(ValueError, match="declared"):
        write_file(str(tmp_path / "y.safetensors"),
                   [("t", torch.float32, (3,), lambda: torch.zeros(2))])


def test_unloadable_dtypes_raise_with_the_name(tmp_path):
    path = str(tmp_path / "f8.safetensors")
    torch_save_file({"ok": torch.ones(2),
                     "scale.f8": torch.zeros(4).to(torch.float8_e4m3fn),
                     "mask": torch.ones(3, dtype=torch.bool)}, path)
    f = SafetensorsFile(path)
    assert torch.equal(f.get_tensor("ok"), torch.ones(2))
    for name, tag in (("scale.f8", "F8_E4M3"), ("mask", "BOOL")):
        with pytest.raises(ValueError, match=f"'{name}'.*{tag}"):
            f.get_tensor(name)


def test_byte_range_must_match_the_shape(tmp_path):
    header = json.dumps({"w": {"dtype": "F32", "shape": [2, 3],
                               "data_offsets": [0, 20]}}).encode()
    path = str(tmp_path / "bad.safetensors")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header + bytes(24))
    with pytest.raises(ValueError, match="'w' has byte range"):
        SafetensorsFile(path)


# ---------------------------------------------------------------------------
# every family against the JAX loader
# ---------------------------------------------------------------------------

TINY = {"vocab_size": 128, "hidden_size": 64, "intermediate_size": 96,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16,
        "max_position_embeddings": 256, "rms_norm_eps": 1e-5,
        "tie_word_embeddings": False}
DENSE = {
    "llama": dict(TINY, model_type="llama"),
    "qwen2": dict(TINY, model_type="qwen2"),
    "qwen3": dict(TINY, model_type="qwen3", head_dim=32),
    "gemma2": dict(TINY, model_type="gemma2", tie_word_embeddings=True,
                   query_pre_attn_scalar=16, sliding_window=8,
                   attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0),
    "phi3": dict(TINY, model_type="phi3", num_key_value_heads=4),
}


def _deepseek_json(cfg, v3: bool) -> dict:
    out = {
        "model_type": "deepseek_v3" if v3 else "deepseek_v2",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.dense_intermediate_size,
        "moe_intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_heads,
        "q_lora_rank": cfg.q_lora_rank, "kv_lora_rank": cfg.kv_lora_rank,
        "qk_nope_head_dim": cfg.qk_nope_head_dim,
        "qk_rope_head_dim": cfg.qk_rope_head_dim,
        "v_head_dim": cfg.v_head_dim, "n_routed_experts": cfg.num_experts,
        "num_experts_per_tok": cfg.num_experts_per_tok,
        "n_shared_experts": cfg.shared_expert_size // cfg.intermediate_size,
        "first_k_dense_replace": cfg.first_k_dense,
        "n_group": cfg.n_group, "topk_group": cfg.topk_group,
        "routed_scaling_factor": cfg.routed_scaling,
        "norm_topk_prob": cfg.moe_norm_topk,
        "max_position_embeddings": cfg.max_position_embeddings,
        "rms_norm_eps": cfg.rms_norm_eps, "tie_word_embeddings": False}
    if v3:
        out["num_nextn_predict_layers"] = 1
    else:
        out["topk_method"] = "group_limited_greedy"
    return out


def _perturbed(params, seed):
    """Norms and biases drawn away from the init's constants, so a
    swapped or dropped one shows."""
    r = np.random.default_rng(seed)
    out = {k: np.asarray(v, np.float32) for k, v in params.items()}
    for k, v in out.items():
        leaf = k.rsplit(".", 1)[-1]
        if "norm" in leaf or leaf in ("bq", "bk", "bv", "router_bias"):
            out[k] = (1 + 0.3 * r.standard_normal(v.shape)).astype(
                np.float32)
    return out


def _write_family(d: str, family: str) -> None:
    """The JAX package's checkpoint of a tiny ``family`` model, + its
    config.json."""
    os.makedirs(d, exist_ok=True)
    if family in DENSE:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(DENSE[family], f)
        cfg = JModelConfig.from_model_dir(d)
        p = _perturbed(jllama.init_params(cfg, jax.random.PRNGKey(3),
                                          dtype=jnp.float32), 4)
        jsave({k: jnp.asarray(v) for k, v in p.items()}, cfg, d)
        return
    v3 = family == "deepseek_v3"
    if v3:
        cfg = _v3_cfg()
    else:
        cfg = _moe_cfg(n_group=2, topk_group=1, scaling=2.5)
        cfg.q_lora_rank = 12
    p = _perturbed(jmla.init_params(cfg, jax.random.PRNGKey(5),
                                    dtype=jnp.float32), 6)
    sd = (_to_hf_v3 if v3 else _to_hf_moe)(p, cfg)
    sd = {k: np.ascontiguousarray(v.numpy()) for k, v in sd.items()}
    if v3:
        # the MTP layer at index L: skipped by both loaders
        L = cfg.num_layers
        sd[f"model.layers.{L}.self_attn.kv_a_layernorm.weight"] = np.ones(
            (cfg.kv_lora_rank,), np.float32)
        sd[f"model.layers.{L}.enorm.weight"] = np.ones((cfg.hidden_size,),
                                                       np.float32)
    # two files, split between layers, so the loaders read across both
    names = sorted(sd)
    half = [n for n in names if n.startswith("model.layers.0.")]
    np_save_file({n: sd[n] for n in half},
                 os.path.join(d, "model-00001-of-00002.safetensors"))
    np_save_file({n: sd[n] for n in names if n not in half},
                 os.path.join(d, "model-00002-of-00002.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(_deepseek_json(cfg, v3), f)


FAMILIES = list(DENSE) + ["deepseek_v2", "deepseek_v3"]


@pytest.fixture(scope="module")
def family_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    out = {}
    for fam in FAMILIES:
        out[fam] = str(root / fam)
        _write_family(out[fam], fam)
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_family_loads_exactly_as_jax(family_dirs, family):
    d = family_dirs[family]
    jcfg = JModelConfig.from_model_dir(d)
    want = jload(d, jcfg, dtype=jnp.float32)
    got, cfg = tw.load_params_auto(d, device="cpu", dtype=torch.float32)
    assert set(got) == set(want)
    for k, v in want.items():
        a = np.asarray(v)
        b = got[k].numpy()
        assert b.dtype == np.float32 and b.shape == a.shape, k
        assert np.array_equal(a, b), k
    assert cfg.tie_word_embeddings == jcfg.tie_word_embeddings
    # the model family's own names, and nothing else
    assert set(got) == set(family_of(cfg).param_shapes(cfg))


def _rewrite(d, drop=(), add=None, extra_file=None):
    """Copy of the checkpoint under ``d`` with tensors dropped, and
    ``add`` written to a file of its own."""
    for path in sorted(os.listdir(d)):
        if not path.endswith(".safetensors"):
            continue
        full = os.path.join(d, path)
        with safe_open(full, framework="np") as f:
            sd = {k: f.get_tensor(k) for k in f.keys() if k not in drop}
        np_save_file(sd, full)
    if add:
        np_save_file(add, os.path.join(d, extra_file or "zz-extra.safetensors"))


def _both_raise(d, exc=ValueError):
    with pytest.raises(exc) as je:
        jload(d, JModelConfig.from_model_dir(d), dtype=jnp.float32)
    with pytest.raises(exc) as te:
        tw.load_params_auto(d, device="cpu", dtype=torch.float32)
    assert str(te.value) == str(je.value)
    return str(te.value)


def _copy(family_dirs, family, tmp_path):
    d = str(tmp_path / family)
    shutil.copytree(family_dirs[family], d)
    return d


def test_beyond_l_error_matches_jax(family_dirs, tmp_path):
    d = _copy(family_dirs, "llama", tmp_path)
    _rewrite(d, add={"model.layers.2.self_attn.q_proj.weight":
                     np.zeros((64, 64), np.float32)})
    assert "beyond the config's 2 layers" in _both_raise(d)


def test_missing_layer_error_matches_jax(family_dirs, tmp_path):
    d = _copy(family_dirs, "llama", tmp_path)
    _rewrite(d, drop=("model.layers.1.self_attn.k_proj.weight",))
    assert "coverage wrong for wk: missing [1]" in _both_raise(d)


@pytest.mark.parametrize("name,shape,want", [
    ("model.layers.2.mlp.gate_proj.weight", (128, 64),
     "coverage wrong for dense_gate: missing [], outside-range [2]"),
    ("model.layers.0.mlp.experts.0.up_proj.weight", (48, 64),
     "expert coverage wrong for moe_up: tensors at layers outside [1, 3)"),
], ids=["dense", "expert"])
def test_outside_range_error_matches_jax(family_dirs, tmp_path, name, shape,
                                         want):
    d = _copy(family_dirs, "deepseek_v2", tmp_path)
    _rewrite(d, add={name: np.zeros(shape, np.float32)})
    assert want in _both_raise(d)


def test_no_safetensors_error_matches_jax(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump(DENSE["llama"], f)
    assert "no .safetensors under" in _both_raise(str(tmp_path),
                                                  FileNotFoundError)


def test_implicit_tie_matches_jax(family_dirs, tmp_path):
    d = _copy(family_dirs, "llama", tmp_path)
    _rewrite(d, drop=("lm_head.weight",))
    jcfg = JModelConfig.from_model_dir(d)
    want = jload(d, jcfg, dtype=jnp.float32)
    cfg = ModelConfig.from_model_dir(d)
    got, tied = tw.load_params_auto(d, cfg, device="cpu",
                                    dtype=torch.float32)
    assert jcfg.tie_word_embeddings and tied.tie_word_embeddings
    assert not cfg.tie_word_embeddings        # the caller's config is kept
    assert "lm_head" not in want and set(got) == set(want)
    # the engine builds its head from the embedding
    eng = TorchEngine.from_model_dir(d, EngineConfig(
        dtype="float32", max_model_len=64, num_kv_blocks=16, kv_block_size=8,
        max_num_seqs=2), device="cpu")
    assert eng.core.model_cfg.tie_word_embeddings
    assert "lm_head" not in eng.core.params


def test_shape_mismatch_raises(family_dirs, tmp_path):
    d = _copy(family_dirs, "llama", tmp_path)
    _rewrite(d, drop=("model.layers.1.mlp.up_proj.weight",),
             add={"model.layers.1.mlp.up_proj.weight":
                  np.zeros((96, 32), np.float32)})
    with pytest.raises(ValueError, match="up_proj.weight: shape"):
        tw.load_params_auto(d, device="cpu", dtype=torch.float32)


def test_save_hf_style_roundtrip_and_deepseek_refusal(family_dirs, tmp_path):
    for fam in ("phi3", "gemma2", "qwen2"):
        tree, cfg = tw.load_params_auto(family_dirs[fam], device="cpu",
                                        dtype=torch.bfloat16)
        out = str(tmp_path / fam)
        paths = tw.save_hf_style(tree, cfg, out, max_file_bytes=20000)
        assert len(paths) > 2
        shutil.copy(os.path.join(family_dirs[fam], "config.json"), out)
        back, _ = tw.load_params_auto(out, device="cpu",
                                      dtype=torch.bfloat16)
        assert set(back) == set(tree)
        for k in tree:
            assert back[k].dtype == torch.bfloat16
            assert torch.equal(back[k], tree[k]), (fam, k)
    cfg = ModelConfig.from_model_dir(family_dirs["deepseek_v2"])
    with pytest.raises(NotImplementedError, match="deepseek hybrid MoE"):
        tw.save_hf_style({}, cfg, str(tmp_path / "ds"))


# ---------------------------------------------------------------------------
# quantize-on-load
# ---------------------------------------------------------------------------

# widths where int4 takes 128-row groups (hidden 256, MLP 384)
QTINY = dict(TINY, hidden_size=256, intermediate_size=384, head_dim=64,
             vocab_size=320)
QFAMILIES = {
    "llama": dict(QTINY, model_type="llama"),
    "llama_tied": dict(QTINY, model_type="llama", tie_word_embeddings=True),
    "phi3": dict(QTINY, model_type="phi3", num_key_value_heads=4),
    "qwen2": dict(QTINY, model_type="qwen2"),
}
QUANTIZATIONS = ("int8", "int8-noembed", "int4", "int4-noembed")


@pytest.fixture(scope="module")
def qdirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("qfamilies")
    out = {}
    for fam, hf in QFAMILIES.items():
        d = out[fam] = str(root / fam)
        os.makedirs(d)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(hf, f)
        cfg = JModelConfig.from_model_dir(d)
        p = _perturbed(jllama.init_params(cfg, jax.random.PRNGKey(9),
                                          dtype=jnp.float32), 10)
        jsave({k: jnp.asarray(v) for k, v in p.items()}, cfg, d)
    return out


def _assert_same_tree(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, QuantizedTensor):
            assert isinstance(g, QuantizedTensor), k
            assert (g.group, g.packed4) == (w.group, w.packed4), k
            assert g.q.dtype == w.q.dtype and g.q.shape == w.q.shape, k
            assert torch.equal(g.q, w.q), k
            assert g.scale.shape == w.scale.shape, k
            assert torch.equal(g.scale, w.scale), k
        else:
            assert not isinstance(g, QuantizedTensor), k
            assert g.dtype == w.dtype and torch.equal(g, w), k


@pytest.mark.parametrize("quantization", QUANTIZATIONS)
@pytest.mark.parametrize("family", list(QFAMILIES))
def test_quantize_on_load_is_quantize_params(qdirs, family, quantization,
                                             monkeypatch):
    # chunks of 3000 elements: every matmul, the embedding and the head
    # take several, the last one ragged
    monkeypatch.setattr(tw, "_QUANT_CHUNK", 3000)
    d = qdirs[family]
    bf16, cfg = tw.load_params_auto(d, device="cpu", dtype=torch.bfloat16)
    want = quantize_params(bf16, include_embed=not quantization.endswith(
        "-noembed"), bits=4 if quantization.startswith("int4") else 8)
    with tw.load_accounting() as acct:
        got, qcfg = tw.load_params_auto(d, device="cpu",
                                        dtype=torch.bfloat16,
                                        quantization=quantization)
    _assert_same_tree(got, want)
    assert qcfg == cfg
    assert tree_quantization(got) == quantization
    # the engine serves the tree as it is, and refuses another encoding
    ecfg = dict(dtype="bfloat16", max_model_len=64, num_kv_blocks=16,
                kv_block_size=8, max_num_seqs=2)
    core = EngineCore(qcfg, EngineConfig(quantization=quantization, **ecfg),
                      params=got, device="cpu")
    assert all(core.params[k] is got[k] for k in got)
    other = "int8" if quantization != "int8" else "int4"
    with pytest.raises(ValueError, match=f"quantized as {quantization}"):
        EngineCore(qcfg, EngineConfig(quantization=other, **ecfg),
                   params=got, device="cpu")
    # host staging: one buffer, the largest checkpoint tensor
    sizes = []
    for name in os.listdir(d):
        if name.endswith(".safetensors"):
            f = SafetensorsFile(os.path.join(d, name))
            sizes += [i.nbytes for i in f.tensors.values()]
    assert acct.largest_tensor == max(sizes)
    assert acct.peak == max(sizes) <= 2 * max(sizes)
    assert acct.total == sum(sizes) and acct.live == 0


def test_mla_quantize_on_load_refused(family_dirs):
    with pytest.raises(NotImplementedError, match="MLA"):
        tw.load_params_auto(family_dirs["deepseek_v2"], device="cpu",
                            quantization="int8")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weighted_dir(tmp_path_factory):
    return build_tiny_weighted_model_dir(
        str(tmp_path_factory.mktemp("weighted") / "tiny-weighted"))


def _ecfg(cls, **extra):
    return cls(max_model_len=256, kv_block_size=8, num_kv_blocks=64,
               max_num_seqs=4, prefill_buckets=[32, 64, 128], **extra)


PROMPTS = [[5, 17, 42, 99, 7, 250, 3, 11, 64], [300, 12, 8, 77, 150]]


@pytest.mark.asyncio
async def test_from_model_dir_matches_jax_engine(weighted_dir):
    jeng = JaxEngine.from_model_dir(weighted_dir, _ecfg(JEngineConfig),
                                    attn_impl="xla",
                                    param_dtype=jnp.float32)
    teng = TorchEngine.from_model_dir(weighted_dir,
                                      _ecfg(EngineConfig, dtype="float32"),
                                      device="cpu")
    prompts = PROMPTS + [PROMPTS[0]]
    jout, tout = await run_both(jeng.core, teng.core, prompts, 12,
                                sampling=SAMPLED)
    for (jt, _, _), (tt, _, _) in zip(jout, tout):
        assert len(tt) == 12 and tt == jt
    # the checkpoint's weights, not the engine's random ones
    reng = TorchEngine.from_model_dir(weighted_dir,
                                      _ecfg(EngineConfig, dtype="float32"),
                                      load_weights=False, device="cpu")
    jout2, rout = await run_both(
        JaxEngine.from_model_dir(weighted_dir, _ecfg(JEngineConfig),
                                 attn_impl="xla",
                                 param_dtype=jnp.float32).core,
        reng.core, PROMPTS[:1], 12, sampling=[GREEDY])
    assert rout[0][0] != jout2[0][0]


def _request(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


def _launch(model_dir, *extra):
    """The launcher without --random-weights: (text, token logprobs) of a
    lone greedy and a lone seeded request."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=http",
         "out=torch", "--model-path", model_dir, "--device", "cpu",
         "--http-host", "127.0.0.1", "--http-port", "0",
         "--max-model-len", "256", "--num-kv-blocks", "64",
         "--kv-block-size", "8", "--max-num-seqs", "4", *extra],
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
        texts = []
        for sampling in (GREEDY, SAMPLED[0]):
            status, out = _request(port, {
                "model": os.path.basename(model_dir), "prompt": PROMPTS[0],
                "max_tokens": 8, "logprobs": 1,
                "nvext": {"ignore_eos": True}, **sampling})
            assert status == 200, out
            choice = out["choices"][0]
            texts.append((choice["text"],
                          choice["logprobs"]["token_logprobs"]))
        return texts
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)


async def _lone_tokens(core, sampling):
    from dynamo_tpu_torch.engine.core import FINISH_SENTINEL, EngineRequest
    from dynamo_tpu_torch.engine.sampling import SlotSampling
    req = EngineRequest(rid="lone", prompt=list(PROMPTS[0]),
                        sampling=SlotSampling(**sampling),
                        max_new_tokens=8, eos_ids=frozenset())
    await core.submit(req)
    toks, logprobs = [], []
    while True:
        item, payload = await asyncio.wait_for(req.out_queue.get(), 60)
        if item is FINISH_SENTINEL:
            return toks, logprobs
        toks.append(item)
        logprobs.append(payload)


@pytest.mark.parametrize("flags", [
    (),
    ("--quantization", "int4", "--kv-quantization", "int8", "--ragged",
     "--ragged-max-seq-rows", "8"),
], ids=["bf16", "ragged_int4_kv8"])
def test_launcher_serves_the_checkpoint(weighted_dir, flags):
    texts = _launch(weighted_dir, *flags)
    quant = "int4" if "int4" in flags else "none"
    ecfg = EngineConfig(max_model_len=256, kv_block_size=8,
                        num_kv_blocks=64, max_num_seqs=4,
                        quantization=quant,
                        kv_quantization="int8" if quant != "none" else "none",
                        ragged_dispatch="--ragged" in flags,
                        ragged_max_seq_rows=8 if "--ragged" in flags else 64)

    async def lone():
        out = []
        for sampling in (GREEDY, SAMPLED[0]):
            eng = TorchEngine.from_model_dir(weighted_dir, ecfg,
                                             device="cpu")
            try:
                out.append(await _lone_tokens(eng.core, sampling))
            finally:
                await eng.core.stop()
        return out
    from dynamo_tpu_torch.llm.tokenizer import load_tokenizer
    tok = load_tokenizer(weighted_dir)
    want = []
    for toks, logprobs in asyncio.run(lone()):
        # the server's text is its streaming detokenizer's
        stream = tok.decode_stream(skip_special_tokens=True)
        want.append(("".join(stream.step(t) or "" for t in toks),
                     logprobs))
    assert texts == want


def test_launcher_without_safetensors_exits_with_the_loader_message(
        weighted_dir, tmp_path):
    d = str(tmp_path / "no-weights")
    shutil.copytree(weighted_dir, d,
                    ignore=shutil.ignore_patterns("*.safetensors"))
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=http",
         "out=torch", "--model-path", d, "--device", "cpu",
         "--http-port", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert f"no .safetensors under {d}" in proc.stderr
    assert "READY" not in proc.stdout



_FRESH = r'''
import json, sys
from dynamo_tpu_torch.engine.weights import load_params_auto
params, cfg = load_params_auto(sys.argv[1], device="cpu")
print(json.dumps({"n": len(params),
                  "loaded": sorted(m.split(".")[0] for m in sys.modules)}))
'''


def test_loading_imports_neither_safetensors_nor_jax(family_dirs):
    out = subprocess.run([sys.executable, "-c", _FRESH,
                          family_dirs["phi3"]], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] > 0
    for mod in ("safetensors", "jax", "jaxlib", "dynamo_tpu"):
        assert mod not in res["loaded"], mod
