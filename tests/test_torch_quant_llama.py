"""The PyTorch port's quantized llama against the JAX package's, on the CPU.

The JAX model's random parameters (PRNGKey(0), f32), quantized by the JAX
package's ``quantize_params``, become the port's through
``params_from_numpy`` (quantized leaves as their fields). Both packages
then run the schedule of ``test_torch_llama.py``: a prefill of sequence A,
a prefill of sequence B that shares A's first block (a prefix hit,
start_pos > 0), and one batched decode step with A, B and an inactive
slot, in three modes:

- ``int8``: int8 layer matmuls, int8 embedding and LM head, f32 pool;
- ``int4``: grouped int4 layer matmuls (hidden 256: every matmul passes
  the grouped kernel's shape rule, so the port takes the kernel's plain
  version), int8 embedding and head, f32 pool;
- ``int4_kv8``: int4 weights over an int8 KV pool with in-row scales.

The JAX side runs each mode once with its XLA paths and once with its
Pallas attention kernels in interpret mode (block size 32, the int8 pool's
tile; JAX's grouped-int4 and int8-head kernels run only on a TPU, so its
CPU matmuls are the XLA forms either way).

Tolerances (f32): logits atol=1e-4 as in test_torch_llama.py (the same
weights and the same arithmetic, summed in another order; measured
differences are below 5e-6). An int8 pool row is also compared
dequantized: the K/V vectors that both packages quantize differ by f32
rounding, so a value at a rounding boundary could land one step apart
(at most one quantization step, the row's scale); at most 0.1 % of the
bytes may differ (none do at this seed). The pools are compared outside
the trash block 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine import quant as jquant
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu_torch.engine import attention as tattn
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.weights import params_from_numpy

GEOM = dict(vocab_size=128, hidden_size=256, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
            max_position_embeddings=256)
C = 2 * 64
BS, NUM_BLOCKS, M = 32, 6, 4
MODES = {"int8": (8, "none"), "int4": (4, "none"), "int4_kv8": (4, "int8")}

rng = np.random.default_rng(7)
TOKENS_A = rng.integers(1, 128, size=40).tolist()
TOKENS_B = TOKENS_A[:32] + rng.integers(1, 128, size=6).tolist()
TABLE_A = [1, 2]
TABLE_B = [1, 3]             # block 1 holds the shared 32-token prefix
DECODE_IN = [7, 9, 0]        # slot 2 is inactive


def _padded(tokens, n):
    out = np.zeros((n,), np.int32)
    out[:len(tokens)] = tokens
    return out


def _table(blocks):
    out = np.zeros((M,), np.int32)
    out[:len(blocks)] = blocks
    return out


def _decode_inputs():
    tables = np.stack([_table(TABLE_A), _table(TABLE_B), _table([])])
    positions = np.array([len(TOKENS_A), len(TOKENS_B), 0], np.int32)
    return np.array(DECODE_IN, np.int32), positions, tables


@pytest.fixture(scope="module")
def jax_params():
    return jllama.init_params(JModelConfig(**GEOM), jax.random.PRNGKey(0),
                              dtype=jnp.float32)


def _quantized(jax_params, bits):
    return jquant.quantize_params(dict(jax_params), include_embed=True,
                                  bits=bits)


def _to_numpy(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, jquant.QuantizedArray):
            out[k] = {"q": np.asarray(v.q), "scale": np.asarray(v.scale),
                      "group": v.group, "packed4": v.packed4}
        else:
            out[k] = np.asarray(v)
    return out


def _torch_run(np_tree, kv_quant):
    cfg = ModelConfig(**GEOM)
    params = params_from_numpy(np_tree, cfg, device="cpu",
                               dtype=torch.float32)
    kv = tllama.init_kv_cache(cfg, NUM_BLOCKS, BS, "cpu", torch.float32,
                              quantization=kv_quant)
    t = lambda a: torch.from_numpy(np.asarray(a))   # noqa: E731
    with torch.inference_mode():
        la = tllama.prefill_forward(params, kv, t(_padded(TOKENS_A, 64)),
                                    t(_table(TABLE_A)), 0, len(TOKENS_A),
                                    cfg, BS)
        lb = tllama.prefill_forward(params, kv, t(_padded(TOKENS_B[32:], 8)),
                                    t(_table(TABLE_B)), 32,
                                    len(TOKENS_B) - 32, cfg, BS)
        toks, pos, tables = _decode_inputs()
        ld = tllama.decode_forward(params, kv, t(toks), t(pos), t(tables),
                                   cfg, BS)
    return {"prefill_a": la.numpy(), "prefill_b": lb.numpy(),
            "decode": ld.numpy(), "k": kv["k"].numpy(), "v": kv["v"].numpy()}


def _jax_run(tree, kv_quant, impl):
    cfg = JModelConfig(**GEOM)
    mp = pytest.MonkeyPatch()
    mp.setenv("DYN_ATTN_SEQS_PER_PROG", "1")
    try:
        statics = jllama.ModelStatics(cfg=cfg, block_size=BS, attn_impl=impl,
                                      kv_coalesce=False)
        kv = jllama.init_kv_cache(cfg, NUM_BLOCKS, BS, dtype=jnp.float32,
                                  quantization=kv_quant)
        la, kv = jllama.prefill_forward(
            tree, kv, jnp.asarray(_padded(TOKENS_A, 64)),
            jnp.asarray(_table(TABLE_A)), jnp.int32(0),
            jnp.int32(len(TOKENS_A)), statics)
        lb, kv = jllama.prefill_forward(
            tree, kv, jnp.asarray(_padded(TOKENS_B[32:], 8)),
            jnp.asarray(_table(TABLE_B)), jnp.int32(32),
            jnp.int32(len(TOKENS_B) - 32), statics)
        toks, pos, tables = _decode_inputs()
        ld, kv = jllama.decode_forward(tree, kv, jnp.asarray(toks),
                                       jnp.asarray(pos), jnp.asarray(tables),
                                       statics)
    finally:
        mp.undo()
    return {"prefill_a": np.asarray(la), "prefill_b": np.asarray(lb),
            "decode": np.asarray(ld), "k": np.asarray(kv["k"]),
            "v": np.asarray(kv["v"])}


@pytest.fixture(scope="module", params=[
    (mode, impl) for mode in MODES for impl in ("xla", "pallas_interpret")],
    ids=lambda p: "-".join(p))
def runs(request, jax_params):
    mode, impl = request.param
    bits, kv_quant = MODES[mode]
    tree = _quantized(jax_params, bits)
    return (mode, _torch_run(_to_numpy(tree), kv_quant),
            _jax_run(tree, kv_quant, impl))


LOGIT_ATOL = 1e-4


def test_quantized_prefill_logits_match(runs):
    _, got, want = runs
    for name in ("prefill_a", "prefill_b"):     # fresh, then a prefix hit
        np.testing.assert_allclose(got[name], want[name],
                                   atol=LOGIT_ATOL, rtol=0)


def test_quantized_decode_logits_match(runs):
    _, got, want = runs
    # slot 2 is inactive and attends the trash row: live slots only
    np.testing.assert_allclose(got["decode"][:2], want["decode"][:2],
                               atol=LOGIT_ATOL, rtol=0)
    assert np.isfinite(got["decode"]).all()


def test_quantized_kv_pool_rows_match(runs):
    mode, got, want = runs
    for name in ("k", "v"):
        g, w = got[name][:, BS:], want[name][:, BS:]
        if mode != "int4_kv8":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
            continue
        assert g.dtype == np.int8 and g.shape[-1] == C + 128
        assert (g != w).mean() <= 1e-3
        gd = tattn.dequant_kv_rows(torch.from_numpy(g), C,
                                   torch.float32).numpy()
        wd = np.asarray(jattn.dequant_kv_rows(jnp.asarray(w), C,
                                              jnp.float32))
        step = tattn._decode_scale(torch.from_numpy(w[..., C].copy()),
                                   torch.from_numpy(w[..., C + 1].copy())
                                   ).numpy()
        assert (np.abs(gd - wd) <= 1.01 * step[..., None] + 1e-6).all()
    # the schedule wrote blocks 1-3 and nothing else outside the trash block
    assert not got["k"][:, 4 * BS:].any()
