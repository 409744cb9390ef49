"""The PyTorch port's llama forward passes against the JAX package's.

The JAX model's random parameters (``llama.init_params``, PRNGKey(0), f32)
become the port's through ``params_from_numpy``. Both packages then run the
same schedule on their own KV pools: a prefill of sequence A, a prefill of
sequence B that shares A's first two blocks (a prefix hit, start_pos > 0),
and one batched decode step with A, B and an inactive slot. The JAX side
runs once with its Pallas kernels in interpret mode and once with its XLA
paths.

Tolerances: logits atol=1e-4, KV pool rows atol=1e-5 (f32). XLA's and
PyTorch's CPU matmuls sum in another order, so bit-equality is not
expected; the pools are compared outside the trash block 0, where pad
tokens and inactive slots write in an unspecified order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.weights import params_from_numpy

# KVH*Dh = 128: the geometry the Pallas kernels interpret
GEOM = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
            max_position_embeddings=256)
BS, NUM_BLOCKS, M = 8, 16, 8
LOGIT_ATOL, KV_ATOL = 1e-4, 1e-5

rng = np.random.default_rng(5)
TOKENS_A = rng.integers(1, 128, size=20).tolist()
TOKENS_B = TOKENS_A[:16] + rng.integers(1, 128, size=6).tolist()
TABLE_A = [1, 2, 3]
TABLE_B = [1, 2, 4]          # blocks 1-2 hold the shared 16-token prefix
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
def np_params():
    p = jllama.init_params(JModelConfig(**GEOM), jax.random.PRNGKey(0),
                           dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def torch_run(np_params):
    cfg = ModelConfig(**GEOM)
    params = params_from_numpy(np_params, cfg, device="cpu",
                               dtype=torch.float32)
    kv = tllama.init_kv_cache(cfg, NUM_BLOCKS, BS, "cpu", torch.float32)
    t = lambda a: torch.from_numpy(np.asarray(a))   # noqa: E731
    with torch.inference_mode():
        la = tllama.prefill_forward(params, kv, t(_padded(TOKENS_A, 32)),
                                    t(_table(TABLE_A)), 0, len(TOKENS_A),
                                    cfg, BS)
        lb = tllama.prefill_forward(params, kv, t(_padded(TOKENS_B[16:], 8)),
                                    t(_table(TABLE_B)), 16,
                                    len(TOKENS_B) - 16, cfg, BS)
        toks, pos, tables = _decode_inputs()
        ld = tllama.decode_forward(params, kv, t(toks), t(pos), t(tables),
                                   cfg, BS)
    return {"prefill_a": la.numpy(), "prefill_b": lb.numpy(),
            "decode": ld.numpy(), "k": kv["k"].numpy(), "v": kv["v"].numpy()}


@pytest.fixture(scope="module", params=["pallas_interpret", "xla"])
def jax_run(request, np_params):
    cfg = JModelConfig(**GEOM)
    params = {k: jnp.asarray(v) for k, v in np_params.items()}
    # the decode kernel reads one sequence per program and per-block DMAs:
    # the same function, several times cheaper to interpret
    mp = pytest.MonkeyPatch()
    mp.setenv("DYN_ATTN_SEQS_PER_PROG", "1")
    try:
        statics = jllama.ModelStatics(cfg=cfg, block_size=BS,
                                      attn_impl=request.param,
                                      kv_coalesce=False)
        kv = jllama.init_kv_cache(cfg, NUM_BLOCKS, BS, dtype=jnp.float32)
        la, kv = jllama.prefill_forward(
            params, kv, jnp.asarray(_padded(TOKENS_A, 32)),
            jnp.asarray(_table(TABLE_A)), jnp.int32(0),
            jnp.int32(len(TOKENS_A)), statics)
        lb, kv = jllama.prefill_forward(
            params, kv, jnp.asarray(_padded(TOKENS_B[16:], 8)),
            jnp.asarray(_table(TABLE_B)), jnp.int32(16),
            jnp.int32(len(TOKENS_B) - 16), statics)
        toks, pos, tables = _decode_inputs()
        ld, kv = jllama.decode_forward(params, kv, jnp.asarray(toks),
                                       jnp.asarray(pos), jnp.asarray(tables),
                                       statics)
    finally:
        mp.undo()
    return {"prefill_a": np.asarray(la), "prefill_b": np.asarray(lb),
            "decode": np.asarray(ld), "k": np.asarray(kv["k"]),
            "v": np.asarray(kv["v"])}


def test_prefill_logits_match(torch_run, jax_run):
    np.testing.assert_allclose(torch_run["prefill_a"], jax_run["prefill_a"],
                               atol=LOGIT_ATOL, rtol=0)


def test_prefix_hit_prefill_logits_match(torch_run, jax_run):
    np.testing.assert_allclose(torch_run["prefill_b"], jax_run["prefill_b"],
                               atol=LOGIT_ATOL, rtol=0)


def test_decode_logits_match(torch_run, jax_run):
    # slot 2 is inactive: it attends the trash row, whose content is
    # whichever pad write landed last — only the live slots are compared
    np.testing.assert_allclose(torch_run["decode"][:2],
                               jax_run["decode"][:2], atol=LOGIT_ATOL, rtol=0)
    assert np.isfinite(torch_run["decode"]).all()


def test_kv_pool_rows_match(torch_run, jax_run):
    for name in ("k", "v"):
        np.testing.assert_allclose(torch_run[name][:, BS:],
                                   jax_run[name][:, BS:], atol=KV_ATOL,
                                   rtol=0)
    # the schedule wrote blocks 1-4 and nothing else outside the trash block
    assert np.abs(torch_run["k"][:, 5 * BS:]).max() == 0
