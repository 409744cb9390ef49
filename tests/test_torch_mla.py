"""The port's MLA path (DeepSeek-V2) against the JAX package's, on the CPU.

Every case feeds both packages the same numpy inputs:

- ``ModelConfig.from_hf_config`` of ``chip_smoke.DEEPSEEK_V2_LITE_CONFIG``
  gives the same fields in both packages, the latent row widths (640 bf16,
  768 int8), the auto block sizes (16, 32) and 15,706,484,224 parameters.
- The sectioned int8 encoding of latent rows: the port's bytes equal JAX's
  bit for bit, and so does the dequantized row, with a k_pe section 15x
  the c_kv section.
- The plain versions of K3 and K4 in the MLA modes (``v_lanes`` over an
  f32 pool, ``quant_sections`` over an int8 pool) against JAX's Pallas
  kernels in interpret mode at the shapes of
  ``tests/test_paged_attention_kernel.py`` (rank 128, rope 64, query width
  256, int8 row 384, block 32): f32 atol=rtol=2e-5, int8 2e-4 (the bars of
  ``tests/test_torch_ragged.py``); the split forms merge to the plain
  output (atol=rtol=2e-5; the splits sum in another order). The latent
  kernels' plan (``latent_split_plan``, ``latent_decode_clusters``,
  ``ragged_row_plan`` at 4 rows a tile, the partials room): the split
  forms at that plan over rows of up to 384 keys (chunks of 32 and 64),
  with the splits past a row's live ones empty, merge to the plain output
  and to JAX's kernels at the same bars.
- The JAX kernels' rule for the modes (``check_latent_modes``) refuses what
  JAX refuses, with ValueError.
- The deepseek MoE block (v2 greedy, v2 group-limited with n_group 2 and
  topk_group 1, v3 ``sigmoid_noaux``), ``run_experts_dense``, the yarn rope
  parameters and softmax scale of V2-Lite: f32 atol=1e-5 (rope and scale
  to f32 / f64 precision).
- The forward passes (a prefill, a prefill after a prefix hit, a batched
  decode step, two ragged dispatches) and the pool rows they wrote, at a
  rank-128 geometry (3 layers, the first dense, 4 experts top-2 with
  shared experts: ``v_lanes`` engages) and at JAX's ``tiny_mla`` (rank 64,
  the sliced path), over f32 and int8 latent pools: logits atol=1e-4, pool
  rows atol=1e-5 (f32; the two frameworks sum in another order); int8 rows
  bit-equal but for a rare one-level rounding of a value at .5, which
  moves a logit by up to ~7e-3 here (atol=2e-2).
- ``EngineCore`` streams of both packages at the rank-128 geometry, greedy
  and seeded sampled in one run, over f32 and int8 pools: split K = 1, K = 4
  pipelined with a lane admission (the port's second request submitted
  at the first's 1st and 6th emitted token; the JAX reference, the two
  requests alone at K = 4 unpipelined), chunked prefill with a prefix hit,
  and ragged dispatch: equal streams. Two prompts posted back to back at K = 4
  with the first token's fetch deferred and fetched at once: equal lane
  admissions, host round trips and streams.
- MLA with int4 or int8 weights, and with sp > 1, refuses with
  NotImplementedError; so does a MoE llama family.
- The launcher serves a model directory holding a tiny ``deepseek_v2``
  config with ``--random-weights`` on the CPU (split, and ragged over an
  int8 latent pool).

On the card the int8 decode path takes K3-MLA with a bf16 query (JAX's TPU
path) where the CPU gathers with an f32 query (JAX's CPU path); the card
tests and ``chip_smoke.py`` hold that kernel against its plain version.
"""

import asyncio
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import DEEPSEEK_V2_LITE_CONFIG
from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.config import bench_model_config
from dynamo_tpu.engine.core import EngineCore as JEngineCore
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.models import mla as jmla
from dynamo_tpu_torch.engine import attention as tattn
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.models import mla as tmla
from dynamo_tpu_torch.engine.weights import init_params, params_from_numpy
from tests.test_torch_dispatch import SEEDED, Side
from tests.test_torch_serving import SP_FIXTURE, _launch_and_request

F32_TOL, INT8_TOL = 2e-5, 2e-4
LOGIT_ATOL, KV_ATOL = 1e-4, 1e-5
# over an int8 pool a latent value whose f32 quotient the two frameworks
# round to either side of .5 lands one level apart (test_mla_pool_rows_
# match bounds those to < 0.1 % of the bytes); at these weights one such
# level moves a logit by up to ~7e-3
INT8_LOGIT_ATOL = 2e-2

# rank 128 (v_lanes engages), rope 64: a latent row of 192 lanes, 256 in a
# f32 pool and 384 in an int8 one; the first layer dense, then 4 experts
# top-2 (groups of 2 for the group-limited routing) with shared experts
GEOM = dict(model_type="deepseek_v2", vocab_size=256, hidden_size=64,
            intermediate_size=32, num_layers=3, num_heads=4, num_kv_heads=4,
            head_dim=96, q_lora_rank=0, kv_lora_rank=128,
            qk_nope_head_dim=32, qk_rope_head_dim=64, v_head_dim=32,
            num_experts=4, num_experts_per_tok=2, moe_norm_topk=False,
            first_k_dense=1, dense_intermediate_size=64,
            shared_expert_size=32, max_position_embeddings=512)
TINY = {f.name: getattr(bench_model_config("tiny_mla"), f.name)
        for f in dataclasses.fields(ModelConfig)}
GEOMS = {"rank128": GEOM, "tiny_mla": TINY}
KV_MODES = ("none", "int8")


def _np_params(geom, seed):
    p = jmla.init_params(JModelConfig(**geom), jax.random.PRNGKey(seed),
                         dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------


def test_deepseek_v2_lite_config_matches_jax():
    got = ModelConfig.from_hf_config(DEEPSEEK_V2_LITE_CONFIG)
    want = JModelConfig.from_hf_config(DEEPSEEK_V2_LITE_CONFIG)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "rope_scaling":
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    assert (got.kv_lora_rank, got.qk_rope_head_dim, got.num_heads) == (
        512, 64, 16)
    assert (got.num_experts, got.num_experts_per_tok, got.first_k_dense,
            got.shared_expert_size) == (64, 6, 1, 2816)
    assert not got.tie_word_embeddings
    assert (tmla.latent_row_lanes(got), tmla.latent_row_lanes(got, "int8")
            ) == (jmla.latent_row_lanes(want),
                  jmla.latent_row_lanes(want, "int8")) == (640, 768)
    assert (EngineConfig.auto_kv_block_size(got),
            EngineConfig.auto_kv_block_size(got, "int8")) == (16, 32)
    shapes = tmla.param_shapes(got)
    assert shapes == jmla.param_shapes(want)
    assert sum(int(np.prod(s)) for s in shapes.values()) == 15706484224


def test_params_from_numpy_and_init_params_follow_mla_shapes():
    cfg = ModelConfig(**GEOM)
    np_p = _np_params(GEOM, 0)
    got = params_from_numpy(np_p, cfg, "cpu", torch.float32)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in np_p.items()}
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np_p[k])
    rnd = init_params(cfg, 3, "cpu", torch.float32)
    assert {k: tuple(v.shape) for k, v in rnd.items()} == {
        k: tuple(v) for k, v in tmla.param_shapes(cfg).items()}
    assert (rnd["layers.kv_norm"] == 1).all()
    # expert stacks drawn one matrix at a time at 1 / sqrt(fan_in)
    std = rnd["layers.moe_gate"].std().item()
    assert abs(std * GEOM["hidden_size"] ** 0.5 - 1) < 0.1


# ---------------------------------------------------------------------------
# the sectioned int8 encoding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skew", [1.0, 15.0], ids=["even", "skewed_k_pe"])
def test_sectioned_encoding_bytes_match_jax(skew):
    r = np.random.default_rng(1)
    x = np.concatenate([r.normal(size=(40, 128)),
                        r.normal(size=(40, 64)) * skew], 1).astype(np.float32)
    x[3] = 0.0                           # an all-zero row
    want = np.asarray(jattn.quantize_kv_rows_sections(jnp.asarray(x),
                                                      (128, 64)))
    got = tattn.quantize_kv_rows_sections(_t(x), (128, 64)).numpy()
    np.testing.assert_array_equal(got, want)
    padded = np.pad(want, ((0, 0), (0, 64)))      # a 384-lane pool row
    np.testing.assert_array_equal(
        tattn.dequant_kv_rows_sections(_t(padded), (128, 64),
                                       torch.float32).numpy(),
        np.asarray(jattn.dequant_kv_rows_sections(jnp.asarray(padded),
                                                  (128, 64), jnp.float32)))


# ---------------------------------------------------------------------------
# the plain K3 / K4 MLA modes against JAX's Pallas kernels
# ---------------------------------------------------------------------------

RANK, DR, WQ, PBS, NB = 128, 64, 256, 32, 32


def _latent_pool(r, int8):
    """A pool of NB blocks of PBS latent rows: [c (128) | k_pe (64) x 15]
    padded to 256 lanes (f32) or encoded in 384 (int8)."""
    vals = np.concatenate([r.normal(size=(NB * PBS, RANK)),
                           r.normal(size=(NB * PBS, DR)) * 15.0],
                          1).astype(np.float32)
    if not int8:
        return np.pad(vals, ((0, 0), (0, WQ - RANK - DR)))
    enc = np.asarray(jattn.quantize_kv_rows_sections(jnp.asarray(vals),
                                                     (RANK, DR)))
    return np.pad(enc, ((0, 0), (0, 384 - enc.shape[1])))


def _mode_kw(int8):
    return dict(v_lanes=RANK, quant_sections=(RANK, DR) if int8 else None)


P_LENS = [1, 31, 32, 33, 97, 128, 0]


@pytest.mark.parametrize("int8", [False, True], ids=["v_lanes", "sections"])
def test_paged_plain_mla_modes_match_jax_kernel(int8, monkeypatch):
    monkeypatch.setenv("DYN_ATTN_SEQS_PER_PROG", "1")
    r = np.random.default_rng(5)
    pool = _latent_pool(r, int8)
    B = len(P_LENS)
    tables = r.integers(0, NB, size=(B, 4)).astype(np.int32)
    lens = np.asarray(P_LENS, np.int32)
    q = (r.normal(size=(B, 8, WQ)) * 0.3).astype(np.float32)
    kw = dict(block_size=PBS, scale=0.05, **_mode_kw(int8))
    got = tattn.paged_attention(_t(q), _t(pool), _t(pool), _t(tables),
                                _t(lens), **kw).numpy()
    want = np.asarray(jattn.paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(pool),
        jnp.asarray(tables), jnp.asarray(lens), chunk_blocks=1,
        interpret=True, **{k: v for k, v in kw.items() if v is not None}))
    assert got.shape == (B, 8, RANK)
    live = lens > 0
    tol = INT8_TOL if int8 else F32_TOL
    np.testing.assert_allclose(got[live], want[live], rtol=tol, atol=tol)
    assert not got[~live].any()
    # the split form (K3's arithmetic, one-block chunks) merges to it
    parts = tattn.paged_attention_partials_ref(
        _t(q), _t(pool), _t(pool), _t(tables), _t(lens), chunk=PBS, **kw)
    np.testing.assert_allclose(tattn.merge_split_partials(*parts).numpy(),
                               got, rtol=F32_TOL, atol=F32_TOL)


# a 20-row chunk continuing a prefix to 100 keys, a fresh 9-row prompt,
# decode rows at 33 and 128 keys, a zero-count slot
R_SPANS = [(20, 100), (9, 9), (1, 33), (1, 128), (0, 0)]


@pytest.mark.parametrize("int8", [False, True], ids=["v_lanes", "sections"])
def test_ragged_plain_mla_modes_match_jax_kernel(int8):
    r = np.random.default_rng(6)
    pool = _latent_pool(r, int8)
    S = len(R_SPANS)
    tables = r.permutation(np.arange(1, NB))[:S * 4].reshape(
        S, 4).astype(np.int32)
    counts = np.asarray([n for n, _ in R_SPANS], np.int32)
    ctx = np.asarray([c for _, c in R_SPANS], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    total = int(counts.sum())
    q = (r.normal(size=(total + 2, 4, WQ)) * 0.3).astype(np.float32)
    rows = np.concatenate([np.arange(s, s + n)
                           for s, n in zip(starts, counts)])
    kw = dict(block_size=PBS, scale=0.07, max_rows=32, **_mode_kw(int8))
    got = tattn.ragged_paged_attention(
        _t(q), _t(pool), _t(pool), _t(tables), _t(starts), _t(counts),
        _t(ctx), **kw).numpy()
    want = np.asarray(jattn.ragged_paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(pool),
        jnp.asarray(tables), jnp.asarray(starts), jnp.asarray(counts),
        jnp.asarray(ctx), chunk_blocks=1, interpret=True,
        **{k: v for k, v in kw.items() if v is not None}))
    tol = INT8_TOL if int8 else F32_TOL
    np.testing.assert_allclose(got[rows], want[rows], rtol=tol, atol=tol)
    assert not got[total:].any()
    # K4-MLA's split form: one row a tile, K3's chunks
    parts = tattn.ragged_attention_partials_ref(
        _t(q), _t(pool), _t(pool), _t(tables), _t(starts), _t(counts),
        _t(ctx), **kw)
    assert parts[2].shape[-2:] == (4, RANK)
    np.testing.assert_allclose(
        tattn.merge_split_partials(*parts).numpy()[rows], got[rows],
        rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# the latent kernels' plan: LATENT_TILE_ROWS rows a tile, LATENT_SPLITS
# splits of whole 32-key tiles from the keys the tile sees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_keys,splits,chunk,live", [
    (0, 8, 32, 0), (1, 8, 32, 1), (32, 8, 32, 1), (33, 8, 32, 2),
    (129, 8, 32, 5), (256, 8, 32, 8), (257, 8, 64, 5), (1000, 8, 128, 8),
    (3000, 8, 384, 8), (4096, 8, 512, 8), (0, 28, 32, 0), (129, 28, 32, 5),
    (300, 28, 32, 10), (1000, 28, 64, 16), (3000, 28, 128, 24),
    (4096, 28, 160, 26), (4096, 64, 64, 64)])
def test_latent_split_plan(n_keys, splits, chunk, live):
    """K4-MLA's 8 splits (the default) and K3-MLA's at batches 8 (28) and
    1 (64)."""
    assert tattn.latent_split_plan(n_keys, splits) == (chunk, live)
    if splits == tattn.LATENT_SPLITS:
        assert tattn.latent_split_plan(n_keys) == (chunk, live)
    assert live <= splits and chunk % tattn.LATENT_KEY_TILE == 0


@pytest.mark.parametrize("B,clusters", [(1, 16), (2, 16), (3, 16), (4, 15),
                                        (8, 7), (16, 3), (60, 1), (136, 1)])
def test_latent_decode_clusters(B, clusters):
    """K3-MLA's clusters a row: about 120 CTAs a call, 1 to 16 a row; two
    CTAs a cluster, two splits a CTA."""
    assert tattn.latent_decode_clusters(B) == clusters
    assert tattn.latent_decode_splits(B) == 4 * clusters
    assert B * clusters * tattn.LATENT_DECODE_CLUSTER <= max(
        tattn.LATENT_DECODE_CTAS, 2 * B)


def test_latent_ragged_row_plan():
    """g = 16 at LATENT_TILE_ROWS = 4: a 7-row chunk whose first tile sees
    255 keys (eight one-tile splits) and whose second, 3 rows that cross
    the sequence's end, sees 258 (five of 64); decode rows at 1, 4096 and
    past the table (4096 keys: eight of 512); a zero-count sequence; rows
    no sequence owns."""
    assert tattn.LATENT_TILE_ROWS == 4
    spans = [(7, 258), (1, 1), (0, 0), (1, 4096), (1, 5000)]
    counts = torch.tensor([n for n, _ in spans], dtype=torch.int32)
    ctx = torch.tensor([c for _, c in spans], dtype=torch.int32)
    starts = torch.tensor([0, 7, 8, 8, 9], dtype=torch.int32)
    chunks, live = tattn.ragged_row_plan(starts, counts, ctx, 12, 16, 256,
                                         16, tattn.LATENT_TILE_ROWS)
    assert chunks.tolist() == [32] * 4 + [64] * 3 + [32, 512, 512, 0, 0]
    assert live.tolist() == [8] * 4 + [5] * 3 + [1, 8, 8, 0, 0]


# decode rows across the latent plan's chunks (1-, 2- and 12-tile splits),
# over tables of 12 blocks of 32
P_LENS_LONG = [0, 1, 31, 33, 129, 257, 300, 384]
# a 7-row chunk whose tiles see 255 and 258 keys, a 6-row chunk to 300, a
# decode row at 384, a 3-row chunk to 40, a zero-count slot
R_SPANS_LONG = [(7, 258), (6, 300), (1, 384), (3, 40), (0, 0)]


def _long_case(r, int8, n):
    pool = _latent_pool(r, int8)
    tables = r.integers(0, NB, size=(n, 12)).astype(np.int32)
    return pool, tables


@pytest.mark.parametrize("int8", [False, True], ids=["v_lanes", "sections"])
def test_latent_paged_partials_follow_the_plan(int8, monkeypatch):
    """K3-MLA's split form: ``latent_decode_splits(B)`` splits a row, cut
    by the keys the row sees; the splits past its live ones empty; merged,
    the plain output and JAX's Pallas kernel (interpret mode); one live
    split left out of a multi-split row moves it."""
    monkeypatch.setenv("DYN_ATTN_SEQS_PER_PROG", "1")
    r = np.random.default_rng(8)
    B = len(P_LENS_LONG)
    pool, tables = _long_case(r, int8, B)
    lens = np.asarray(P_LENS_LONG, np.int32)
    q = (r.normal(size=(B, 16, WQ)) * 0.3).astype(np.float32)
    kw = dict(block_size=PBS, scale=0.05, **_mode_kw(int8))
    args = (_t(q), _t(pool), _t(pool), _t(tables), _t(lens))
    m, l, acc = tattn.paged_attention_partials_ref(*args, **kw)
    S = tattn.latent_decode_splits(B)
    assert S == 28 and acc.shape == (B, 1, S, 16, RANK)
    for b, n in enumerate(P_LENS_LONG):
        live = tattn.latent_split_plan(n, S)[1]
        assert torch.isfinite(m[b, 0, :live]).all()
        assert torch.isneginf(m[b, 0, live:]).all()
        assert not l[b, 0, live:].any() and not acc[b, 0, live:].any()
    merged = tattn.merge_split_partials(m, l, acc).numpy()
    plain = tattn.paged_attention_ref(*args, **kw).numpy()
    want = np.asarray(jattn.paged_attention_pallas(
        *(jnp.asarray(a) for a in (q, pool, pool, tables, lens)),
        chunk_blocks=1, interpret=True,
        **{k: v for k, v in kw.items() if v is not None}))
    tol = INT8_TOL if int8 else F32_TOL
    live = lens > 0
    np.testing.assert_allclose(merged, plain, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(merged[live], want[live], rtol=tol, atol=tol)
    m[:, :, 0], l[:, :, 0], acc[:, :, 0] = float("-inf"), 0, 0
    dropped = tattn.merge_split_partials(m, l, acc).numpy()
    multi = [b for b, n in enumerate(P_LENS_LONG)
             if tattn.latent_split_plan(n, S)[1] > 1]
    assert all(np.abs(dropped[b] - plain[b]).max() > 1e-2 for b in multi)


@pytest.mark.parametrize("int8", [False, True], ids=["v_lanes", "sections"])
def test_latent_ragged_partials_follow_the_plan(int8):
    """K4-MLA's split form at LATENT_TILE_ROWS: each row cut by its tile's
    chunk into LATENT_SPLITS splits, a row's splits past its tile's live
    ones and every split of a row no sequence owns empty; merged, the
    plain output and JAX's ragged Pallas kernel (interpret mode)."""
    r = np.random.default_rng(9)
    S = len(R_SPANS_LONG)
    pool, tables = _long_case(r, int8, S)
    counts = np.asarray([n for n, _ in R_SPANS_LONG], np.int32)
    ctx = np.asarray([c for _, c in R_SPANS_LONG], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    total = int(counts.sum())
    TT = total + 3
    q = (r.normal(size=(TT, 16, WQ)) * 0.3).astype(np.float32)
    kw = dict(block_size=PBS, scale=0.07, max_rows=32, **_mode_kw(int8))
    args = tuple(_t(a) for a in (q, pool, pool, tables, starts, counts, ctx))
    m, l, acc = tattn.ragged_attention_partials_ref(*args, **kw)
    assert acc.shape == (TT, 1, tattn.LATENT_SPLITS, 16, RANK)
    _, live = tattn.ragged_row_plan(args[4], args[5], args[6], TT, 16, 12,
                                    PBS, tattn.LATENT_TILE_ROWS)
    assert live[:7].tolist() == [8] * 4 + [5] * 3
    for t in range(TT):
        n = int(live[t])
        assert torch.isneginf(m[t, 0, n:]).all() and not acc[t, 0, n:].any()
    assert torch.isneginf(m[total:]).all()
    merged = tattn.merge_split_partials(m, l, acc).numpy()
    plain = tattn.ragged_paged_attention_ref(*args, **kw).numpy()
    want = np.asarray(jattn.ragged_paged_attention_pallas(
        *(jnp.asarray(a) for a in (q, pool, pool, tables, starts, counts,
                                   ctx)),
        chunk_blocks=1, interpret=True,
        **{k: v for k, v in kw.items() if v is not None}))
    rows = np.concatenate([np.arange(s, s + n)
                           for s, n in zip(starts, counts)])
    tol = INT8_TOL if int8 else F32_TOL
    np.testing.assert_allclose(merged, plain, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(merged[rows], want[rows], rtol=tol, atol=tol)


def test_latent_scratch_follows_the_plan():
    """The latent kernels' partials room (``kernels.paged_scratch`` with
    v_lanes): ``latent_decode_splits(B)`` (K3-MLA: 28 at B = 8, 4 at 136)
    or, ragged, LATENT_SPLITS (K4-MLA) splits of 16 heads x (512 + 2)
    floats a row, whatever the table's width (K3's and K4's room grows
    with it)."""
    from dynamo_tpu_torch.engine import kernels
    for rows, ragged, S in ((8, False, 28), (136, False, 4),
                            (136, True, tattn.LATENT_SPLITS)):
        q = torch.zeros((rows, 16, 640))
        want = rows * S * 16 * (512 + 2)
        for M in (256, 4096 // 32, 8192 // 16, 131072 // 16):
            assert kernels.paged_scratch(q, 1, M, 16, 512,
                                         ragged=ragged).numel() == want
    q8 = torch.zeros((136, 32, 128))
    assert kernels.paged_scratch(q8, 8, 512, 16).numel() == (
        136 * 8 * 64 * 4 * 130)


def _refusal_case(name):
    r = np.random.default_rng(7)
    f32 = torch.zeros((64, 256))
    i8 = _t(_latent_pool(r, True)[:64])
    single = tattn.quantize_kv_rows(torch.zeros((64, 256)))   # 384 lanes
    q1, q2 = torch.zeros((2, 8, 256)), torch.zeros((2, 8, 128))
    return {
        "sections_on_bf16_pool": (q1, f32, dict(v_lanes=128,
                                                quant_sections=(128, 64))),
        "sections_without_v_lanes": (q1, i8, dict(quant_sections=(128, 64))),
        "v_lanes_over_two_kv_heads": (q2, f32, dict(v_lanes=128)),
        "v_lanes_not_128_aligned": (q1, f32, dict(v_lanes=100)),
        "v_lanes_on_single_scale_int8": (q1, single, dict(v_lanes=128)),
        "sections_off_the_query_width": (q2, i8, dict(
            v_lanes=128, quant_sections=(128, 64))),
    }[name]


@pytest.mark.parametrize("name", [
    "sections_on_bf16_pool", "sections_without_v_lanes",
    "v_lanes_over_two_kv_heads", "v_lanes_not_128_aligned",
    "v_lanes_on_single_scale_int8", "sections_off_the_query_width"])
def test_mla_modes_refused_as_in_jax(name):
    q, pool, kw = _refusal_case(name)
    tables = torch.zeros((2, 2), dtype=torch.int32)
    lens = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(ValueError):
        tattn.paged_attention(q, pool, pool, tables, lens, block_size=32,
                              scale=0.1, **kw)
    with pytest.raises(ValueError):
        tattn.ragged_paged_attention(q, pool, pool, tables,
                                     torch.tensor([0, 1], dtype=torch.int32),
                                     lens, lens, block_size=32, scale=0.1,
                                     max_rows=4, **kw)
    with pytest.raises(ValueError):       # JAX's kernel refuses it too
        jattn.paged_attention_pallas(
            jnp.asarray(q.numpy()), jnp.asarray(pool.numpy()),
            jnp.asarray(pool.numpy()), jnp.asarray(tables.numpy()),
            jnp.asarray(lens.numpy()), block_size=32, scale=0.1,
            interpret=True, **kw)


# ---------------------------------------------------------------------------
# routing, experts, rope
# ---------------------------------------------------------------------------

ROUTINGS = {
    "v2_greedy": dict(),
    "v2_group_limited": dict(n_group=2, topk_group=1),
    "v3_sigmoid_noaux": dict(model_type="deepseek_v3",
                             moe_routing="sigmoid_noaux", n_group=2,
                             topk_group=1, moe_norm_topk=True,
                             routed_scaling=2.5),
}


@pytest.mark.parametrize("routing", list(ROUTINGS))
def test_moe_block_matches_jax(routing):
    geom = dict(GEOM, **ROUTINGS[routing])
    np_p = _np_params(geom, 2)
    r = np.random.default_rng(8)
    if "layers.router_bias" in np_p:
        # the v3 choice bias, positive as a trained correction bias is: an
        # expert of a masked group (choice 0) then never ties with another
        # (jax.lax.top_k and torch.topk break ties differently)
        np_p["layers.router_bias"] = np.abs(r.normal(
            size=np_p["layers.router_bias"].shape)).astype(np.float32)
    hn = r.normal(size=(12, GEOM["hidden_size"])).astype(np.float32)
    names = ("router", "router_bias", "moe_gate", "moe_up", "moe_down",
             "sh_gate", "sh_up", "sh_down")
    lp = {n: np_p["layers." + n][0] for n in names if "layers." + n in np_p}
    want = np.asarray(jmla._moe_mlp(
        jnp.asarray(hn), {n: jnp.asarray(v) for n, v in lp.items()},
        JModelConfig(**geom)))
    got = tmla._moe_mlp(_t(hn), {n: _t(v) for n, v in lp.items()},
                        ModelConfig(**geom)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_run_experts_dense_matches_jax():
    r = np.random.default_rng(9)
    x = r.normal(size=(5, 16)).astype(np.float32)
    w = [r.normal(size=s).astype(np.float32)
         for s in ((4, 16, 8), (4, 16, 8), (4, 8, 16))]
    idx = np.array([[0, 2], [1, 3], [3, 0], [2, 1], [0, 1]], np.int32)
    wt = r.random(size=(5, 2)).astype(np.float32)
    want = np.asarray(jllama.run_experts_dense(
        jnp.asarray(x), *map(jnp.asarray, w), jnp.asarray(idx),
        jnp.asarray(wt)))
    got = tllama.run_experts_dense(_t(x), *map(_t, w), _t(idx),
                                   _t(wt)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("model_type", ["deepseek_v2", "deepseek_v3"])
def test_yarn_rope_and_softmax_scale_match_jax(model_type):
    hf = dict(DEEPSEEK_V2_LITE_CONFIG, model_type=model_type)
    if model_type == "deepseek_v3":
        hf.update(scoring_func="sigmoid", topk_method="noaux_tc",
                  norm_topk_prob=True, n_group=8, topk_group=4,
                  n_routed_experts=64)
    tcfg, jcfg = ModelConfig.from_hf_config(hf), JModelConfig.from_hf_config(hf)
    inv, att = tmla.rope_params(tcfg)
    jinv, jatt = jmla.rope_params(jcfg)
    np.testing.assert_array_equal(inv, jinv)
    assert att == jatt and tmla.softmax_scale(tcfg) == jmla.softmax_scale(jcfg)
    r = np.random.default_rng(10)
    x = r.normal(size=(7, 3, 64)).astype(np.float32)
    pos = np.array([0, 1, 5, 100, 4095, 4096, 40000], np.int32)
    np.testing.assert_allclose(
        tmla.apply_rope_interleaved(_t(x), _t(pos), _t(inv), att).numpy(),
        np.asarray(jmla.apply_rope_interleaved(
            jnp.asarray(x), jnp.asarray(pos), jnp.asarray(jinv), jatt)),
        atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# forward passes and pool rows
# ---------------------------------------------------------------------------

BS, NUM_BLOCKS, M = 8, 16, 6
TOKENS_A = list(np.random.default_rng(11).integers(1, 256, size=20))
TOKENS_B = TOKENS_A[:16] + [7, 9, 11, 13, 15]
TABLE_A, TABLE_B = [1, 2, 3], [1, 2, 4]     # blocks 1-2: the 16-token prefix
DECODE_IN = [7, 9, 0]                       # slot 2 is inactive
# two ragged dispatches over slots 0-2 of fresh blocks: a 10-row and a
# 6-row chunk, then a decode row, a chunk continuing a prefix and a fresh
# chunk ({slot: (rows, first position)})
RAGGED = [{0: (10, 0), 1: (6, 0)}, {0: (1, 10), 1: (7, 6), 2: (5, 0)}]
R_TABLES = [[5, 6, 7], [8, 9, 0], [10, 0, 0]]


def _padded(tokens, n):
    out = np.zeros((n,), np.int32)
    out[:len(tokens)] = tokens
    return out


def _table(blocks):
    out = np.zeros((M,), np.int32)
    out[:len(blocks)] = blocks
    return out


def _ragged_batch(spans, seqs):
    toks, pos, row_slot = [], [], []
    starts, counts, sample = [0] * 4, [0] * 4, [0] * 4
    for slot in sorted(spans):
        n, p0 = spans[slot]
        starts[slot], counts[slot] = len(toks), n
        sample[slot] = len(toks) + n - 1
        toks += seqs[slot][p0:p0 + n]
        pos += list(range(p0, p0 + n))
        row_slot += [slot] * n
    starts[3] = len(toks)
    tables = np.stack([_table(t) for t in R_TABLES] + [_table([])])
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return (i32(toks), i32(pos), tables, i32(row_slot), i32(starts),
            i32(counts), i32(sample))


def _ragged_seqs():
    r = np.random.default_rng(12)
    return [r.integers(1, 256, size=20).tolist() for _ in range(3)]


def _torch_run(np_params, geom, quant):
    cfg = ModelConfig(**geom)
    params = params_from_numpy(np_params, cfg, "cpu", torch.float32)
    kv = tmla.init_kv_cache(cfg, NUM_BLOCKS, BS, "cpu", torch.float32,
                            quantization=quant)
    with torch.inference_mode():
        la = tmla.prefill_forward(params, kv, _t(_padded(TOKENS_A, 32)),
                                  _t(_table(TABLE_A)), 0, len(TOKENS_A),
                                  cfg, BS)
        lb = tmla.prefill_forward(params, kv, _t(_padded(TOKENS_B[16:], 8)),
                                  _t(_table(TABLE_B)), 16,
                                  len(TOKENS_B) - 16, cfg, BS)
        tables = np.stack([_table(TABLE_A), _table(TABLE_B), _table([])])
        pos = np.array([len(TOKENS_A), len(TOKENS_B), 0], np.int32)
        ld = tmla.decode_forward(params, kv, _t(np.array(DECODE_IN)),
                                 _t(pos), _t(tables), cfg, BS)
        seqs = _ragged_seqs()
        lr = [tmla.ragged_forward(params, kv, *map(_t, _ragged_batch(sp,
                                                                     seqs)),
                                  cfg, BS, 16)[:3].numpy() for sp in RAGGED]
    return {"prefill_a": la.numpy(), "prefill_b": lb.numpy(),
            "decode": ld.numpy(), "ragged": lr, "kv": kv["kv"].numpy()}


# the JAX forwards as the JAX engine runs them, jitted: each compiles once
# a shape and pool dtype, and gives the bits of its eager calls here
_jprefill = jax.jit(jmla.prefill_forward, static_argnums=(6,))
_jdecode = jax.jit(jmla.decode_forward, static_argnums=(5,))
_jragged = jax.jit(jmla.ragged_forward, static_argnums=(9,),
                   static_argnames=("max_rows",))


def _jax_run(np_params, geom, quant):
    cfg = JModelConfig(**geom)
    params = {k: jnp.asarray(v) for k, v in np_params.items()}
    st = jllama.ModelStatics(cfg=cfg, block_size=BS, attn_impl="xla",
                             kv_coalesce=False)
    kv = jmla.init_kv_cache(cfg, NUM_BLOCKS, BS, dtype=jnp.float32,
                            quantization=quant)
    la, kv = _jprefill(
        params, kv, jnp.asarray(_padded(TOKENS_A, 32)),
        jnp.asarray(_table(TABLE_A)), jnp.int32(0), jnp.int32(len(TOKENS_A)),
        st)
    lb, kv = _jprefill(
        params, kv, jnp.asarray(_padded(TOKENS_B[16:], 8)),
        jnp.asarray(_table(TABLE_B)), jnp.int32(16),
        jnp.int32(len(TOKENS_B) - 16), st)
    tables = np.stack([_table(TABLE_A), _table(TABLE_B), _table([])])
    pos = np.array([len(TOKENS_A), len(TOKENS_B), 0], np.int32)
    ld, kv = _jdecode(params, kv, jnp.asarray(DECODE_IN), jnp.asarray(pos),
                      jnp.asarray(tables), st)
    seqs = _ragged_seqs()
    lr = []
    for sp in RAGGED:
        b = [jnp.asarray(a) for a in _ragged_batch(sp, seqs)]
        logits, kv = _jragged(params, kv, *b, st, max_rows=16)
        lr.append(np.asarray(logits)[:3])
    return {"prefill_a": np.asarray(la), "prefill_b": np.asarray(lb),
            "decode": np.asarray(ld), "ragged": lr,
            "kv": np.asarray(kv["kv"])}


@pytest.fixture(scope="module", params=[(g, q) for g in GEOMS
                                        for q in KV_MODES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def runs(request):
    geom, quant = GEOMS[request.param[0]], request.param[1]
    np_params = _np_params(geom, 0)
    return (_torch_run(np_params, geom, quant),
            _jax_run(np_params, geom, quant), quant)


def _logit_atol(quant):
    return LOGIT_ATOL if quant == "none" else INT8_LOGIT_ATOL


def test_mla_prefill_logits_match(runs):
    got, want, quant = runs
    np.testing.assert_allclose(got["prefill_a"], want["prefill_a"],
                               atol=_logit_atol(quant), rtol=0)


def test_mla_prefix_hit_prefill_logits_match(runs):
    got, want, quant = runs
    np.testing.assert_allclose(got["prefill_b"], want["prefill_b"],
                               atol=_logit_atol(quant), rtol=0)


def test_mla_decode_logits_match(runs):
    got, want, quant = runs
    np.testing.assert_allclose(got["decode"][:2], want["decode"][:2],
                               atol=_logit_atol(quant), rtol=0)
    assert np.isfinite(got["decode"]).all()


@pytest.mark.parametrize("dispatch", [0, 1])
def test_mla_ragged_logits_match(runs, dispatch):
    got, want, quant = runs
    np.testing.assert_allclose(got["ragged"][dispatch],
                               want["ragged"][dispatch],
                               atol=_logit_atol(quant), rtol=0)


def test_mla_pool_rows_match(runs):
    got, want, quant = runs
    if quant == "none":
        np.testing.assert_allclose(got["kv"], want["kv"], atol=KV_ATOL,
                                   rtol=0)
        return
    # int8: the same bytes, but for a value whose f32 quotient the two
    # frameworks round to either side of .5 (one level, at most 0.1 %)
    diff = np.abs(got["kv"].astype(np.int32) - want["kv"].astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


# ---------------------------------------------------------------------------
# EngineCore streams
# ---------------------------------------------------------------------------

ENGINE = dict(max_model_len=256, kv_block_size=8, num_kv_blocks=64,
              max_num_seqs=2, prefill_buckets=[16, 32, 64, 128])
DISPATCH = {
    "k1": {},
    "k4_pipelined_lanes": dict(decode_steps_per_dispatch=4,
                               decode_dispatch_pipeline=True,
                               lane_prefill_max_tokens=512),
    "chunked_prefix": dict(prefill_chunk=16),
    "ragged": dict(ragged_dispatch=True, ragged_max_seq_rows=8),
}


@pytest.fixture(scope="module")
def e_np_params():
    return _np_params(GEOM, 1)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 256, size=n).tolist()


async def _scenario(side, mode, lead=1):
    """Each mode's requests: a greedy and a seeded sampled stream (``lead``:
    b is submitted as the engine emits a's ``lead``-th token, the same
    point of a's stream in both engines)."""
    pa, pb = _prompt(41, 25), _prompt(43, 21)
    if mode == "k4_pipelined_lanes":    # b lane-admits into a's batch
        return await side.busy_pair(pa, pb, samp_b=SEEDED, lead=lead)
    if mode == "chunked_prefix":        # b hits a's 32-token prefix
        shared = _prompt(47, 32)
        a = await side.run(shared + [3, 5], "a", max_new=12)
        b = await side.run(shared + [9, 11, 13], "b", max_new=12,
                           sampling=SEEDED)
        return a, b
    return await _together(side, pa, pb)


async def _together(side, pa, pb, max_new_a=16, max_new_b=16):
    """a (greedy) and b (seeded) submitted together."""
    ra = await side.submit(pa, "a", max_new=max_new_a)
    rb = await side.submit(pb, "b", max_new=max_new_b, sampling=SEEDED)
    return await asyncio.gather(side.drain(ra), side.drain(rb))


@pytest.fixture(scope="module")
def jax_k1_streams(e_np_params):
    """The JAX engine's k1-mode streams over each KV pool, a and b
    together as long as the pipelined-lanes mode's (32 and 24 tokens), run
    once and shared by two cases: the k1 mode's reference (its first 16
    tokens a stream) and the pipelined-lanes mode's (a stream depends
    neither on the batch it rides, nor on the steps a dispatch, nor on
    its token budget, so both modes' streams must be prefixes of these)."""
    cache = {}

    async def get(kv_quant):
        if kv_quant not in cache:
            jcore = JEngineCore(
                JModelConfig(**GEOM),
                JEngineConfig(**dict(ENGINE, kv_quantization=kv_quant)),
                params={k: jnp.asarray(v) for k, v in e_np_params.items()},
                attn_impl="xla", param_dtype=jnp.float32)
            try:
                cache[kv_quant] = await _together(
                    Side(jcore, True), _prompt(41, 25), _prompt(43, 21),
                    32, 24)
            finally:
                await jcore.stop()
        return cache[kv_quant]
    return get


@pytest.mark.asyncio
@pytest.mark.parametrize("kv_quant", KV_MODES)
@pytest.mark.parametrize("mode", list(DISPATCH))
async def test_mla_engine_streams_match_jax(e_np_params, jax_k1_streams,
                                            mode, kv_quant):
    kw = dict(ENGINE, kv_quantization=kv_quant, **DISPATCH[mode])
    cfg = ModelConfig(**GEOM)
    tcore = EngineCore(cfg, EngineConfig(dtype="float32", **kw),
                       params=params_from_numpy(e_np_params, cfg, "cpu",
                                                torch.float32),
                       device="cpu")
    assert tcore.model_mod is tmla and set(tcore.kv) == {"kv"}
    if mode in ("k1", "k4_pipelined_lanes"):
        ja, jb = await jax_k1_streams(kv_quant)
        try:
            ta, tb = await _scenario(Side(tcore, False), mode)
        finally:
            await tcore.stop()
        # the shared reference's streams cut to this mode's budgets
        na, nb = (32, 24) if mode == "k4_pipelined_lanes" else (16, 16)
        ja, jb = (ja[0][:na],) + ja[1:], (jb[0][:nb],) + jb[1:]
    else:
        jcore = JEngineCore(JModelConfig(**GEOM), JEngineConfig(**kw),
                            params={k: jnp.asarray(v)
                                    for k, v in e_np_params.items()},
                            attn_impl="xla", param_dtype=jnp.float32)
        out = []
        for core, jax_side in ((jcore, True), (tcore, False)):
            try:
                out.append(await _scenario(Side(core, jax_side), mode))
            finally:
                await core.stop()
        (ja, jb), (ta, tb) = out
    assert ta[0] == ja[0] and tb[0] == jb[0]
    assert len(ta[0]) >= 12 and len(tb[0]) >= 12
    if mode == "k4_pipelined_lanes":
        assert tcore.lane_admissions >= 1
        # b lane-admitted at a's 6th token: the same streams
        late = EngineCore(cfg, EngineConfig(dtype="float32", **kw),
                          params=params_from_numpy(e_np_params, cfg, "cpu",
                                                   torch.float32),
                          device="cpu")
        try:
            la, lb = await _scenario(Side(late, False), mode, lead=6)
        finally:
            await late.stop()
        assert la[0] == ja[0] and lb[0] == jb[0] and late.lane_admissions >= 1
    if mode == "chunked_prefix":
        assert tb[2].prefix_hit_tokens == jb[2].prefix_hit_tokens >= 24
    if mode == "ragged":
        assert tcore.ragged_dispatches == jcore.ragged_dispatches > 0


@pytest.mark.asyncio
@pytest.mark.parametrize("overlap", [True, False],
                         ids=["deferred_fetch", "fetch_at_once"])
async def test_mla_back_to_back_admissions_match_jax(e_np_params, overlap):
    """The rank-128 geometry at K = 4 (pipelined, lane prefill), two
    prompts posted back to back: with the first token's fetch deferred the
    second prefills (no lane admission), as in the JAX engine; fetched at
    once it lane-admits. Lane admissions, host round trips and streams
    equal the JAX engine's."""
    kw = dict(ENGINE, overlap_admission_fetch=overlap,
              **DISPATCH["k4_pipelined_lanes"])
    jcore = JEngineCore(JModelConfig(**GEOM), JEngineConfig(**kw),
                        params={k: jnp.asarray(v)
                                for k, v in e_np_params.items()},
                        attn_impl="xla", param_dtype=jnp.float32)
    cfg = ModelConfig(**GEOM)
    tcore = EngineCore(cfg, EngineConfig(dtype="float32", **kw),
                       params=params_from_numpy(e_np_params, cfg, "cpu",
                                                torch.float32),
                       device="cpu")
    pa, pb = _prompt(41, 25), _prompt(43, 21)
    out = []
    for core, jax_side in ((jcore, True), (tcore, False)):
        side = Side(core, jax_side)
        try:
            ra = await side.submit(pa, "a", max_new=16)
            rb = await side.submit(pb, "b", max_new=16, sampling=SEEDED)
            out.append(await asyncio.gather(side.drain(ra), side.drain(rb)))
        finally:
            await core.stop()
    (ja, jb), (ta, tb) = out
    assert tcore.lane_admissions == jcore.lane_admissions == (0 if overlap
                                                              else 1)
    assert tcore.host_roundtrips == jcore.host_roundtrips
    assert ta[0] == ja[0] and tb[0] == jb[0] and len(ta[0]) == 16


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("what", ["int4_weights", "int8_weights", "sp2",
                                  "moe_llama"])
def test_unported_combinations_refuse(what):
    from dynamo_tpu_torch.parallel.sharding import make_mesh
    geom, kw, mesh = GEOM, dict(ENGINE), None
    if what == "int4_weights":
        kw["quantization"] = "int4"
    elif what == "int8_weights":
        kw["quantization"] = "int8"
    elif what == "sp2":
        mesh = make_mesh(sp=2, devices=["cpu", "cpu"])
    else:
        geom = dict(vocab_size=256, hidden_size=64, intermediate_size=64,
                    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                    model_type="mixtral", num_experts=4)
    with pytest.raises(NotImplementedError):
        EngineCore(ModelConfig(**geom), EngineConfig(dtype="float32", **kw),
                   device="cpu", mesh=mesh)


# a deepseek_v2 config.json at GEOM's widths, over the committed
# SentencePiece fixture (307 pieces)
HF_TINY = {"model_type": "deepseek_v2", "vocab_size": 307, "hidden_size": 64,
           "intermediate_size": 64, "moe_intermediate_size": 32,
           "num_hidden_layers": 3, "num_attention_heads": 4,
           "num_key_value_heads": 4, "q_lora_rank": None,
           "kv_lora_rank": 128, "qk_nope_head_dim": 32,
           "qk_rope_head_dim": 64, "v_head_dim": 32, "n_routed_experts": 4,
           "num_experts_per_tok": 2, "n_shared_experts": 1,
           "first_k_dense_replace": 1, "moe_layer_freq": 1,
           "norm_topk_prob": False, "topk_method": "greedy",
           "scoring_func": "softmax", "max_position_embeddings": 256,
           "bos_token_id": 1, "eos_token_id": 2,
           "tie_word_embeddings": False}


@pytest.mark.parametrize("extra", [
    ["--kv-block-size", "0"],
    ["--ragged", "--ragged-max-seq-rows", "8", "--kv-quantization", "int8"],
], ids=["split", "ragged_kv8"])
def test_launcher_serves_a_deepseek_v2_dir(tmp_path, extra):
    d = str(tmp_path / "tiny-deepseek-v2")
    os.makedirs(d)
    shutil.copy(SP_FIXTURE, os.path.join(d, "tokenizer.model"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(HF_TINY, f)
    _launch_and_request(d, *extra)
