"""The port's Phi-3 path against the JAX package's, on the CPU.

Phi-3 is a llama-family model with a sliding window on every layer, head
dim 96 (3072 lanes over 32 heads in Phi-3-mini) and, in its 128k variants,
longrope. Every case feeds both packages the same numpy inputs:

- ``ModelConfig.from_hf_config`` of ``chip_smoke.PHI3_MINI_4K_CONFIG``
  gives the same fields in both packages (every layer windowed, head dim
  96, untied), and so does a 128k-style longrope config at head dim 96
  with 48 seeded short and long factors.
- The rope tables (``rope_inv_freq``), the longrope attention factor and
  the rotated vectors at head dim 96 equal JAX's in the short, long and
  auto regimes (f32 inputs: atol=rtol=1e-6, the two frameworks' cos and
  sin); ``EngineCore`` downgrades auto to short at a ``max_model_len``
  within the pretrained window and keeps auto beyond it, as JAX does.
- The forward passes of a tiny Phi-3 (2 layers, 4 heads over 4 KV heads of
  96, so that KVH*Dh = 384 is a multiple of 128 and JAX's Pallas kernels
  run in interpret mode; window 8 on every layer, bound by a 20-token
  prompt): a prefill, a prefill after a prefix hit (start_pos 16), a
  batched decode step, the pool rows they wrote, and two ragged
  dispatches (the second mixes a decode row, a fresh prompt and a chunk
  continuing a prefix), against JAX's Pallas kernels in interpret mode and
  its XLA paths: logits atol=1e-4, pool rows atol=1e-5 (f32; the two
  frameworks sum in another order, the tolerances of
  ``tests/test_torch_gemma.py``).
- The plain versions of K1, K2, K3 and K4 at head dim 96 (g = 1), K1, K3
  and K4 with and without a window, against JAX's Pallas kernels in
  interpret mode: f32 atol=rtol=2e-5, int8 pools 2e-4 (the bars of
  ``tests/test_torch_gemma.py``).
- ``EngineCore`` token streams of both packages on a tiny Phi-3 at head
  dim 96 whose 16-token window binds within each stream: split dispatch at
  K = 1 and K = 4 and ragged dispatch, greedy and seeded sampled
  (temperature 0.7, top_p 0.9): equal streams.
- The launcher serves a model directory holding a tiny ``phi3`` config
  with ``--random-weights`` on the CPU (split, and ragged).
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import PHI3_MINI_4K_CONFIG
from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.config import RopeScaling as JRopeScaling
from dynamo_tpu.engine.core import EngineCore as JEngineCore
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu_torch.engine import attention as tattn
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.config import RopeScaling
from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.weights import params_from_numpy
from tests.test_torch_engine import SAMPLED, make_cores, run_both
from tests.test_torch_serving import SP_FIXTURE, _launch_and_request

F32_TOL, INT8_TOL = 2e-5, 2e-4
LOGIT_ATOL, KV_ATOL = 1e-4, 1e-5
ROPE_TOL = 1e-6

# head dim 96, as Phi-3-mini; the 128k variant's pretrained window
D2 = 96 // 2


def _hf_longrope(max_pos=131072, original=4096):
    """Phi-3-mini's config.json as a 128k variant carries it: longrope with
    48 seeded short and 48 long factors (the published lists are not in the
    repository)."""
    rng = np.random.default_rng(90)
    return {**PHI3_MINI_4K_CONFIG, "max_position_embeddings": max_pos,
            "original_max_position_embeddings": original,
            "rope_scaling": {
                "type": "longrope",
                "short_factor": rng.uniform(1.0, 1.3, size=D2).tolist(),
                "long_factor": rng.uniform(1.5, 4.0, size=D2).tolist()}}


def _same_fields(got, want):
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name


# ---------------------------------------------------------------------------
# config, rope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw", [PHI3_MINI_4K_CONFIG, _hf_longrope()],
                         ids=["mini_4k", "longrope_128k"])
def test_phi3_config_matches_jax(raw):
    got = ModelConfig.from_hf_config(raw)
    want = JModelConfig.from_hf_config(raw)
    # every field of the port's copy (the JAX one adds TPU-only knobs)
    _same_fields(got, want)
    assert (got.num_heads, got.num_kv_heads, got.head_dim) == (32, 32, 96)
    assert got.sliding_window == 2047 and not got.tie_word_embeddings
    assert got.layer_types == ["sliding_attention"] * 32
    assert tllama.sliding_layer_mask(got).all()
    np.testing.assert_array_equal(tllama.sliding_layer_mask(got),
                                  jllama.sliding_layer_mask(want))
    if raw is PHI3_MINI_4K_CONFIG:
        assert got.rope_scaling is None
        assert (got.hidden_size, got.intermediate_size,
                got.vocab_size) == (3072, 8192, 32064)
    else:
        rs = got.rope_scaling
        assert rs.rope_type == "longrope" and rs.longrope_active == "auto"
        assert len(rs.short_factor) == len(rs.long_factor) == D2


def _regime_cfgs():
    """(name, port config, JAX config) of each longrope regime at head dim
    96: the 128k deployment in auto (long, since M > O) and forced short
    and long, and a deployment within its pretrained window in auto
    (short)."""
    out = []
    for name, raw, active in (
            ("auto_long", _hf_longrope(), "auto"),
            ("short", _hf_longrope(), "short"),
            ("long", _hf_longrope(), "long"),
            ("auto_within_window", _hf_longrope(4096, 4096), "auto")):
        t, j = ModelConfig.from_hf_config(raw), JModelConfig.from_hf_config(raw)
        t = dataclasses.replace(t, rope_scaling=dataclasses.replace(
            t.rope_scaling, longrope_active=active))
        j = dataclasses.replace(j, rope_scaling=dataclasses.replace(
            j.rope_scaling, longrope_active=active))
        out.append((name, t, j))
    return out


@pytest.mark.parametrize("regime", [r[0] for r in _regime_cfgs()])
def test_longrope_tables_and_scaling_match_jax(regime):
    _, t, j = next(r for r in _regime_cfgs() if r[0] == regime)
    inv = tllama.rope_inv_freq(t)
    np.testing.assert_allclose(inv, jllama.rope_inv_freq(j), rtol=0, atol=0)
    scaling = tllama.rope_attention_scaling(t)
    assert scaling == jllama.rope_attention_scaling(j)
    rs = t.rope_scaling
    factors = np.asarray(rs.short_factor if regime in (
        "short", "auto_within_window") else rs.long_factor)
    base = 1.0 / (t.rope_theta ** (np.arange(0, 96, 2) / 96))
    np.testing.assert_allclose(inv, (base / factors).astype(np.float32),
                               rtol=1e-6)
    # 1 + ln(32) / ln(4096) under the root at 128k; 1 within the window
    assert scaling > 1.0 if regime != "auto_within_window" else scaling == 1.0
    # the rotated vectors the model caches, at positions on both sides of
    # the pretrained window
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 2, 96)).astype(np.float32)
    pos = np.array([0, 1, 2047, 4095, 4096, 70000], np.int32)
    got = tllama.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            torch.from_numpy(inv), scaling).numpy()
    want = jllama.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                             jnp.asarray(jllama.rope_inv_freq(j)), scaling)
    np.testing.assert_allclose(got, np.asarray(want), rtol=ROPE_TOL,
                               atol=ROPE_TOL)


def _tiny_longrope(active="auto"):
    """``tests/test_phi3.py``'s tiny longrope Phi-3 (a 64-token pretrained
    window served at 256) at head dim 96: 48 seeded factors of each set."""
    rng = np.random.default_rng(90)
    short = tuple(float(f) for f in rng.uniform(1.0, 1.3, size=D2))
    long = tuple(float(f) for f in rng.uniform(1.5, 4.0, size=D2))
    geom = dict(model_type="phi3", vocab_size=256, hidden_size=64,
                intermediate_size=128, num_layers=2, num_heads=4,
                num_kv_heads=4, head_dim=96, max_position_embeddings=256)
    rs = dict(rope_type="longrope", short_factor=short, long_factor=long,
              original_max_position_embeddings=64, longrope_active=active)
    return (ModelConfig(**geom, rope_scaling=RopeScaling(**rs)),
            JModelConfig(**geom, rope_scaling=JRopeScaling(**rs)))


@pytest.mark.asyncio
@pytest.mark.parametrize("max_len,active", [(64, "short"), (128, "auto")])
async def test_engine_resolves_longrope_regime_as_jax(max_len, active):
    """EngineCore fixes the static factor selection: a max_model_len
    within the pretrained window downgrades auto to short; beyond it auto
    stays (long at this max_position_embeddings)."""
    tcfg, jcfg = _tiny_longrope()
    kw = dict(max_model_len=max_len, kv_block_size=8, num_kv_blocks=48,
              max_num_seqs=2, prefill_buckets=[32, 64, 128])
    jcore = JEngineCore(jcfg, JEngineConfig(**kw), attn_impl="xla",
                        param_dtype=jnp.float32)
    tcore = EngineCore(tcfg, EngineConfig(dtype="float32", **kw),
                       device="cpu")
    try:
        for core in (jcore, tcore):
            assert core.model_cfg.rope_scaling.longrope_active == active
        assert (tllama.rope_inv_freq(tcore.model_cfg)
                == jllama.rope_inv_freq(jcore.model_cfg)).all()
    finally:
        await jcore.stop()
        await tcore.stop()


# ---------------------------------------------------------------------------
# forward passes: prefill, prefix-hit prefill, decode, pool rows
# ---------------------------------------------------------------------------

# KVH*Dh = 384: the geometry the Pallas kernels interpret
GEOM = dict(model_type="phi3", vocab_size=128, hidden_size=64,
            intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=4,
            head_dim=96, max_position_embeddings=256, sliding_window=8,
            layer_types=["sliding_attention"] * 2)
BS, NUM_BLOCKS, M = 8, 16, 8
rng = np.random.default_rng(5)
TOKENS_A = rng.integers(1, 128, size=20).tolist()
TOKENS_B = TOKENS_A[:16] + rng.integers(1, 128, size=6).tolist()
TABLE_A = [1, 2, 3]
TABLE_B = [1, 2, 4]          # blocks 1-2 hold the shared 16-token prefix
DECODE_IN = [7, 9, 0]        # slot 2 is inactive


def _np_params(geom, seed):
    p = jllama.init_params(JModelConfig(**geom), jax.random.PRNGKey(seed),
                           dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def np_params():
    return _np_params(GEOM, 0)


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


def _torch_forward(np_params, geom):
    cfg = ModelConfig(**geom)
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


@pytest.fixture(scope="module")
def torch_run(np_params):
    return _torch_forward(np_params, GEOM)


@pytest.fixture(scope="module", params=["pallas_interpret", "xla"])
def jax_run(request, np_params):
    cfg = JModelConfig(**GEOM)
    params = {k: jnp.asarray(v) for k, v in np_params.items()}
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


def test_phi3_prefill_logits_match(torch_run, jax_run):
    np.testing.assert_allclose(torch_run["prefill_a"], jax_run["prefill_a"],
                               atol=LOGIT_ATOL, rtol=0)


def test_phi3_prefix_hit_prefill_logits_match(torch_run, jax_run):
    np.testing.assert_allclose(torch_run["prefill_b"], jax_run["prefill_b"],
                               atol=LOGIT_ATOL, rtol=0)


def test_phi3_decode_logits_match(torch_run, jax_run):
    # slot 2 is inactive (the trash row): only the live slots are compared
    np.testing.assert_allclose(torch_run["decode"][:2],
                               jax_run["decode"][:2], atol=LOGIT_ATOL, rtol=0)
    assert np.isfinite(torch_run["decode"]).all()


def test_phi3_kv_pool_rows_match(torch_run, jax_run):
    for name in ("k", "v"):
        np.testing.assert_allclose(torch_run[name][:, BS:],
                                   jax_run[name][:, BS:], atol=KV_ATOL,
                                   rtol=0)


def test_phi3_window_moves_the_logits(np_params, torch_run):
    """The comparisons above see the window: every layer global moves the
    prompt's and the decode step's logits by far more than their
    tolerance."""
    other = _torch_forward(np_params, dict(GEOM, sliding_window=None))
    for name in ("prefill_a", "decode"):
        d = np.abs(other[name][:2] - torch_run[name][:2]).max()
        assert d > 100 * LOGIT_ATOL, (name, d)


# ---------------------------------------------------------------------------
# ragged_forward: two dispatches, the second mixed
# ---------------------------------------------------------------------------

RBS, R_BLOCKS = 32, 10
R_TABLES = np.array([[1, 2, 0], [3, 0, 0], [4, 5, 0], [0, 0, 0]], np.int32)
_rrng = np.random.default_rng(11)
PROMPT_A = _rrng.integers(1, 128, size=40).tolist()
PROMPT_B = _rrng.integers(1, 128, size=9).tolist()
PROMPT_C = _rrng.integers(1, 128, size=50).tolist()
DISPATCHES = [{0: (PROMPT_A, 0), 2: (PROMPT_C[:24], 0)},
              {0: ([7], 40), 1: (PROMPT_B, 0), 2: (PROMPT_C[24:], 24)}]
R_MAX_ROWS = 64


def _ragged_args(chunks, n_slots=3):
    TT = sum(len(t) for t, _ in chunks.values())
    tokens = np.zeros((TT,), np.int32)
    positions = np.zeros((TT,), np.int32)
    row_slot = np.full((TT,), n_slots, np.int32)
    starts = np.zeros((n_slots + 1,), np.int32)
    counts = np.zeros((n_slots + 1,), np.int32)
    sample_rows = np.zeros((n_slots + 1,), np.int32)
    cursor = 0
    for slot in sorted(chunks):
        toks, pos0 = chunks[slot]
        n = len(toks)
        tokens[cursor:cursor + n] = toks
        positions[cursor:cursor + n] = pos0 + np.arange(n)
        row_slot[cursor:cursor + n] = slot
        starts[slot] = cursor
        counts[slot] = n
        sample_rows[slot] = cursor + n - 1
        cursor += n
    starts[n_slots] = cursor
    return tokens, positions, row_slot, starts, counts, sample_rows


@pytest.fixture(scope="module")
def ragged_torch(np_params):
    cfg = ModelConfig(**GEOM)
    params = params_from_numpy(np_params, cfg, "cpu", torch.float32)
    kv = tllama.init_kv_cache(cfg, R_BLOCKS, RBS, "cpu", torch.float32)
    logits = []
    with torch.inference_mode():
        for chunks in DISPATCHES:
            tok, pos, rs, st, cn, sr = (torch.from_numpy(a)
                                        for a in _ragged_args(chunks))
            logits.append(tllama.ragged_forward(
                params, kv, tok.long(), pos, torch.from_numpy(R_TABLES), rs,
                st, cn, sr, cfg, RBS, R_MAX_ROWS).numpy())
    return logits, kv["k"].numpy(), kv["v"].numpy()


@pytest.fixture(scope="module", params=["xla", "pallas_interpret"])
def ragged_jax(request, np_params):
    cfg = JModelConfig(**GEOM)
    statics = jllama.ModelStatics(cfg=cfg, block_size=RBS,
                                  attn_impl=request.param, kv_coalesce=False)
    params = {k: jnp.asarray(v) for k, v in np_params.items()}
    kv = jllama.init_kv_cache(cfg, R_BLOCKS, RBS, dtype=jnp.float32)
    logits = []
    for chunks in DISPATCHES:
        tok, pos, rs, st, cn, sr = (jnp.asarray(a)
                                    for a in _ragged_args(chunks))
        lg, kv = jllama.ragged_forward(params, kv, tok, pos,
                                       jnp.asarray(R_TABLES), rs, st, cn, sr,
                                       statics, max_rows=R_MAX_ROWS)
        logits.append(np.asarray(lg))
    return logits, np.asarray(kv["k"]), np.asarray(kv["v"])


def test_phi3_ragged_logits_match(ragged_torch, ragged_jax):
    for d, (g, w) in enumerate(zip(ragged_torch[0], ragged_jax[0])):
        live = sorted(DISPATCHES[d])            # the trash row is discarded
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g[live], w[live], atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"dispatch {d}")


def test_phi3_ragged_kv_rows_match(ragged_torch, ragged_jax):
    rows = np.concatenate([
        (R_TABLES[s][:, None] * RBS + np.arange(RBS)).reshape(-1)[:n]
        for s, n in ((0, 41), (1, 9), (2, 50))])
    for got, want in zip(ragged_torch[1:], ragged_jax[1:]):
        np.testing.assert_allclose(got[:, rows], want[:, rows],
                                   atol=KV_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the four attention kernels' plain versions at head dim 96
# ---------------------------------------------------------------------------

H96, KVH96, DH = 4, 4, 96           # g = 1, as Phi-3-mini
SCALE = DH ** -0.5


@pytest.mark.parametrize("sliding", [True, False], ids=["sliding", "global"])
def test_flash_prefill_plain_dh96_matches_jax_kernel(sliding):
    """K1: a 48-token chunk at positions 80..127 over 128 keys (the last 8
    padding) with a 40-token window: in JAX's 16 x 32 tiling the first
    chunks of the later query tiles lie below every row's window."""
    r = np.random.default_rng(7)
    T, S, start, true_len, window = 48, 128, 80, 40, 40
    q = r.normal(size=(T, H96, DH)).astype(np.float32)
    k = r.normal(size=(S, KVH96, DH)).astype(np.float32)
    v = r.normal(size=(S, KVH96, DH)).astype(np.float32)
    kw = dict(scale=SCALE, start_pos=start, seq_len=start + true_len,
              sliding=sliding, window=window)
    got = tattn.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw).numpy()
    want = jattn.flash_prefill(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), q_chunk=16, kv_chunk=32,
                               interpret=True, **kw)
    np.testing.assert_allclose(got[:true_len], np.asarray(want)[:true_len],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("start,seq_len", [(0, 96), (-40, 96), (96, 60)],
                         ids=["diagonal", "straddle", "past"])
def test_flash_prefill_partial_plain_dh96_matches_jax_kernel(start, seq_len):
    """K2, one ring hop at head dim 96: the diagonal hop, a chunk that some
    rows see and others do not (start_pos < 0), and a hop wholly in the
    past with a padded tail."""
    r = np.random.default_rng(12)
    T = S = 96
    q = r.normal(size=(T, H96, DH)).astype(np.float32)
    k = r.normal(size=(S, KVH96, DH)).astype(np.float32)
    v = r.normal(size=(S, KVH96, DH)).astype(np.float32)
    got = tattn.flash_prefill_partial_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=SCALE, start_pos=start, seq_len=seq_len)
    want = jattn.flash_prefill_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=SCALE,
        start_pos=jnp.int32(start), seq_len=jnp.int32(seq_len), q_chunk=32,
        kv_chunk=32, interpret=True)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=F32_TOL,
                                   atol=F32_TOL)


def _pool(r, n_rows, int8):
    x = r.normal(size=(n_rows, KVH96 * DH)).astype(np.float32)
    return np.array(jattn.quantize_kv_rows(jnp.asarray(x))) if int8 else x


PBS, P_BLOCKS, PM = 32, 40, 5
# K3's sequences: lengths on both sides of the 40-token window and of the
# 32-token chunks, a zero-length slot
P_LENS = [1, 40, 41, 70, 97, 160, 0]
P_WINDOW = 40


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_paged_plain_dh96_matches_jax_kernel(int8, monkeypatch):
    # one sequence per program: the same function, cheaper to interpret
    monkeypatch.setenv("DYN_ATTN_SEQS_PER_PROG", "1")
    r = np.random.default_rng(8)
    k, v = _pool(r, P_BLOCKS * PBS, int8), _pool(r, P_BLOCKS * PBS, int8)
    B = len(P_LENS)
    tables = r.permutation(np.arange(1, P_BLOCKS))[:B * PM].reshape(
        B, PM).astype(np.int32)
    lens = np.asarray(P_LENS, np.int32)
    q = r.normal(size=(B, H96, DH)).astype(np.float32)
    win_lo = (lens - 1 - P_WINDOW).astype(np.int32)
    tol = INT8_TOL if int8 else F32_TOL
    live = lens > 0
    t = torch.from_numpy
    for win in (win_lo, None):
        kw = dict(block_size=PBS, scale=SCALE)
        got = tattn.paged_attention(t(q), t(k), t(v), t(tables), t(lens),
                                    win_lo=None if win is None else t(win),
                                    **kw).numpy()
        want = jattn.paged_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(tables), jnp.asarray(lens),
            win_lo=jnp.asarray(win if win is not None
                               else np.full((B,), -1, np.int32)),
            chunk_blocks=1, interpret=True, **kw)
        np.testing.assert_allclose(got[live], np.asarray(want)[live],
                                   rtol=tol, atol=tol)
        assert not got[~live].any()


# K4's mix at head dim 96: a 30-row chunk continuing a prefix to 130 keys
# (its rows' floors straddle the window's first chunks), a fresh 24-row
# prompt, decode rows at 41 and 160 keys, a zero-count slot
R_SPANS = [(30, 130), (24, 24), (1, 41), (1, 160), (0, 0)]
R_WINDOW = 40


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_ragged_plain_dh96_matches_jax_kernel(int8):
    r = np.random.default_rng(9)
    k, v = _pool(r, P_BLOCKS * PBS, int8), _pool(r, P_BLOCKS * PBS, int8)
    S = len(R_SPANS)
    tables = r.permutation(np.arange(1, P_BLOCKS))[:S * PM].reshape(
        S, PM).astype(np.int32)
    counts = np.asarray([n for n, _ in R_SPANS], np.int32)
    ctx = np.asarray([c for _, c in R_SPANS], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    total = int(counts.sum())
    q = r.normal(size=(total + 2, H96, DH)).astype(np.float32)
    win_base = np.where(counts > 0, ctx - counts - R_WINDOW,
                        tattn.RAGGED_WIN_SENTINEL).astype(np.int32)
    rows = np.concatenate([np.arange(s, s + n) for s, n in zip(starts,
                                                               counts)])
    tol = INT8_TOL if int8 else F32_TOL
    t = torch.from_numpy
    for wb in (win_base, None):
        kw = dict(block_size=PBS, scale=SCALE, max_rows=32)
        got = tattn.ragged_paged_attention(
            t(q), t(k), t(v), t(tables), t(starts), t(counts), t(ctx),
            win_base=None if wb is None else t(wb), **kw).numpy()
        want = jattn.ragged_paged_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(tables), jnp.asarray(starts), jnp.asarray(counts),
            jnp.asarray(ctx), win_base=None if wb is None else jnp.asarray(wb),
            chunk_blocks=1, interpret=True, **kw)
        np.testing.assert_allclose(got[rows], np.asarray(want)[rows],
                                   rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# EngineCore streams: split dispatch at K = 1 and 4, ragged dispatch
# ---------------------------------------------------------------------------

# head dim 96 over 4 heads, a 16-token window that binds within every
# stream below
EGEOM = dict(GEOM, vocab_size=256, max_position_embeddings=512,
             sliding_window=16)
DISPATCH = {"k1": {}, "k4": dict(decode_steps_per_dispatch=4),
            "ragged": dict(ragged_dispatch=True, ragged_max_seq_rows=8)}


@pytest.fixture(scope="module")
def e_np_params():
    return _np_params(EGEOM, 1)


def _prompts(seed):
    r = np.random.default_rng(seed)
    return [r.integers(1, 256, size=n).tolist() for n in (30, 12, 21)]


@pytest.mark.asyncio
@pytest.mark.parametrize("mode", list(DISPATCH))
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "seeded"])
async def test_phi3_engine_streams_match_jax(e_np_params, mode, sampled):
    jcore, tcore = make_cores(e_np_params, 64, 4, EGEOM, **DISPATCH[mode])
    assert tcore.model_cfg.sliding_window == 16     # 256 > 16: it binds
    jout, tout = await run_both(jcore, tcore, _prompts(3), 24,
                                SAMPLED if sampled else None)
    for (jt, jr, _), (tt, tr, _) in zip(jout, tout):
        assert len(tt) == 24 and tr.value == jr.value == "length"
        assert tt == jt
    if mode == "ragged":
        assert tcore.ragged_dispatches == jcore.ragged_dispatches > 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

HF_TINY = {"model_type": "phi3", "vocab_size": 307, "hidden_size": 64,
           "intermediate_size": 128, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 4,
           "head_dim": 96, "max_position_embeddings": 256,
           "original_max_position_embeddings": 256, "sliding_window": 16,
           "rope_scaling": None, "tie_word_embeddings": False,
           "bos_token_id": 1, "eos_token_id": 2}


@pytest.mark.parametrize("extra", [(), ("--ragged", "--ragged-max-seq-rows",
                                        "8")], ids=["split", "ragged"])
def test_launcher_serves_a_phi3_dir(tmp_path, extra):
    d = str(tmp_path / "tiny-phi3")
    os.makedirs(d)
    shutil.copy(SP_FIXTURE, os.path.join(d, "tokenizer.model"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(HF_TINY, f)
    cfg = ModelConfig.from_model_dir(d)
    assert cfg.model_type == "phi3" and cfg.head_dim == 96
    assert cfg.layer_types == ["sliding_attention"] * 2
    _launch_and_request(d, *extra)
