"""The port's Gemma-2 path against the JAX package's, on the CPU.

Gemma-2 differs from llama in scaled embeddings, a gelu-tanh MLP, (1 + w)
RMSNorm with post-block norms, logit soft-capping (attention and final),
``query_pre_attn_scalar`` and sliding windows on the even layers. Every
case feeds both packages the same numpy inputs:

- ``ModelConfig.from_hf_config`` of the Gemma-2-9B ``config.json`` fields
  that ``chip_smoke.py`` serves gives the same fields in both packages,
  ``params_from_numpy`` carries the post-norms and the tied embedding, and
  the tied embedding quantizes to JAX's int8 head bytes, row-major.
- The forward passes of a tiny Gemma-2 (window 8, bound by a 20-token
  prompt): a prefill, a prefill after a prefix hit (start_pos 16), a
  batched decode step, the pool rows they wrote, and two ragged
  dispatches (the second mixes a decode row, a fresh prompt and a chunk
  continuing a prefix), at the published soft-caps (50 / 30) and at tight
  ones (2 / 5, where tanh bends the scores), against JAX's Pallas kernels
  in interpret mode and its XLA paths. Tolerances are those of
  ``tests/test_torch_llama.py`` and ``tests/test_torch_ragged.py``: logits
  atol=1e-4, pool rows atol=1e-5 (f32; the two frameworks sum in another
  order).
- The plain versions of the three attention kernels at head dim 256 with
  soft-cap and sliding window, bf16-width values in f32 (K1, K3 and K4
  bf16) and int8 pools (K3, K4), against JAX's Pallas kernels in
  interpret mode, with small chunks so that dead chunks below the window
  are skipped there: f32 atol=rtol=2e-5, int8 2e-4 (the bars of
  ``tests/test_torch_ragged.py``).
- ``EngineCore`` token streams of both packages on a tiny Gemma-2 whose
  16-token window binds within each stream: split dispatch at K = 1 and
  K = 4 and ragged dispatch, greedy and seeded sampled (temperature 0.7,
  top_p 0.9): equal streams.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GEMMA2_9B_CONFIG
from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu_torch.engine import attention as tattn
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.weights import params_from_numpy
from tests.test_torch_engine import SAMPLED, make_cores, run_both

F32_TOL = 2e-5
INT8_TOL = 2e-4
LOGIT_ATOL, KV_ATOL = 1e-4, 1e-5

GEMMA = dict(model_type="gemma2", rms_norm_eps=1e-6, rope_theta=10000.0,
             tie_word_embeddings=True, hidden_act="gelu_pytorch_tanh",
             embed_scale=True, norm_plus_one=True, post_norms=True)
# soft-caps (attention, final): the published pair, and a tight pair at
# which tanh bends the scores and the logits
CAPS = {"published": (50.0, 30.0), "tight": (2.0, 5.0)}


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------


def test_gemma2_9b_config_matches_jax():
    got = ModelConfig.from_hf_config(GEMMA2_9B_CONFIG)
    want = JModelConfig.from_hf_config(GEMMA2_9B_CONFIG)
    # every field of the port's copy (the JAX one adds TPU-only knobs)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.num_heads, got.num_kv_heads, got.head_dim) == (16, 8, 256)
    assert (got.attn_logit_softcap, got.final_logit_softcap) == (50.0, 30.0)
    assert got.sliding_window == 4096 and got.query_pre_attn_scalar == 256
    assert got.tie_word_embeddings and got.post_norms and got.embed_scale
    np.testing.assert_array_equal(tllama.sliding_layer_mask(got),
                                  jllama.sliding_layer_mask(want))
    assert tllama.sliding_layer_mask(got).tolist() == [
        i % 2 == 0 for i in range(42)]


# KVH*Dh = 128: the geometry the Pallas kernels interpret
GEOM = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
            max_position_embeddings=256, query_pre_attn_scalar=64.0,
            sliding_window=8, **GEMMA)


def _geom(caps):
    attn, final = CAPS[caps]
    return dict(GEOM, attn_logit_softcap=attn, final_logit_softcap=final)


def _gemma_np_params(geom, seed):
    """The JAX init with zero-centred norm weights made non-trivial (as
    tests/test_gemma.py does) and q/k projections doubled, so that scores
    reach the tight soft-cap."""
    p = jllama.init_params(JModelConfig(**geom), jax.random.PRNGKey(seed),
                           dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in p.items():
        v = np.asarray(v)
        if "ln" in name or "norm" in name:
            v = 0.1 * rng.normal(size=v.shape).astype(np.float32)
        elif name in ("layers.wq", "layers.wk"):
            v = 2.0 * v
        out[name] = v
    return out


@pytest.fixture(scope="module")
def np_params():
    return _gemma_np_params(_geom("published"), 0)


def test_params_from_numpy_carries_post_norms_and_tied_embedding(np_params):
    cfg = ModelConfig(**_geom("published"))
    params = params_from_numpy(np_params, cfg, "cpu", torch.float32)
    assert "lm_head" not in params and "lm_head" not in np_params
    for name in ("embed", "layers.ln1_post", "layers.ln2_post",
                 "final_norm"):
        np.testing.assert_array_equal(params[name].numpy(), np_params[name])
    assert set(params) == set(np_params)
    # the tied head: logits are x @ embed^T, soft-capped
    x = torch.randn((3, cfg.hidden_size), generator=torch.Generator()
                    .manual_seed(0))
    want = 30.0 * torch.tanh((x @ params["embed"].t()) / 30.0)
    torch.testing.assert_close(tllama._logits(params, x, cfg), want)


def test_tied_int8_head_matches_jax_and_is_row_major(np_params):
    """A tied embedding quantized to int8 gives a pre-transposed head [D, V]
    with JAX's bytes and scales, laid out row-major as the head kernel
    reads it (a transposed view once reached the kernel's check)."""
    from dynamo_tpu.engine import quant as jquant
    from dynamo_tpu_torch.engine import quant as tquant
    cfg = ModelConfig(**_geom("published"))
    got = tquant.quantize_params(
        params_from_numpy(np_params, cfg, "cpu", torch.float32))["lm_head"]
    want = jquant.quantize_params(
        {k: jnp.asarray(v) for k, v in np_params.items()})["lm_head"]
    assert got.q.is_contiguous() and got.q.shape == (64, 128)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


# ---------------------------------------------------------------------------
# forward passes: prefill, prefix-hit prefill, decode, pool rows
# ---------------------------------------------------------------------------

BS, NUM_BLOCKS, M = 8, 16, 8
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


@pytest.fixture(scope="module", params=list(CAPS))
def caps(request):
    return request.param


@pytest.fixture(scope="module")
def torch_run(np_params, caps):
    return _torch_forward(np_params, _geom(caps))


@pytest.fixture(scope="module", params=["pallas_interpret", "xla"])
def jax_run(request, np_params, caps):
    cfg = JModelConfig(**_geom(caps))
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


def test_gemma_prefill_logits_match(torch_run, jax_run):
    np.testing.assert_allclose(torch_run["prefill_a"], jax_run["prefill_a"],
                               atol=LOGIT_ATOL, rtol=0)


def test_gemma_prefix_hit_prefill_logits_match(torch_run, jax_run):
    np.testing.assert_allclose(torch_run["prefill_b"], jax_run["prefill_b"],
                               atol=LOGIT_ATOL, rtol=0)


def test_gemma_decode_logits_match(torch_run, jax_run):
    # slot 2 is inactive (the trash row): only the live slots are compared
    np.testing.assert_allclose(torch_run["decode"][:2],
                               jax_run["decode"][:2], atol=LOGIT_ATOL, rtol=0)
    assert np.isfinite(torch_run["decode"]).all()


def test_gemma_kv_pool_rows_match(torch_run, jax_run):
    for name in ("k", "v"):
        np.testing.assert_allclose(torch_run[name][:, BS:],
                                   jax_run[name][:, BS:], atol=KV_ATOL,
                                   rtol=0)


def test_gemma_window_and_softcap_move_the_logits(np_params, torch_run,
                                                  caps):
    """The comparisons above can see both modes: with the window dropped,
    and with the attention soft-cap dropped, the prompt's and the decode
    step's logits move by far more than their tolerance."""
    for geom in (dict(_geom(caps), sliding_window=None),
                 dict(_geom(caps), attn_logit_softcap=None)):
        if geom["attn_logit_softcap"] is None and caps == "published":
            continue           # a cap of 50 barely bends these scores
        other = _torch_forward(np_params, geom)
        for name in ("prefill_a", "decode"):
            d = np.abs(other[name][:2] - torch_run[name][:2]).max()
            assert d > 100 * LOGIT_ATOL, (geom, name, d)


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
def ragged_torch(np_params, caps):
    cfg = ModelConfig(**_geom(caps))
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
def ragged_jax(request, np_params, caps):
    cfg = JModelConfig(**_geom(caps))
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


def test_gemma_ragged_logits_match(ragged_torch, ragged_jax):
    for d, (g, w) in enumerate(zip(ragged_torch[0], ragged_jax[0])):
        live = sorted(DISPATCHES[d])            # the trash row is discarded
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g[live], w[live], atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"dispatch {d}")


def test_gemma_ragged_kv_rows_match(ragged_torch, ragged_jax):
    rows = np.concatenate([
        (R_TABLES[s][:, None] * RBS + np.arange(RBS)).reshape(-1)[:n]
        for s, n in ((0, 41), (1, 9), (2, 50))])
    for got, want in zip(ragged_torch[1:], ragged_jax[1:]):
        np.testing.assert_allclose(got[:, rows], want[:, rows],
                                   atol=KV_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the three attention kernels' plain versions at head dim 256
# ---------------------------------------------------------------------------

H256, KVH256, DH = 4, 2, 256
# soft-caps of the attention cases: the published one and a tight one
ATTN_CAPS = [50.0, 2.0]


@pytest.mark.parametrize("softcap", ATTN_CAPS)
@pytest.mark.parametrize("sliding", [True, False], ids=["sliding", "global"])
def test_flash_prefill_plain_dh256_matches_jax_kernel(sliding, softcap):
    """A 48-token chunk at positions 80..127 over 128 keys (the last 8
    padding) with a 40-token window: in JAX's 16 x 32 tiling the first
    chunks of the later query tiles lie below every row's window."""
    r = np.random.default_rng(7)
    T, S, start, true_len, window = 48, 128, 80, 40, 40
    q = r.normal(size=(T, H256, DH)).astype(np.float32)
    k = r.normal(size=(S, KVH256, DH)).astype(np.float32)
    v = r.normal(size=(S, KVH256, DH)).astype(np.float32)
    kw = dict(scale=0.0625, start_pos=start, seq_len=start + true_len,
              sliding=sliding, window=window, softcap=softcap)
    got = tattn.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw).numpy()
    want = jattn.flash_prefill(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), q_chunk=16, kv_chunk=32,
                               interpret=True, **kw)
    np.testing.assert_allclose(got[:true_len], np.asarray(want)[:true_len],
                               rtol=F32_TOL, atol=F32_TOL)


def _pool(r, n_rows, int8):
    x = r.normal(size=(n_rows, KVH256 * DH)).astype(np.float32)
    return np.array(jattn.quantize_kv_rows(jnp.asarray(x))) if int8 else x


PBS, P_BLOCKS, PM = 32, 40, 5
# K3's sequences: lengths on both sides of the 40-token window and of the
# 32-token chunks, a zero-length slot
P_LENS = [1, 40, 41, 70, 97, 160, 0]
P_WINDOW = 40


@pytest.mark.parametrize("softcap", ATTN_CAPS)
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_paged_plain_dh256_matches_jax_kernel(int8, softcap, monkeypatch):
    # one sequence per program: the same function, cheaper to interpret
    monkeypatch.setenv("DYN_ATTN_SEQS_PER_PROG", "1")
    r = np.random.default_rng(8)
    k, v = _pool(r, P_BLOCKS * PBS, int8), _pool(r, P_BLOCKS * PBS, int8)
    B = len(P_LENS)
    tables = r.permutation(np.arange(1, P_BLOCKS))[:B * PM].reshape(
        B, PM).astype(np.int32)
    lens = np.asarray(P_LENS, np.int32)
    q = r.normal(size=(B, H256, DH)).astype(np.float32)
    win_lo = (lens - 1 - P_WINDOW).astype(np.int32)
    tol = INT8_TOL if int8 else F32_TOL
    live = lens > 0
    t = torch.from_numpy
    for win in (win_lo, None):
        kw = dict(block_size=PBS, scale=0.0625, softcap=softcap)
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
    # a global layer's -1 floor masks nothing
    np.testing.assert_array_equal(
        got, tattn.paged_attention(
            t(q), t(k), t(v), t(tables), t(lens), block_size=PBS,
            scale=0.0625, softcap=softcap,
            win_lo=t(np.full((B,), -1, np.int32))).numpy())


# K4's mix at head dim 256: a 30-row chunk continuing a prefix to 130 keys
# (its rows' floors straddle the window's first chunks), a fresh 24-row
# prompt, decode rows at 41 and 160 keys, a zero-count slot
R_SPANS = [(30, 130), (24, 24), (1, 41), (1, 160), (0, 0)]
R_WINDOW = 40


@pytest.mark.parametrize("softcap", ATTN_CAPS)
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_ragged_plain_dh256_matches_jax_kernel(int8, softcap):
    r = np.random.default_rng(9)
    k, v = _pool(r, P_BLOCKS * PBS, int8), _pool(r, P_BLOCKS * PBS, int8)
    S = len(R_SPANS)
    tables = r.permutation(np.arange(1, P_BLOCKS))[:S * PM].reshape(
        S, PM).astype(np.int32)
    counts = np.asarray([n for n, _ in R_SPANS], np.int32)
    ctx = np.asarray([c for _, c in R_SPANS], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    total = int(counts.sum())
    q = r.normal(size=(total + 2, H256, DH)).astype(np.float32)
    win_base = np.where(counts > 0, ctx - counts - R_WINDOW,
                        tattn.RAGGED_WIN_SENTINEL).astype(np.int32)
    rows = np.concatenate([np.arange(s, s + n) for s, n in zip(starts,
                                                               counts)])
    tol = INT8_TOL if int8 else F32_TOL
    t = torch.from_numpy
    for wb in (win_base, None):
        kw = dict(block_size=PBS, scale=0.0625, max_rows=32, softcap=softcap)
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

# head dim 16 as tests/test_torch_engine.py's GEOM; a 16-token window that
# binds within every stream below
EGEOM = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
             max_position_embeddings=512, query_pre_attn_scalar=16.0,
             sliding_window=16, attn_logit_softcap=2.0,
             final_logit_softcap=30.0, **GEMMA)
DISPATCH = {"k1": {}, "k4": dict(decode_steps_per_dispatch=4),
            "ragged": dict(ragged_dispatch=True, ragged_max_seq_rows=8)}


@pytest.fixture(scope="module")
def e_np_params():
    return _gemma_np_params(EGEOM, 1)


def _prompts(seed):
    r = np.random.default_rng(seed)
    return [r.integers(1, 256, size=n).tolist() for n in (30, 12, 21)]


@pytest.mark.asyncio
@pytest.mark.parametrize("mode", list(DISPATCH))
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "seeded"])
async def test_gemma_engine_streams_match_jax(e_np_params, mode, sampled):
    jcore, tcore = make_cores(e_np_params, 64, 4, EGEOM, **DISPATCH[mode])
    assert tcore.model_cfg.sliding_window == 16     # 256 > 16: it binds
    jout, tout = await run_both(jcore, tcore, _prompts(3), 24,
                                SAMPLED if sampled else None)
    for (jt, jr, _), (tt, tr, _) in zip(jout, tout):
        assert len(tt) == 24 and tr.value == jr.value == "length"
        assert tt == jt
    if mode == "ragged":
        assert tcore.ragged_dispatches == jcore.ragged_dispatches > 0
