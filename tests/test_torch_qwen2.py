"""The port's Qwen2 path against the JAX package's, on the CPU.

Qwen2 is a llama-family model with a bias on the q, k and v projections
and, at 7B, a GQA group of 7 (28 query heads over 4 KV heads of 128), a
group K3 and K4 take only since the table ``kernels.GROUPS`` lists 1-8 at
head dims 64 and 128. Qwen3 drops the bias and adds a per-head RMS norm on
q and k (qk-norm). Every case feeds both packages the same numpy inputs:

- ``ModelConfig.from_hf_config`` of ``chip_smoke.QWEN2_7B_CONFIG`` and of a
  Qwen3-8B-style config gives the same fields in both packages (the bias
  on for qwen2 with no ``attention_bias`` key, no window for qwen2 whose
  ``use_sliding_window`` is false, qk-norm for qwen3).
- The forward passes of a tiny Qwen2 at g = 7 (2 layers, 7 heads over one
  KV head of 128, so that KVH*Dh = 128 and JAX's Pallas kernels run in
  interpret mode) and at g = 6 (12 heads over 2 KV heads of 64), both with
  seeded nonzero biases, and of a tiny Qwen3 (4 heads over 2 of 64, seeded
  q and k norm weights): a prefill, a prefill after a prefix hit
  (start_pos 16), a batched decode step, the pool rows they wrote, and two
  ragged dispatches whose 40- and 26-row chunks cross K4's row tiles (9
  rows a tile at g = 7, 10 at g = 6), against JAX's Pallas kernels in
  interpret mode and its XLA paths: logits atol=1e-4, pool rows
  atol=1e-5 (f32; the two frameworks sum in another order, the
  tolerances of ``tests/test_torch_gemma.py``). The bias dropped on both
  sides, and the qk-norm dropped, moves the logits by more than 100 times
  that bar.
- The plain versions of K1, K2, K3 and K4 at g = 3, 5, 6 and 7, and the
  split forms of K3 and K4 (the partials CUDA kernels write, merged in
  plain PyTorch) against JAX's Pallas kernels in interpret mode: f32
  atol=rtol=2e-5, int8 pools 2e-4 (the bars of ``tests/test_torch_phi3.py``);
  K4's row plan (``ragged_row_plan``, ``ragged_row_tiles``) at those
  groups.
- ``EngineCore`` token streams of both packages on a tiny Qwen2 at g = 7
  with seeded biases: split dispatch at K = 1 and K = 4 and ragged
  dispatch, greedy and seeded sampled (temperature 0.7, top_p 0.9): equal
  streams.
- The launcher serves a model directory holding a tiny ``qwen2`` config
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

from chip_smoke import QWEN2_7B_CONFIG
from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu_torch.engine import attention as tattn
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.weights import params_from_numpy
from tests.test_torch_engine import SAMPLED, make_cores, run_both
from tests.test_torch_serving import SP_FIXTURE, _launch_and_request

F32_TOL, INT8_TOL = 2e-5, 2e-4
LOGIT_ATOL, KV_ATOL = 1e-4, 1e-5
# the seeded biases' scale: as large as the projections themselves (the
# init rule draws matmuls N(0, 1/fan_in), so q, k and v are ~N(0, 1))
BIAS_STD = 1.0

# a Qwen3-8B-style config.json: 36 layers, 32 query heads over 8 KV heads
# of 128, qk-norm, no qkv bias
QWEN3_8B_STYLE = {
    "architectures": ["Qwen3ForCausalLM"], "attention_bias": False,
    "bos_token_id": 151643, "eos_token_id": 151645, "head_dim": 128,
    "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 12288,
    "max_position_embeddings": 40960, "model_type": "qwen3",
    "num_attention_heads": 32, "num_hidden_layers": 36,
    "num_key_value_heads": 8, "rms_norm_eps": 1e-06, "rope_theta": 1000000.0,
    "tie_word_embeddings": False, "use_sliding_window": False,
    "vocab_size": 151936}


def _same_fields(got, want):
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw", [QWEN2_7B_CONFIG, QWEN3_8B_STYLE],
                         ids=["qwen2_7b", "qwen3_8b_style"])
def test_qwen_config_matches_jax(raw):
    got = ModelConfig.from_hf_config(raw)
    want = JModelConfig.from_hf_config(raw)
    # every field of the port's copy (the JAX one adds TPU-only knobs)
    _same_fields(got, want)
    assert got.sliding_window is None and not got.tie_word_embeddings
    assert not tllama.sliding_layer_mask(got).any()
    if raw is QWEN2_7B_CONFIG:
        assert "attention_bias" not in raw and got.attention_bias
        assert not got.qk_norm
        assert (got.num_heads, got.num_kv_heads, got.head_dim) == (28, 4, 128)
        assert (got.hidden_size, got.intermediate_size, got.num_layers,
                got.vocab_size) == (3584, 18944, 28, 152064)
        assert got.rope_theta == 1e6 and got.rms_norm_eps == 1e-6
    else:
        assert got.qk_norm and not got.attention_bias
        assert (got.num_heads, got.num_kv_heads, got.head_dim) == (32, 8, 128)


# ---------------------------------------------------------------------------
# forward passes: prefill, prefix-hit prefill, decode, pool rows
# ---------------------------------------------------------------------------

BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=2, max_position_embeddings=256, rope_theta=1e6,
            rms_norm_eps=1e-6)
# KVH*Dh = 128 in each: the geometry the Pallas kernels interpret
GEOMS = {
    "qwen2_g7": dict(BASE, model_type="qwen2", num_heads=7, num_kv_heads=1,
                     head_dim=128, attention_bias=True),
    "qwen2_g6": dict(BASE, model_type="qwen2", num_heads=12, num_kv_heads=2,
                     head_dim=64, attention_bias=True),
    "qwen3": dict(BASE, model_type="qwen3", num_heads=4, num_kv_heads=2,
                  head_dim=64, qk_norm=True),
}
BS, NUM_BLOCKS, M = 8, 16, 8
rng = np.random.default_rng(5)
TOKENS_A = rng.integers(1, 128, size=20).tolist()
TOKENS_B = TOKENS_A[:16] + rng.integers(1, 128, size=6).tolist()
TABLE_A = [1, 2, 3]
TABLE_B = [1, 2, 4]          # blocks 1-2 hold the shared 16-token prefix
DECODE_IN = [7, 9, 0]        # slot 2 is inactive


def _np_params(geom, seed):
    """JAX's init (biases 0, norms 1), then seeded biases of BIAS_STD and
    q / k norm weights of 1 + N(0, 0.3^2), so that both reach the
    logits."""
    p = jllama.init_params(JModelConfig(**geom), jax.random.PRNGKey(seed),
                           dtype=jnp.float32)
    out = {k: np.asarray(v) for k, v in p.items()}
    r = np.random.default_rng(seed + 100)
    for name in ("layers.bq", "layers.bk", "layers.bv"):
        if name in out:
            out[name] = (BIAS_STD * r.standard_normal(
                out[name].shape)).astype(np.float32)
    for name in ("layers.q_norm", "layers.k_norm"):
        if name in out:
            out[name] = (1 + 0.3 * r.standard_normal(
                out[name].shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=list(GEOMS))
def geom(request):
    return request.param


@pytest.fixture(scope="module")
def np_params(geom):
    return _np_params(GEOMS[geom], 0)


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


def _jax_forward(np_params, geom, impl):
    cfg = JModelConfig(**geom)
    params = {k: jnp.asarray(v) for k, v in np_params.items()}
    mp = pytest.MonkeyPatch()
    mp.setenv("DYN_ATTN_SEQS_PER_PROG", "1")
    try:
        statics = jllama.ModelStatics(cfg=cfg, block_size=BS, attn_impl=impl,
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


@pytest.fixture(scope="module")
def torch_run(np_params, geom):
    return _torch_forward(np_params, GEOMS[geom])


@pytest.fixture(scope="module", params=["pallas_interpret", "xla"])
def jax_run(request, np_params, geom):
    return _jax_forward(np_params, GEOMS[geom], request.param)


def test_qwen_prefill_logits_match(torch_run, jax_run):
    np.testing.assert_allclose(torch_run["prefill_a"], jax_run["prefill_a"],
                               atol=LOGIT_ATOL, rtol=0)


def test_qwen_prefix_hit_prefill_logits_match(torch_run, jax_run):
    np.testing.assert_allclose(torch_run["prefill_b"], jax_run["prefill_b"],
                               atol=LOGIT_ATOL, rtol=0)


def test_qwen_decode_logits_match(torch_run, jax_run):
    # slot 2 is inactive (the trash row): only the live slots are compared
    np.testing.assert_allclose(torch_run["decode"][:2],
                               jax_run["decode"][:2], atol=LOGIT_ATOL, rtol=0)
    assert np.isfinite(torch_run["decode"]).all()


def test_qwen_kv_pool_rows_match(torch_run, jax_run):
    for name in ("k", "v"):
        np.testing.assert_allclose(torch_run[name][:, BS:],
                                   jax_run[name][:, BS:], atol=KV_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("name,drop", [
    ("qwen2_g7", ("layers.bq", "layers.bk", "layers.bv")),
    ("qwen2_g6", ("layers.bq", "layers.bk", "layers.bv")),
    ("qwen3", ("layers.q_norm", "layers.k_norm"))],
    ids=["qwen2_g7_bias", "qwen2_g6_bias", "qwen3_qk_norm"])
def test_qwen_dropped_projection_terms_move_the_logits(name, drop):
    """The comparisons above see the bias (qwen2) and the qk-norm (qwen3):
    the biases zeroed, or the norm weights set to 1, in both packages
    moves the prompt's and the decode step's logits of each by far more
    than their tolerance, and the two packages still agree."""
    geom = GEOMS[name]
    base = _np_params(geom, 0)
    plain = dict(base)
    for n in drop:
        plain[n] = (np.zeros_like(base[n]) if n.startswith("layers.b")
                    else np.ones_like(base[n]))
    t_base, t_plain = _torch_forward(base, geom), _torch_forward(plain, geom)
    j_base = _jax_forward(base, geom, "xla")
    j_plain = _jax_forward(plain, geom, "xla")
    for key in ("prefill_a", "decode"):
        for a, b in ((t_base, t_plain), (j_base, j_plain)):
            d = np.abs(a[key][:2] - b[key][:2]).max()
            assert d > 100 * LOGIT_ATOL, (key, d)
        np.testing.assert_allclose(t_plain[key][:2], j_plain[key][:2],
                                   atol=LOGIT_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# ragged_forward: two dispatches, the second mixed, chunks across row tiles
# ---------------------------------------------------------------------------

RBS, R_BLOCKS = 32, 10
R_TABLES = np.array([[1, 2, 0], [3, 0, 0], [4, 5, 0], [0, 0, 0]], np.int32)
_rrng = np.random.default_rng(11)
PROMPT_A = _rrng.integers(1, 128, size=40).tolist()
PROMPT_B = _rrng.integers(1, 128, size=9).tolist()
PROMPT_C = _rrng.integers(1, 128, size=50).tolist()
# 40 and 24 rows in the first dispatch, 26 continuing a prefix in the
# second: each crosses K4's 9-row (g = 7) and 10-row (g = 6) tiles
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
def ragged_torch(np_params, geom):
    cfg = ModelConfig(**GEOMS[geom])
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
def ragged_jax(request, np_params, geom):
    cfg = JModelConfig(**GEOMS[geom])
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


def test_qwen_ragged_logits_match(ragged_torch, ragged_jax):
    for d, (g, w) in enumerate(zip(ragged_torch[0], ragged_jax[0])):
        live = sorted(DISPATCHES[d])            # the trash row is discarded
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g[live], w[live], atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"dispatch {d}")


def test_qwen_ragged_kv_rows_match(ragged_torch, ragged_jax):
    rows = np.concatenate([
        (R_TABLES[s][:, None] * RBS + np.arange(RBS)).reshape(-1)[:n]
        for s, n in ((0, 41), (1, 9), (2, 50))])
    for got, want in zip(ragged_torch[1:], ragged_jax[1:]):
        np.testing.assert_allclose(got[:, rows], want[:, rows],
                                   atol=KV_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the four attention kernels' plain versions at g = 3, 5, 6 and 7
# ---------------------------------------------------------------------------

# (H, KVH, Dh) by group, KVH*Dh = 128: Llama-3.2-3B's g = 3, Qwen2.5-14B's
# 5, Qwen2-1.5B's 6 at head dim 64, Qwen2-7B's 7
GROUP_GEOMS = {3: (3, 1, 128), 5: (5, 1, 128), 6: (12, 2, 64),
               7: (7, 1, 128)}


@pytest.mark.parametrize("g", list(GROUP_GEOMS))
def test_flash_prefill_plain_groups_match_jax_kernel(g):
    """K1: a 48-token chunk at positions 80..127 over 128 keys (the last 8
    padding)."""
    H, KVH, Dh = GROUP_GEOMS[g]
    r = np.random.default_rng(20 + g)
    T, S, start, true_len = 48, 128, 80, 40
    q = r.normal(size=(T, H, Dh)).astype(np.float32)
    k = r.normal(size=(S, KVH, Dh)).astype(np.float32)
    v = r.normal(size=(S, KVH, Dh)).astype(np.float32)
    kw = dict(scale=Dh ** -0.5, start_pos=start, seq_len=start + true_len)
    got = tattn.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw).numpy()
    want = jattn.flash_prefill(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), q_chunk=16, kv_chunk=32,
                               interpret=True, **kw)
    np.testing.assert_allclose(got[:true_len], np.asarray(want)[:true_len],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("g", list(GROUP_GEOMS))
def test_flash_prefill_partial_plain_groups_match_jax_kernel(g):
    """K2, ring hops: the diagonal hop, and a chunk that some rows see and
    others do not (start_pos < 0)."""
    H, KVH, Dh = GROUP_GEOMS[g]
    r = np.random.default_rng(30 + g)
    T = S = 64
    q = r.normal(size=(T, H, Dh)).astype(np.float32)
    k = r.normal(size=(S, KVH, Dh)).astype(np.float32)
    v = r.normal(size=(S, KVH, Dh)).astype(np.float32)
    for start, seq_len in ((0, 64), (-24, 64)):
        got = tattn.flash_prefill_partial_ref(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            scale=Dh ** -0.5, start_pos=start, seq_len=seq_len)
        want = jattn.flash_prefill_partial(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=Dh ** -0.5,
            start_pos=jnp.int32(start), seq_len=jnp.int32(seq_len),
            q_chunk=32, kv_chunk=32, interpret=True)
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_),
                                       rtol=F32_TOL, atol=F32_TOL)


def _pool(r, n_rows, C, int8):
    x = r.normal(size=(n_rows, C)).astype(np.float32)
    return np.array(jattn.quantize_kv_rows(jnp.asarray(x))) if int8 else x


PBS, P_BLOCKS, PM = 32, 40, 5
# K3's sequences: lengths on both sides of the 128-key splits of a
# 160-key table, a single key, a zero-length slot
P_LENS = [1, 127, 128, 129, 160, 40, 0]


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("g", list(GROUP_GEOMS))
def test_paged_plain_groups_match_jax_kernel(g, int8, monkeypatch):
    """K3's plain version and its split form (the partials the CUDA kernel
    writes, merged in plain PyTorch) against JAX's Pallas kernel."""
    monkeypatch.setenv("DYN_ATTN_SEQS_PER_PROG", "1")
    H, KVH, Dh = GROUP_GEOMS[g]
    r = np.random.default_rng(40 + g)
    k = _pool(r, P_BLOCKS * PBS, KVH * Dh, int8)
    v = _pool(r, P_BLOCKS * PBS, KVH * Dh, int8)
    B = len(P_LENS)
    tables = r.permutation(np.arange(1, P_BLOCKS))[:B * PM].reshape(
        B, PM).astype(np.int32)
    lens = np.asarray(P_LENS, np.int32)
    q = r.normal(size=(B, H, Dh)).astype(np.float32)
    tol = INT8_TOL if int8 else F32_TOL
    live = lens > 0
    kw = dict(block_size=PBS, scale=Dh ** -0.5)
    args = [torch.from_numpy(a) for a in (q, k, v, tables, lens)]
    got = tattn.paged_attention(*args, **kw).numpy()
    split = tattn.merge_split_partials(
        *tattn.paged_attention_partials_ref(*args, **kw)).numpy()
    want = np.asarray(jattn.paged_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v, tables, lens)), chunk_blocks=1,
        interpret=True, **kw))
    for out in (got, split):
        np.testing.assert_allclose(out[live], want[live], rtol=tol, atol=tol)
        assert not out[~live].any()


# K4's mix: a 30-row chunk continuing a prefix to 130 keys and a fresh
# 24-row prompt (both cross a row tile at every group: 21, 12, 10 and 9
# rows a tile), decode rows at 41 and 160 keys, a zero-count slot
R_SPANS = [(30, 130), (24, 24), (1, 41), (1, 160), (0, 0)]


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("g", list(GROUP_GEOMS))
def test_ragged_plain_groups_match_jax_kernel(g, int8):
    """K4's plain version and its split form against JAX's Pallas
    kernel."""
    H, KVH, Dh = GROUP_GEOMS[g]
    r = np.random.default_rng(50 + g)
    k = _pool(r, P_BLOCKS * PBS, KVH * Dh, int8)
    v = _pool(r, P_BLOCKS * PBS, KVH * Dh, int8)
    S = len(R_SPANS)
    tables = r.permutation(np.arange(1, P_BLOCKS))[:S * PM].reshape(
        S, PM).astype(np.int32)
    counts = np.asarray([n for n, _ in R_SPANS], np.int32)
    ctx = np.asarray([c for _, c in R_SPANS], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    total = int(counts.sum())
    q = r.normal(size=(total + 2, H, Dh)).astype(np.float32)
    rows = np.concatenate([np.arange(s, s + n) for s, n in zip(starts,
                                                               counts)])
    tol = INT8_TOL if int8 else F32_TOL
    kw = dict(block_size=PBS, scale=Dh ** -0.5, max_rows=32)
    args = [torch.from_numpy(a) for a in (q, k, v, tables, starts, counts,
                                          ctx)]
    got = tattn.ragged_paged_attention(*args, **kw).numpy()
    split = tattn.merge_split_partials(
        *tattn.ragged_attention_partials_ref(*args, **kw)).numpy()
    want = np.asarray(jattn.ragged_paged_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v, tables, starts, counts, ctx)),
        chunk_blocks=1, interpret=True, **kw))
    for out in (got, split):
        np.testing.assert_allclose(out[rows], want[rows], rtol=tol, atol=tol)
        assert not out[total:].any()           # rows no sequence owns


@pytest.mark.parametrize("g,per", [(3, 21), (5, 12), (6, 10), (7, 9)])
def test_ragged_row_plan_at_groups_with_pad_vectors(g, per):
    """K4's row tile is floor(64 / g) rows (the 64 - per * g vectors left
    are pads); a tile of more than 16 live (row, head) vectors doubles
    K3's chunk; a tile's live splits come from the keys its last row
    sees."""
    assert tattn.ragged_row_tiles(64, g) == -(-64 // per)
    assert tattn.ragged_row_tiles(per, g) == 1
    assert tattn.ragged_row_tiles(per + 1, g) == 2
    n = 2 * per + 2                    # two full tiles and one of 2 rows
    counts = torch.tensor([n], dtype=torch.int32)
    starts = torch.tensor([0], dtype=torch.int32)
    ctx = torch.tensor([600], dtype=torch.int32)
    chunks, live = tattn.ragged_row_plan(starts, counts, ctx, n, g, 40, 16)
    last = 256 if 2 * g > 16 else 128
    assert chunks.tolist() == [256] * (2 * per) + [last] * 2
    pos0 = 600 - n
    assert live.tolist() == ([-(-(pos0 + per) // 256)] * per
                             + [-(-(pos0 + 2 * per) // 256)] * per
                             + [-(-600 // last)] * 2)


# ---------------------------------------------------------------------------
# EngineCore streams: split dispatch at K = 1 and 4, ragged dispatch
# ---------------------------------------------------------------------------

# g = 7 over one KV head of 32, seeded biases
EGEOM = dict(BASE, model_type="qwen2", vocab_size=256, num_heads=7,
             num_kv_heads=1, head_dim=32, max_position_embeddings=512,
             attention_bias=True)
DISPATCH = {"k1": {}, "k4": dict(decode_steps_per_dispatch=4),
            "ragged": dict(ragged_dispatch=True, ragged_max_seq_rows=16)}


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
async def test_qwen2_engine_streams_match_jax(e_np_params, mode, sampled):
    jcore, tcore = make_cores(e_np_params, 64, 4, EGEOM, **DISPATCH[mode])
    assert tcore.model_cfg.attention_bias
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

HF_TINY = {"model_type": "qwen2", "vocab_size": 307, "hidden_size": 64,
           "intermediate_size": 128, "num_hidden_layers": 2,
           "num_attention_heads": 7, "num_key_value_heads": 1,
           "head_dim": 32, "max_position_embeddings": 256,
           "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
           "sliding_window": 256, "use_sliding_window": False,
           "tie_word_embeddings": False, "bos_token_id": 1,
           "eos_token_id": 2}


@pytest.mark.parametrize("extra", [(), ("--ragged", "--ragged-max-seq-rows",
                                        "8")], ids=["split", "ragged"])
def test_launcher_serves_a_qwen2_dir(tmp_path, extra):
    d = str(tmp_path / "tiny-qwen2")
    os.makedirs(d)
    shutil.copy(SP_FIXTURE, os.path.join(d, "tokenizer.model"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(HF_TINY, f)
    cfg = ModelConfig.from_model_dir(d)
    assert cfg.model_type == "qwen2" and cfg.attention_bias
    assert cfg.sliding_window is None
    _launch_and_request(d, *extra)
