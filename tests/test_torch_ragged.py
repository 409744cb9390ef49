"""The PyTorch port's ragged dispatch against the JAX package's, on the CPU.

- ``build_ragged_batch``: the port's copy packs every pending set of a
  seeded sweep into arrays and spans equal to the JAX package's, and
  refuses what it refuses with the same message.
- ``ragged_paged_attention`` (its plain version on CPU tensors) on the
  corner mix of ``tests/test_ragged_attention.py`` — a multi-tile chunk
  that continues a prefix, a chunk that ends on a block boundary, decode
  rows, a zero-count slot, a decode row with no history — against the JAX
  package's ragged Pallas kernel in interpret mode and its XLA decode
  attention over row-expanded tables. Only owned rows are compared, as the
  JAX tests do; the port's unowned rows are zeros (the CUDA kernel's
  contract). Tolerances: f32 atol=rtol=2e-5, JAX's own bar for this
  kernel; int8 rows 2e-4, JAX's int8 bar (``test_ragged_kernel_int8_rows``).
- ``llama.ragged_forward``: two dispatches of a tiny f32 llama, the second
  mixed (a fresh prompt, a chunk continuing a prefix, a decode row), in
  the model-dtype pool and in an int8 pool, against JAX's
  ``ragged_forward`` with ``attn_impl="xla"`` and ``"pallas_interpret"``.
  Logits atol=1e-4 over the model-dtype pool (same weights, same f32
  arithmetic summed in another order, as in test_torch_quant_llama.py;
  measured below 3e-6) and 1e-3 over the int8 pool: a K/V value that both
  packages compute to f32 rounding apart can sit at a rounding boundary and
  land one int8 step apart (3 of ~250k pool bytes at this seed), which
  moves these logits by up to 2.5e-4. Pool rows where written: f32
  atol=1e-5; int8 at most 0.1 % of bytes apart and within one
  quantization step dequantized.
- ``EngineCore`` with ``ragged_dispatch=True`` on both engines
  (``make_cores``/``run_both`` of test_torch_engine.py): greedy streams of
  prompts longer than the row budget are equal, mixed dispatches happen
  and admissions record their numeric boundary; streams are invariant
  under the row budget (6 and 64); seeded sampled streams are equal;
  under a small pool both engines preempt and the streams agree to the
  first recompute boundary; int4 weights over an int8 pool give equal
  greedy streams; ``EngineConfig``'s ragged validation resolves and
  refuses as JAX's does, and accepts the pipelined ragged dispatch as
  JAX's does.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine import ragged as jragged
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu_torch.engine import attention as tattn
from dynamo_tpu_torch.engine import ragged as tragged
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.core import (FINISH_SENTINEL, EngineCore,
                                          EngineRequest)
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.sampling import SlotSampling
from dynamo_tpu_torch.engine.weights import params_from_numpy
from tests.test_torch_package import UNPORTED_ENGINE_FIELDS
from tests.test_torch_engine import (GEOM, GREEDY, QGEOM, QUANT, SAMPLED,
                                     _collect, _engine_kwargs, make_cores,
                                     run_both)

F32_TOL = 2e-5
INT8_TOL = 2e-4
BS = 8          # KV block size of the attention mix
NB = 48         # pool blocks


# ---------------------------------------------------------------------------
# the batch builder
# ---------------------------------------------------------------------------


def _pending(rng):
    n_slots = int(rng.integers(1, 9))
    decode_rows, prefill_lanes = [], []
    for slot in range(n_slots):
        pos = int(rng.integers(0, 50))
        role = int(rng.integers(0, 3))      # 0 free, 1 decode, 2 prefill
        if role == 1:
            decode_rows.append((slot, int(rng.integers(1, 99)), pos))
        elif role == 2:
            toks = rng.integers(1, 99, size=int(rng.integers(1, 30))).tolist()
            prefill_lanes.append((slot, toks, pos))
    return n_slots, decode_rows, prefill_lanes


def _build_both(*args):
    out = []
    for build in (tragged.build_ragged_batch, jragged.build_ragged_batch):
        try:
            out.append(build(*args))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


def test_builder_matches_jax_over_a_seeded_sweep():
    rng = np.random.default_rng(1234)
    arrays = ("tokens", "positions", "row_slot", "seq_starts", "seq_counts",
              "sample_rows")
    seen = {"batch": 0, "none": 0, "error": 0}
    for _ in range(300):
        n_slots, decode_rows, prefill_lanes = _pending(rng)
        n_mand = len(decode_rows) + len(prefill_lanes)
        # capacities from too small (the capacity error) to roomy
        capacity = int(rng.integers(max(n_mand - 2, 1), n_mand + 24))
        max_rows = int(rng.integers(1, 9))
        got, want = _build_both(capacity, n_slots, decode_rows,
                                prefill_lanes, max_rows)
        if want is None:
            seen["none"] += 1
            assert got is None
            continue
        if isinstance(want, tuple):
            seen["error"] += 1
            assert got == want
            continue
        seen["batch"] += 1
        for name in arrays:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
        assert ([dataclasses.astuple(s) for s in got.seqs]
                == [dataclasses.astuple(s) for s in want.seqs])
        for prop in ("rows_used", "fill_ratio", "n_prefill", "n_decode",
                     "prefill_rows", "mixed", "dispatches_replaced"):
            assert getattr(got, prop) == getattr(want, prop), prop
        assert got.seqs_meta() == want.seqs_meta()
    assert min(seen.values()) > 0, seen


def test_builder_spec_lanes_match_jax():
    """The packing policy is one function: spec spans pack as in JAX, though
    the port's engine does not produce them yet."""
    args = (16, 4, [(0, 7, 30)], [(1, list(range(100, 140)), 0)], 32)
    got = tragged.build_ragged_batch(*args, spec_lanes=[(2, [9, 10, 11], 12)])
    want = jragged.build_ragged_batch(*args,
                                      spec_lanes=[(2, [9, 10, 11], 12)])
    assert got.seqs_meta() == want.seqs_meta()
    assert got.n_spec == want.n_spec == 1
    assert got.spec_rows == want.spec_rows == 2
    np.testing.assert_array_equal(got.tokens, want.tokens)


# ---------------------------------------------------------------------------
# ragged attention: the plain version against JAX's kernel and XLA row path
# ---------------------------------------------------------------------------


def _mix(rng, n_slots=5, M=5):
    """tests/test_ragged_attention.py's corner mix over a shuffled table."""
    perm = rng.permutation(np.arange(1, NB))
    tables = perm[:n_slots * M].reshape(n_slots, M).astype(np.int32)
    seqs = [(9, 21),          # chunk continuing a prefix, crosses tiles
            (BS, 2 * BS),     # ends exactly on a block boundary
            (1, 17),          # decode row
            (0, 0),           # inactive slot
            (1, 1)][:n_slots]  # decode row with no history
    starts, counts, ctx = [], [], []
    cursor = 0
    for ln, sl in seqs:
        starts.append(cursor)
        counts.append(ln)
        ctx.append(sl)
        cursor += ln
    return (tables, np.asarray(starts, np.int32),
            np.asarray(counts, np.int32), np.asarray(ctx, np.int32), cursor)


def _row_expand(tables, starts, counts, ctx):
    rt, rl, rows = [], [], []
    for s in range(len(counts)):
        for r in range(int(counts[s])):
            rows.append(int(starts[s]) + r)
            rt.append(tables[s])
            rl.append(int(ctx[s]) - int(counts[s]) + r + 1)
    return np.asarray(rows), np.stack(rt), np.asarray(rl, np.int32)


def _port_ragged(q, k, v, tables, starts, counts, ctx, **kw):
    t = torch.from_numpy
    return tattn.ragged_paged_attention(
        t(np.asarray(q)), t(np.asarray(k)), t(np.asarray(v)), t(tables),
        t(starts), t(counts), t(ctx), **kw).numpy()


def _unowned(total_rows, rows):
    mask = np.ones((total_rows,), bool)
    mask[rows] = False
    return mask


@pytest.mark.parametrize("H,KVH,Dh", [(8, 2, 64), (4, 1, 128)])
def test_ragged_plain_matches_jax_kernel_and_xla(H, KVH, Dh):
    rng = np.random.default_rng(0)
    C = KVH * Dh
    k = rng.normal(size=(NB * BS, C)).astype(np.float32)
    v = rng.normal(size=(NB * BS, C)).astype(np.float32)
    tables, starts, counts, ctx, total = _mix(rng)
    q = rng.normal(size=(total + 3, H, Dh)).astype(np.float32)
    got = _port_ragged(q, k, v, tables, starts, counts, ctx, block_size=BS,
                       scale=0.11, max_rows=16)
    rows, rt, rl = _row_expand(tables, starts, counts, ctx)
    pallas = jattn.ragged_paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        starts, counts, ctx, block_size=BS, scale=0.11, max_rows=16,
        chunk_blocks=2, interpret=True)
    xla = jattn.paged_attention_xla(
        jnp.asarray(q[rows]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(rt), jnp.asarray(rl), block_size=BS, scale=0.11)
    np.testing.assert_allclose(got[rows], np.asarray(pallas)[rows],
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got[rows], np.asarray(xla),
                               rtol=F32_TOL, atol=F32_TOL)
    assert not got[_unowned(total + 3, rows)].any()


def test_ragged_plain_int8_rows_match_jax():
    """JAX's int8 case: 32-token blocks, in-row (e, m) scales; the pool
    bytes are the JAX package's quantizer output, fed to both."""
    rng = np.random.default_rng(1)
    H, KVH, Dh, bs32 = 4, 1, 128, 32
    C = KVH * Dh
    kf = rng.normal(size=(16 * bs32, C)).astype(np.float32)
    vf = rng.normal(size=(16 * bs32, C)).astype(np.float32)
    k8 = np.asarray(jattn.quantize_kv_rows(jnp.asarray(kf)))
    v8 = np.asarray(jattn.quantize_kv_rows(jnp.asarray(vf)))
    tables = rng.permutation(np.arange(1, 16))[:15].reshape(5, 3).astype(
        np.int32)
    starts = np.asarray([0, 9, 9 + bs32, 9 + bs32 + 1, 9 + bs32 + 1],
                        np.int32)
    counts = np.asarray([9, bs32, 1, 0, 1], np.int32)
    ctx = np.asarray([21, 2 * bs32, 17, 0, 1], np.int32)
    total = int(counts.sum())
    q = rng.normal(size=(total + 2, H, Dh)).astype(np.float32)
    got = _port_ragged(q, k8, v8, tables, starts, counts, ctx,
                       block_size=bs32, scale=0.09, max_rows=bs32)
    rows, rt, rl = _row_expand(tables, starts, counts, ctx)
    pallas = jattn.ragged_paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(tables),
        jnp.asarray(starts), jnp.asarray(counts), jnp.asarray(ctx),
        block_size=bs32, scale=0.09, max_rows=bs32, chunk_blocks=2,
        interpret=True)
    xla = jattn.paged_attention_xla(
        jnp.asarray(q[rows]), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(rt), jnp.asarray(rl), block_size=bs32, scale=0.09)
    np.testing.assert_allclose(got[rows], np.asarray(pallas)[rows],
                               rtol=INT8_TOL, atol=INT8_TOL)
    np.testing.assert_allclose(got[rows], np.asarray(xla),
                               rtol=INT8_TOL, atol=INT8_TOL)
    assert not got[_unowned(total + 2, rows)].any()


@pytest.mark.parametrize("softcap,window", [(4.0, None), (None, 10),
                                            (4.0, 10)])
def test_ragged_plain_softcap_and_window_match_xla(softcap, window):
    """Per-row sliding floors win_base[s] + r mask exactly what per-row
    win_lo masks in the XLA row path; the global sentinel masks nothing."""
    rng = np.random.default_rng(3)
    H, KVH, Dh = 8, 2, 64
    k = rng.normal(size=(NB * BS, KVH * Dh)).astype(np.float32)
    v = rng.normal(size=(NB * BS, KVH * Dh)).astype(np.float32)
    tables, starts, counts, ctx, total = _mix(rng)
    q = rng.normal(size=(total + 2, H, Dh)).astype(np.float32)
    rows, rt, rl = _row_expand(tables, starts, counts, ctx)
    win_base = win_lo = None
    if window is not None:
        win_base = torch.from_numpy(np.where(
            counts > 0, ctx - counts - window,
            tattn.RAGGED_WIN_SENTINEL).astype(np.int32))
        win_lo = jnp.asarray((rl - 1 - window).astype(np.int32))
    got = _port_ragged(q, k, v, tables, starts, counts, ctx, block_size=BS,
                       scale=0.1, max_rows=16, softcap=softcap,
                       win_base=win_base)
    want = jattn.paged_attention_xla(
        jnp.asarray(q[rows]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(rt), jnp.asarray(rl), block_size=BS, scale=0.1,
        softcap=softcap, win_lo=win_lo)
    np.testing.assert_allclose(got[rows], np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    # the global-layer sentinel masks nothing
    if window is not None:
        sentinel = torch.full((len(counts),), tattn.RAGGED_WIN_SENTINEL,
                              dtype=torch.int32)
        np.testing.assert_array_equal(
            _port_ragged(q, k, v, tables, starts, counts, ctx,
                         block_size=BS, scale=0.1, max_rows=16,
                         softcap=softcap, win_base=sentinel),
            _port_ragged(q, k, v, tables, starts, counts, ctx,
                         block_size=BS, scale=0.1, max_rows=16,
                         softcap=softcap))


def test_ragged_plain_refuses_counts_above_max_rows():
    rng = np.random.default_rng(4)
    k = rng.normal(size=(NB * BS, 128)).astype(np.float32)
    tables, starts, counts, ctx, total = _mix(rng)
    q = rng.normal(size=(total, 8, 64)).astype(np.float32)
    with pytest.raises(ValueError, match="max_rows"):
        _port_ragged(q, k, k, tables, starts, counts, ctx, block_size=BS,
                     scale=0.1, max_rows=8)


# ---------------------------------------------------------------------------
# ragged_forward: a tiny llama, two dispatches, the second mixed
# ---------------------------------------------------------------------------

# KVH*Dh = 128 and 32-token blocks: the JAX ragged kernel's interpret mode
# takes this geometry for both pools
LGEOM = dict(vocab_size=128, hidden_size=128, intermediate_size=256,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
             max_position_embeddings=256)
LBS, L_BLOCKS, LM = 32, 10, 3
LC = 2 * 64
L_TABLES = np.array([[1, 2, 0], [3, 0, 0], [4, 5, 0], [0, 0, 0]], np.int32)
_lrng = np.random.default_rng(11)
PROMPT_A = _lrng.integers(1, 128, size=40).tolist()
PROMPT_B = _lrng.integers(1, 128, size=9).tolist()
PROMPT_C = _lrng.integers(1, 128, size=50).tolist()
# {slot: (tokens, pos0)}: A and the first 24 tokens of C, then a decode row
# for A, B's whole prompt and the rest of C (a chunk continuing a prefix)
DISPATCHES = [{0: (PROMPT_A, 0), 2: (PROMPT_C[:24], 0)},
              {0: ([7], 40), 1: (PROMPT_B, 0), 2: (PROMPT_C[24:], 24)}]
L_MAX_ROWS = 64


def _ragged_args(chunks, n_slots=3):
    """Rows packed in slot order, ``tests/test_ragged_attention.py``'s
    ``_ragged_args``; the trailing sequence is the trash one."""
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
def l_np_params():
    p = jllama.init_params(JModelConfig(**LGEOM), jax.random.PRNGKey(2),
                           dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def _torch_ragged_run(np_params, kv_quant):
    cfg = ModelConfig(**LGEOM)
    params = params_from_numpy(np_params, cfg, "cpu", torch.float32)
    kv = tllama.init_kv_cache(cfg, L_BLOCKS, LBS, "cpu", torch.float32,
                              quantization=kv_quant)
    logits = []
    with torch.inference_mode():
        for chunks in DISPATCHES:
            tok, pos, rs, st, cn, sr = (torch.from_numpy(a)
                                        for a in _ragged_args(chunks))
            logits.append(tllama.ragged_forward(
                params, kv, tok.long(), pos, torch.from_numpy(L_TABLES), rs,
                st, cn, sr, cfg, LBS, L_MAX_ROWS).numpy())
    return logits, kv["k"].numpy(), kv["v"].numpy()


def _jax_ragged_run(np_params, kv_quant, impl):
    cfg = JModelConfig(**LGEOM)
    statics = jllama.ModelStatics(cfg=cfg, block_size=LBS, attn_impl=impl,
                                  kv_coalesce=False)
    params = {k: jnp.asarray(v) for k, v in np_params.items()}
    kv = jllama.init_kv_cache(cfg, L_BLOCKS, LBS, dtype=jnp.float32,
                              quantization=kv_quant)
    logits = []
    for chunks in DISPATCHES:
        tok, pos, rs, st, cn, sr = (jnp.asarray(a)
                                    for a in _ragged_args(chunks))
        lg, kv = jllama.ragged_forward(params, kv, tok, pos,
                                       jnp.asarray(L_TABLES), rs, st, cn, sr,
                                       statics, max_rows=L_MAX_ROWS)
        logits.append(np.asarray(lg))
    return logits, np.asarray(kv["k"]), np.asarray(kv["v"])


@pytest.fixture(scope="module", params=[
    (kvq, impl) for kvq in ("none", "int8")
    for impl in ("xla", "pallas_interpret")], ids=lambda p: "-".join(p))
def ragged_runs(request, l_np_params):
    kv_quant, impl = request.param
    return (kv_quant, _torch_ragged_run(l_np_params, kv_quant),
            _jax_ragged_run(l_np_params, kv_quant, impl))


LOGIT_ATOL = {"none": 1e-4, "int8": 1e-3}


def test_ragged_forward_logits_match_jax(ragged_runs):
    kv_quant, (got, _, _), (want, _, _) = ragged_runs
    for d, (g, w) in enumerate(zip(got, want)):
        live = sorted(DISPATCHES[d])            # the trash row is discarded
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g[live], w[live],
                                   atol=LOGIT_ATOL[kv_quant], rtol=0,
                                   err_msg=f"dispatch {d}")


def test_ragged_forward_kv_rows_match_jax(ragged_runs):
    kv_quant, (_, gk, gv), (_, wk, wv) = ragged_runs
    # the rows the two dispatches wrote: A 41, B 9, C 50 tokens
    rows = np.concatenate([
        (L_TABLES[s][:, None] * LBS + np.arange(LBS)).reshape(-1)[:n]
        for s, n in ((0, 41), (1, 9), (2, 50))])
    for g, w in ((gk, wk), (gv, wv)):
        g, w = g[:, rows], w[:, rows]
        if kv_quant == "none":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
            continue
        assert g.dtype == np.int8 and g.shape[-1] == LC + 128
        assert (g != w).mean() <= 1e-3
        gd = tattn.dequant_kv_rows(torch.from_numpy(g), LC,
                                   torch.float32).numpy()
        wd = np.asarray(jattn.dequant_kv_rows(jnp.asarray(w), LC,
                                              jnp.float32))
        step = tattn._decode_scale(torch.from_numpy(w[..., LC].copy()),
                                   torch.from_numpy(w[..., LC + 1].copy())
                                   ).numpy()
        assert (np.abs(gd - wd) <= 1.01 * step[..., None] + 1e-6).all()


# ---------------------------------------------------------------------------
# EngineCore: ragged serving against the JAX ragged engine
# ---------------------------------------------------------------------------

RAGGED = dict(ragged_dispatch=True)


@pytest.fixture(scope="module")
def np_params():
    p = jllama.init_params(JModelConfig(**GEOM), jax.random.PRNGKey(0),
                           dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def np_qparams():
    p = jllama.init_params(JModelConfig(**QGEOM), jax.random.PRNGKey(1),
                           dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def _long_prompts():
    rng = np.random.default_rng(23)
    return [rng.integers(1, 256, size=n).tolist() for n in (30, 17)]


@pytest.mark.asyncio
@pytest.mark.parametrize("rows", [6, 64])
async def test_ragged_greedy_streams_match_jax(np_params, rows):
    jcore, tcore = make_cores(np_params, 64, 2, **RAGGED,
                              ragged_max_seq_rows=rows)
    jout, tout = await run_both(jcore, tcore, _long_prompts(), 24)
    for (jt, jr, jq), (tt, tr, tq) in zip(jout, tout):
        assert len(tt) == 24 and tr.value == jr.value == "length"
        assert tt == jt
        # the first token came from the ragged forward: a recorded boundary
        assert tq.numeric_boundaries == jq.numeric_boundaries == [0]
    assert tcore.ragged_dispatches > 0
    if rows == 6:
        # the 30-token prompt streams over 5 dispatches while the 17-token
        # one already decodes
        assert tcore.ragged_mixed_dispatches > 0
    for name in ("ragged_dispatches", "ragged_rows_total",
                 "ragged_prefill_rows_total", "ragged_decode_rows_total",
                 "ragged_mixed_dispatches", "ragged_dispatches_saved"):
        assert getattr(tcore, name) == getattr(jcore, name), name
    assert tcore.total_prefill_tokens == jcore.total_prefill_tokens == 47
    tm, jm = tcore.metrics(), jcore.metrics()
    for name in ("ragged_fill_ratio", "ragged_mixed_ratio",
                 "ragged_dispatches_saved_total"):
        assert getattr(tm, name) == pytest.approx(getattr(jm, name)), name
    assert tm.ragged_fill_ratio > 0


async def _port_streams(np_params, prompts, max_new, **extra):
    """The port's engine alone (``make_cores``'s torch half) serving
    ``prompts`` concurrently, greedy."""
    cfg = ModelConfig(**GEOM)
    core = EngineCore(cfg, EngineConfig(dtype="float32",
                                        **_engine_kwargs(64, 2, **extra)),
                      params=params_from_numpy(np_params, cfg, "cpu",
                                               torch.float32),
                      device="cpu")
    reqs = [EngineRequest(rid=f"t{i}", prompt=list(p),
                          sampling=SlotSampling(**GREEDY),
                          max_new_tokens=max_new, eos_ids=frozenset())
            for i, p in enumerate(prompts)]
    try:
        out = await asyncio.gather(*(_collect(core, r, FINISH_SENTINEL)
                                     for r in reqs))
    finally:
        await core.stop()
    return [toks for toks, _, _ in out]


@pytest.mark.asyncio
async def test_ragged_streams_invariant_under_row_budget(np_params):
    """Per-row math does not depend on the packing: row budgets 6 and 64
    give the same tokens, and the split-path engine's."""
    prompts = _long_prompts()
    streams = [await _port_streams(np_params, prompts, 24, **RAGGED,
                                   ragged_max_seq_rows=rows)
               for rows in (6, 64)]
    assert streams[0] == streams[1]
    assert await _port_streams(np_params, prompts, 24) == streams[0]


@pytest.mark.asyncio
async def test_ragged_seeded_sampled_streams_match_jax(np_params):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (12, 20, 7)]
    jcore, tcore = make_cores(np_params, 64, 4, **RAGGED,
                              ragged_max_seq_rows=6)
    jout, tout = await run_both(jcore, tcore, prompts, 16, SAMPLED)
    for (jt, _, jq), (tt, _, tq) in zip(jout, tout):
        assert len(tt) == 16 and tt == jt
        assert tq.key_step == jq.key_step == 16
    assert tout[0][0] != tout[1][0]


@pytest.mark.asyncio
async def test_ragged_preemption_streams_match_jax(np_params):
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, 256, size=30).tolist() for _ in range(2)]
    jcore, tcore = make_cores(np_params, 16, 2, **RAGGED)
    jout, tout = await run_both(jcore, tcore, prompts, 40,
                                [SAMPLED[0], GREEDY])
    assert jcore.preemptions > 0 and tcore.preemptions > 0
    for (jt, jr, jq), (tt, tr, tq) in zip(jout, tout):
        assert tr.value == jr.value == "length" and len(tt) == len(jt) == 40
        bounds = [b for r in (jq, tq) for b in r.numeric_boundaries
                  if b > 0]
        first = min(bounds) if bounds else None
        assert tt[:first] == jt[:first]


@pytest.mark.asyncio
async def test_ragged_int4_over_int8_pool_streams_match_jax(np_qparams):
    rng = np.random.default_rng(4)
    prefix = rng.integers(1, 256, size=16).tolist()
    prompts = [prefix + rng.integers(1, 256, size=n).tolist()
               for n in (3, 9, 17, 30)]
    jcore, tcore = make_cores(np_qparams, 64, 4, QGEOM, **QUANT, **RAGGED,
                              ragged_max_seq_rows=8)
    assert tcore.kv["k"].dtype == torch.int8
    jout, tout = await run_both(jcore, tcore, prompts, 16)
    for (jt, jr, _), (tt, tr, _) in zip(jout, tout):
        assert len(tt) == 16 and tr.value == jr.value == "length"
        assert tt == jt
    assert tcore.ragged_mixed_dispatches == jcore.ragged_mixed_dispatches


def _config_outcome(cls, **kw):
    try:
        cfg = cls(**kw)
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return (cfg.ragged_dispatch, cfg.ragged_max_tokens,
            cfg.ragged_max_seq_rows)


@pytest.mark.parametrize("kw", [
    dict(),                                        # auto: 4 + 2*64
    dict(ragged_max_seq_rows=6),
    dict(ragged_max_tokens=20, ragged_max_seq_rows=16),
    dict(ragged_max_tokens=3),                     # below max_num_seqs + 1
    dict(ragged_max_tokens=10, ragged_max_seq_rows=32),  # below one chunk
    dict(ragged_max_seq_rows=0),
    dict(ragged_dispatch=False, ragged_max_tokens=3),
])
def test_ragged_engine_config_matches_jax(kw):
    base = dict(max_model_len=128, kv_block_size=8, num_kv_blocks=32,
                max_num_seqs=4, ragged_dispatch=True)
    assert (_config_outcome(EngineConfig, **{**base, **kw})
            == _config_outcome(JEngineConfig, **{**base, **kw}))


@pytest.mark.parametrize("field", UNPORTED_ENGINE_FIELDS)
def test_ragged_engine_config_refuses_each_unported_field(field):
    jfields = {f.name for f in dataclasses.fields(JEngineConfig)}
    assert field in jfields
    with pytest.raises(TypeError):
        EngineConfig(ragged_dispatch=True, **{field: 1})


def test_ragged_engine_config_keeps_unported_fields_out():
    for kw in ({"tp": 2}, {"pp": 2}):
        with pytest.raises(TypeError):
            EngineConfig(ragged_dispatch=True, **kw)
    # the pipelined ragged dispatch is accepted at K = 1, as in JAX
    kw = dict(ragged_dispatch=True, decode_dispatch_pipeline=True)
    got = _config_outcome(EngineConfig, **kw)
    assert got == _config_outcome(JEngineConfig, **kw)
    assert EngineConfig(**kw).decode_dispatch_pipeline
    # sp is ported (sequence-parallel prefill); ragged refuses it as the
    # JAX package does
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        EngineConfig(ragged_dispatch=True, sp=2)
