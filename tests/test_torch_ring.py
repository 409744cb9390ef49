"""The port's sequence-parallel prefill against the JAX package's, on the CPU.

The JAX side runs on the virtual 8-device CPU mesh of ``tests/conftest.py``
(``make_mesh(sp=n)`` needs n devices); the port's mesh places its n shards
on the one CPU (``make_mesh(sp=n, devices=["cpu"] * n)``). Inputs come from
numpy with a seed and everything runs in f32. Each test states its
tolerance:

- (a) ``flash_prefill_partial_ref`` (K2's plain version) against JAX's
  ``flash_prefill_partial`` in interpret mode: acc, m and l for start 0, a
  negative start (live and dead rows in one query chunk), a fully dead hop,
  a zero seq_len and a clipped seq_len; atol=rtol=1e-5 on acc and l,
  2e-6/1e-5 on m, and dead rows exactly (0, NEG_INF, 0);
- (b) the port's ``ring_attention`` at sp 2, 4 and 8, with and without
  kv_len, against JAX's ring with the flash hop body (interpret) and the
  dense one, at JAX's own tolerance (atol=2e-6, rtol=1e-5,
  tests/test_ring_attention.py);
- (c) ``llama.prefill_forward_sp`` against JAX's at sp 2 and 4: logits and
  pool rows at atol=5e-5, rtol=1e-4 (tests/test_ring_attention.py) over an
  f32 pool; over an int8 pool the dequantized rows differ by at most one
  quantization step of their row;
- (d) greedy and seeded-sampled engine streams of the port's EngineCore
  over an sp=2 mesh against JAX's, equal, with the port's sp entry point
  counted so that the test cannot pass through the plain prefill;
- (e) the refusals (ragged dispatch with sp, a mesh and config that
  disagree, tp/dp/ep, too few cards) and the fall-throughs to the plain
  prefill (prefix hit, short prompt, a bucket sp does not divide, a
  sliding-window model).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.attention import \
    flash_prefill_partial as jflash_prefill_partial
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.core import FINISH_SENTINEL as J_FINISH
from dynamo_tpu.engine.core import EngineCore as JEngineCore
from dynamo_tpu.engine.core import EngineRequest as JEngineRequest
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.sampling import SlotSampling as JSlotSampling
from dynamo_tpu.parallel.ring_attention import ring_attention as jring
from dynamo_tpu.parallel.sharding import make_mesh as jmake_mesh
from dynamo_tpu_torch.engine.attention import (NEG_INF, _decode_scale,
                                               dequant_kv_rows,
                                               flash_prefill_partial_ref,
                                               kv_value_lanes)
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.core import FINISH_SENTINEL, EngineCore, EngineRequest
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.sampling import SlotSampling
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.parallel.ring_attention import ring_attention
from dynamo_tpu_torch.parallel.sharding import make_mesh


def _cpu_mesh(n):
    return make_mesh(sp=n, devices=["cpu"] * n)


# ---------------------------------------------------------------------------
# (a) K2's plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    T, H, KVH, Dh = 32, 8, 4, 16
    return (rng.standard_normal((T, H, Dh)).astype(np.float32),
            rng.standard_normal((T, KVH, Dh)).astype(np.float32),
            rng.standard_normal((T, KVH, Dh)).astype(np.float32))


@pytest.mark.parametrize("start_pos,seq_len", [
    (0, 32),       # the diagonal hop
    (-10, 32),     # rows 0-9 see nothing, in one query chunk with live rows
    (-32, 32),     # a dead hop: the KV chunk lies after every query
    (0, 0),        # zero seq_len: a chunk past the valid prefix
    (16, 20),      # clipped seq_len: the padded tail
])
def test_partial_plain_matches_jax_kernel(qkv, start_pos, seq_len):
    q, k, v = qkv
    scale = q.shape[-1] ** -0.5
    want = jflash_prefill_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        start_pos=jnp.asarray(start_pos), seq_len=jnp.asarray(seq_len),
        q_chunk=16, kv_chunk=16, interpret=True)
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in flash_prefill_partial_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=scale, start_pos=start_pos, seq_len=seq_len)]
    for name, g, w in zip(("acc", "m", "l"), got, want):
        assert g.shape == w.shape, name
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=1e-5)
    dead = start_pos + np.arange(q.shape[0]) < 0 if seq_len else \
        np.ones(q.shape[0], bool)
    assert (got[0][dead] == 0).all() and (got[2][dead] == 0).all()
    assert (got[1][dead] == np.float32(NEG_INF)).all()
    assert (want[1][dead] == got[1][dead]).all()


# ---------------------------------------------------------------------------
# (b) the ring
# ---------------------------------------------------------------------------

def _port_ring(q, k, v, n, kv_len):
    out = ring_attention([torch.from_numpy(x) for x in np.split(q, n)],
                         [torch.from_numpy(x) for x in np.split(k, n)],
                         [torch.from_numpy(x) for x in np.split(v, n)],
                         _cpu_mesh(n), scale=q.shape[-1] ** -0.5,
                         kv_len=kv_len)
    assert [o.shape[0] for o in out] == [q.shape[0] // n] * n
    return torch.cat(out).numpy()


@pytest.mark.parametrize("kv_len", [None, 25])
@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("impl", ["flash_interpret", "dense"])
def test_ring_matches_jax_ring(qkv, sp, kv_len, impl):
    q, k, v = qkv
    want = jring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 jmake_mesh(sp=sp), scale=q.shape[-1] ** -0.5,
                 kv_len=None if kv_len is None else jnp.asarray(kv_len),
                 impl=impl)
    got = _port_ring(q, k, v, sp, kv_len)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# (c) the sequence-parallel prefill of the llama model
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position_embeddings=256)
BS, NUM_BLOCKS, T_SP, TRUE_LEN = 8, 16, 64, 53


@pytest.fixture(scope="module")
def tiny_params():
    p = jllama.init_params(JModelConfig(**TINY), jax.random.PRNGKey(0),
                           dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def _sp_inputs():
    rng = np.random.default_rng(1)
    return (rng.integers(0, 128, T_SP).astype(np.int32),
            np.arange(1, 9, dtype=np.int32))


def _dequant(rows: np.ndarray, C: int) -> tuple:
    """(values, per-row quantization step = the row's scale) of int8 pool
    rows."""
    t = torch.from_numpy(np.array(rows))
    step = _decode_scale(t[..., C], t[..., C + 1])
    return dequant_kv_rows(t, C, torch.float32).numpy(), step[..., None].numpy()


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("sp", [2, 4])
def test_prefill_forward_sp_matches_jax(tiny_params, sp, kv_quant):
    tokens, table = _sp_inputs()
    jcfg = JModelConfig(**TINY)
    statics = jllama.ModelStatics(cfg=jcfg, block_size=BS, attn_impl="xla")
    mesh = jmake_mesh(sp=sp)
    jkv = jllama.init_kv_cache(jcfg, NUM_BLOCKS, BS, dtype=jnp.float32,
                               quantization=kv_quant)
    jlogits, jkv = jax.jit(lambda p, kv, t, bt, tl: jllama.prefill_forward_sp(
        p, kv, t, bt, tl, statics, mesh))(
        {k: jnp.asarray(v) for k, v in tiny_params.items()}, jkv,
        jnp.asarray(tokens), jnp.asarray(table), jnp.asarray(TRUE_LEN))

    cfg = ModelConfig(**TINY)
    params = params_from_numpy(tiny_params, cfg, "cpu", torch.float32)
    kv = tllama.init_kv_cache(cfg, NUM_BLOCKS, BS, "cpu", torch.float32,
                              quantization=kv_quant)
    with torch.inference_mode():
        logits = tllama.prefill_forward_sp(
            params, kv, torch.from_numpy(tokens.astype(np.int64)),
            torch.from_numpy(table), TRUE_LEN, cfg, BS, _cpu_mesh(sp))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=5e-5, rtol=1e-4)
    for name in ("k", "v"):
        got, want = kv[name].numpy()[:, BS:], np.asarray(jkv[name])[:, BS:]
        if kv_quant == "none":
            np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
            continue
        C = kv_value_lanes(kv[name])
        gv, gs = _dequant(got, C)
        wv, ws = _dequant(want, C)
        # at most one quantization step of the row (its scale), plus f32
        # rounding of the dequantized values
        step = np.maximum(gs, ws)
        assert (np.abs(gv - wv) <= step * (1 + 1e-5) + 1e-6).all()
    # the prompt's rows were written and nothing past its blocks
    assert np.abs(kv["k"].float().numpy()[:, BS:BS + TRUE_LEN]).max() > 0
    assert np.abs(kv["k"].float().numpy()[:, 9 * BS:]).max() == 0


def test_prefill_forward_sp_matches_whole_prompt_prefill(tiny_params):
    """The ring prefill and the whole-prompt prefill compute one function:
    logits and pool rows at atol=5e-5, rtol=1e-4 (f32)."""
    tokens, table = _sp_inputs()
    cfg = ModelConfig(**TINY)
    params = params_from_numpy(tiny_params, cfg, "cpu", torch.float32)
    kvs = [tllama.init_kv_cache(cfg, NUM_BLOCKS, BS, "cpu", torch.float32)
           for _ in range(2)]
    t = torch.from_numpy(tokens.astype(np.int64))
    bt = torch.from_numpy(table)
    with torch.inference_mode():
        ref = tllama.prefill_forward(params, kvs[0], t, bt, 0, TRUE_LEN, cfg,
                                     BS)
        got = tllama.prefill_forward_sp(params, kvs[1], t, bt, TRUE_LEN, cfg,
                                        BS, _cpu_mesh(4))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(kvs[1]["k"][:, BS:].numpy(),
                               kvs[0]["k"][:, BS:].numpy(), atol=5e-5,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# (d) engine streams
# ---------------------------------------------------------------------------

GEOM = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position_embeddings=512)


@pytest.fixture(scope="module")
def np_params():
    p = jllama.init_params(JModelConfig(**GEOM), jax.random.PRNGKey(0),
                           dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def _engine_kwargs(**extra):
    return dict(max_model_len=256, kv_block_size=8, num_kv_blocks=64,
                max_num_seqs=4, prefill_buckets=[32, 64, 128],
                sp_min_prefill_tokens=16, **extra)


def _count(monkeypatch, name):
    """Count the port engine's calls of ``llama.<name>`` (the engine's
    model module for a llama-family model), by true_len."""
    calls = []
    orig = getattr(tllama, name)

    def counted(*a, **kw):
        calls.append(a[4] if name == "prefill_forward_sp" else a[5])
        return orig(*a, **kw)
    monkeypatch.setattr(tllama, name, counted)
    return calls


async def _collect(core, req, sentinel):
    await core.submit(req)
    toks = []
    while True:
        item, payload = await asyncio.wait_for(req.out_queue.get(), 120)
        if item is sentinel:
            return toks
        toks.append(item)


async def _serve_port(core, prompts, sampling, max_new):
    reqs = [EngineRequest(rid=f"t{i}", prompt=list(p),
                          sampling=SlotSampling(**sampling[i]),
                          max_new_tokens=max_new, eos_ids=frozenset())
            for i, p in enumerate(prompts)]
    try:
        return await asyncio.gather(*(_collect(core, r, FINISH_SENTINEL)
                                      for r in reqs))
    finally:
        await core.stop()


SAMPLING = [dict(temperature=0.0), dict(temperature=0.7, top_p=0.9, seed=11),
            dict(temperature=0.0)]


@pytest.mark.asyncio
@pytest.mark.parametrize("extra", [{}, {"kv_quantization": "int8"}])
async def test_sp_engine_streams_match_jax(np_params, monkeypatch, extra):
    rng = np.random.default_rng(7)
    # two long cold prompts (sp), one below sp_min_prefill_tokens (plain)
    prompts = [rng.integers(2, 250, size=n).tolist() for n in (41, 30, 9)]
    max_new = 10
    jcore = JEngineCore(JModelConfig(**GEOM),
                        JEngineConfig(**_engine_kwargs(sp=2, **extra)),
                        params={k: jnp.asarray(v)
                                for k, v in np_params.items()},
                        attn_impl="xla", param_dtype=jnp.float32,
                        mesh=jmake_mesh(sp=2))
    jsp = []
    orig = jcore._prefill_sp_jit
    jcore._prefill_sp_jit = lambda *a, **kw: (jsp.append(1),
                                              orig(*a, **kw))[1]
    jreqs = [JEngineRequest(rid=f"j{i}", prompt=list(p),
                            sampling=JSlotSampling(**SAMPLING[i]),
                            max_new_tokens=max_new, eos_ids=frozenset())
             for i, p in enumerate(prompts)]
    try:
        want = await asyncio.gather(*(_collect(jcore, r, J_FINISH)
                                      for r in jreqs))
    finally:
        await jcore.stop()

    cfg = ModelConfig(**GEOM)
    core = EngineCore(cfg, EngineConfig(dtype="float32",
                                        **_engine_kwargs(sp=2, **extra)),
                      params=params_from_numpy(np_params, cfg, "cpu",
                                               torch.float32),
                      device="cpu", mesh=_cpu_mesh(2))
    sp_calls = _count(monkeypatch, "prefill_forward_sp")
    plain_calls = _count(monkeypatch, "prefill_forward")
    got = await _serve_port(core, prompts, SAMPLING, max_new)
    assert sorted(sp_calls) == [30, 41] and plain_calls == [9]
    assert len(jsp) == 2
    assert all(len(g) == max_new for g in got)
    assert got == want


# ---------------------------------------------------------------------------
# (e) refusals and fall-throughs
# ---------------------------------------------------------------------------

def test_ragged_with_sp_refused_as_in_jax():
    kw = dict(max_model_len=128, kv_block_size=8, num_kv_blocks=32,
              max_num_seqs=4, ragged_dispatch=True, sp=2)
    with pytest.raises(NotImplementedError) as want:
        JEngineConfig(**kw)
    with pytest.raises(NotImplementedError) as got:
        EngineConfig(**kw)
    assert str(got.value) == str(want.value)
    # a ragged config without sp, over an sp mesh: the mesh's sp is checked
    kw.pop("sp")
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        EngineCore(ModelConfig(**GEOM), EngineConfig(**kw), device="cpu",
                   mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="sp=4"):
        EngineCore(ModelConfig(**GEOM),
                   EngineConfig(max_model_len=128, num_kv_blocks=32, sp=4),
                   device="cpu", mesh=_cpu_mesh(2))


def test_make_mesh_refusals():
    for kw in ({"tp": 2}, {"dp": 2}, {"ep": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            make_mesh(sp=2, devices=["cpu"] * 2, **kw)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="CUDA devices"):
        make_mesh(sp=have + 1)
    with pytest.raises(ValueError):
        make_mesh(sp=3, devices=["cpu"] * 2)
    mesh = make_mesh(sp=4, devices=["cpu"] * 4)
    assert mesh.shape == {"dp": 1, "tp": 1, "sp": 4, "ep": 1}
    assert len(mesh.devices) == 4 and len(mesh.distinct_devices) == 1


@pytest.mark.asyncio
@pytest.mark.parametrize("case", ["prefix_hit", "short", "indivisible",
                                  "sliding_window"])
async def test_sp_fall_throughs_take_the_plain_prefill(np_params, monkeypatch,
                                                       case):
    rng = np.random.default_rng(9)
    base = rng.integers(2, 250, size=40).tolist()
    geom, sp, prompts = dict(GEOM), 2, [base]
    if case == "prefix_hit":
        # the second request shares the first's 5 full blocks: a hit
        prompts = [base, base + rng.integers(2, 250, size=6).tolist()]
        want_sp, want_plain = [40], [6]
    elif case == "short":
        prompts = [base[:12]]
        want_sp, want_plain = [], [12]
    elif case == "indivisible":
        sp = 3                       # no bucket (32, 64, 128, 256) divides
        want_sp, want_plain = [], [40]
    else:
        geom["sliding_window"] = 16
        want_sp, want_plain = [], [40]
    cfg = ModelConfig(**geom)
    core = EngineCore(cfg, EngineConfig(dtype="float32",
                                        **_engine_kwargs(sp=sp)),
                      params=params_from_numpy(np_params, cfg, "cpu",
                                               torch.float32),
                      device="cpu", mesh=_cpu_mesh(sp))
    sp_calls = _count(monkeypatch, "prefill_forward_sp")
    plain_calls = _count(monkeypatch, "prefill_forward")
    for p in prompts:   # one after the other: the second may hit the first
        out = await _serve_port(core, [p], [dict(temperature=0.0)], 3)
        assert len(out[0]) == 3
    assert sp_calls == want_sp and plain_calls == want_plain


def test_launcher_sp_flag_builds_a_cpu_mesh(tmp_path):
    import json
    from dynamo_tpu_torch.launch import run as launcher
    (tmp_path / "config.json").write_text(json.dumps(
        {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
         "num_hidden_layers": 1, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 16,
         "max_position_embeddings": 512}))
    argv = ["--model-path", str(tmp_path), "--random-weights", "--device",
            "cpu", "--max-model-len", "128", "--num-kv-blocks", "16"]
    core = launcher.build_core(launcher.build_parser().parse_args(
        argv + ["--sp", "2"]))
    assert core.cfg.sp == 2 and core.mesh.shape["sp"] == 2
    assert [d.type for d in core.mesh.devices] == ["cpu", "cpu"]
    assert launcher.build_core(
        launcher.build_parser().parse_args(argv)).mesh is None
    with pytest.raises(SystemExit, match="sequence-parallel"):
        launcher.build_core(launcher.build_parser().parse_args(
            argv + ["--sequence-parallel-size", "2", "--ragged"]))
