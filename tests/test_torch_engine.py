"""The PyTorch port's EngineCore against the JAX package's, on the CPU.

Both engines run the same tiny model (the JAX init, converted with
``params_from_numpy``) in f32 and serve the same greedy requests:

- four concurrent requests sharing a 16-token prefix, 16 tokens each: the
  token streams must be equal;
- two requests under a pool too small for both (the pattern of
  tests/test_preemption.py): both engines must preempt, and each stream
  must equal the other engine's up to the first recompute boundary of
  either. At a preemption the next token is re-derived by a prefill,
  whose f32 sums differ from the decode step's, so a greedy argmax at a
  near-tie may legitimately flip there (the JAX package's own contract);
- the same two schedules with ``quantization="int4"`` and
  ``kv_quantization="int8"`` on both engines (hidden 256, so every layer
  matmul passes the grouped-int4 kernel's shape rule); the JAX side of
  both is one engine, built and compiled once (``jax_quant_streams``),
  whose pool holds the second schedule's two requests: a stream depends
  neither on the batch it rides nor on the pool's size before a recompute,
  so the port's preempted streams must equal those up to the port's first
  recompute boundary;
- seeded sampled requests (temperature 0.7, top_p 0.9) beside a greedy
  one, and under preemption: each engine keys a token by (engine seed,
  request seed, the request's key_step), so the sampled streams are
  equal too.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.core import FINISH_SENTINEL as J_FINISH
from dynamo_tpu.engine.core import EngineCore as JEngineCore
from dynamo_tpu.engine.core import EngineRequest as JEngineRequest
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.sampling import SlotSampling as JSlotSampling
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.core import FINISH_SENTINEL, EngineCore, EngineRequest
from dynamo_tpu_torch.engine.sampling import SlotSampling
from dynamo_tpu_torch.engine.weights import params_from_numpy

pytestmark = pytest.mark.asyncio

GEOM = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position_embeddings=512)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny engines run on one intra-op thread: their ops are too
    small to split, and the suite runs beside other workers (eight threads
    a process oversubscribe the cores there, and the int4 path's CPU ops
    then take tens of times longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    p = jllama.init_params(JModelConfig(**GEOM), jax.random.PRNGKey(0),
                           dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


# the quantized schedules: hidden and MLP widths of 256 (two 128-row
# groups), a 128-wide KV row (an int8 pool row of 256 lanes)
QGEOM = dict(GEOM, hidden_size=256, intermediate_size=256, head_dim=64)
QUANT = dict(quantization="int4", kv_quantization="int8")


@pytest.fixture(scope="module")
def np_qparams():
    p = jllama.init_params(JModelConfig(**QGEOM), jax.random.PRNGKey(1),
                           dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def _engine_kwargs(num_kv_blocks, max_num_seqs, **extra):
    return dict(max_model_len=256, kv_block_size=8,
                num_kv_blocks=num_kv_blocks, max_num_seqs=max_num_seqs,
                prefill_buckets=[32, 64, 128], **extra)


def make_cores(np_params, num_kv_blocks, max_num_seqs, geom=GEOM, **extra):
    jcore = JEngineCore(JModelConfig(**geom),
                        JEngineConfig(**_engine_kwargs(num_kv_blocks,
                                                       max_num_seqs, **extra)),
                        params={k: jnp.asarray(v)
                                for k, v in np_params.items()},
                        attn_impl="xla", param_dtype=jnp.float32)
    return jcore, make_port_core(np_params, num_kv_blocks, max_num_seqs,
                                 geom, **extra)


def make_port_core(np_params, num_kv_blocks, max_num_seqs, geom=GEOM,
                   **extra):
    cfg = ModelConfig(**geom)
    tcore = EngineCore(cfg, EngineConfig(dtype="float32",
                                         **_engine_kwargs(num_kv_blocks,
                                                          max_num_seqs,
                                                          **extra)),
                       params=params_from_numpy(np_params, cfg, "cpu",
                                                torch.float32),
                       device="cpu")
    return tcore


async def _collect(core, req, sentinel):
    await core.submit(req)
    toks = []
    while True:
        item, payload = await asyncio.wait_for(req.out_queue.get(), 60)
        if item is sentinel:
            return toks, payload, req
        toks.append(item)


GREEDY = dict(temperature=0.0)


async def serve_all(core, prompts, max_new, sampling=None):
    """Serve ``prompts`` concurrently on ``core`` (a JAX or a port engine);
    ``sampling[i]`` is request i's ``SlotSampling`` fields (default:
    greedy)."""
    sampling = sampling or [GREEDY] * len(prompts)
    if isinstance(core, JEngineCore):
        reqs = [JEngineRequest(rid=f"j{i}", prompt=list(p),
                               sampling=JSlotSampling(**sampling[i]),
                               max_new_tokens=max_new, eos_ids=frozenset())
                for i, p in enumerate(prompts)]
        sentinel = J_FINISH
    else:
        reqs = [EngineRequest(rid=f"t{i}", prompt=list(p),
                              sampling=SlotSampling(**sampling[i]),
                              max_new_tokens=max_new, eos_ids=frozenset())
                for i, p in enumerate(prompts)]
        sentinel = FINISH_SENTINEL
    return await asyncio.gather(*(_collect(core, r, sentinel)
                                  for r in reqs))


async def run_both(jcore, tcore, prompts, max_new, sampling=None):
    """Serve ``prompts`` concurrently on each engine, then stop both."""
    try:
        jout = await serve_all(jcore, prompts, max_new, sampling)
        tout = await serve_all(tcore, prompts, max_new, sampling)
    finally:
        await jcore.stop()
        await tcore.stop()
    return jout, tout


async def test_concurrent_greedy_streams_match_jax(np_params):
    rng = np.random.default_rng(3)
    prefix = rng.integers(1, 256, size=16).tolist()
    prompts = [prefix + rng.integers(1, 256, size=n).tolist()
               for n in (3, 9, 17, 30)]
    jcore, tcore = make_cores(np_params, num_kv_blocks=64, max_num_seqs=4)
    jout, tout = await run_both(jcore, tcore, prompts, max_new=16)
    for (jt, jr, _), (tt, tr, _) in zip(jout, tout):
        assert len(tt) == 16 and tr.value == "length"
        assert tt == jt
        assert jr.value == tr.value
    # the shared prefix was reused from the pool, as in the JAX engine
    assert tcore.kv_manager.pool.match_hits > 0
    assert (tcore.kv_manager.pool.match_hits
            == jcore.kv_manager.pool.match_hits)
    m = tcore.metrics()
    assert m.prefill_tokens_total == jcore.total_prefill_tokens
    assert m.decode_tokens_total == jcore.total_decode_tokens == 4 * 15
    assert m.request_active_slots == 0 and m.request_total_slots == 4
    assert m.kv_total_blocks == 63 and m.gpu_prefix_cache_hit_rate > 0


def _first_boundary(*reqs):
    bounds = [b for r in reqs for b in r.numeric_boundaries]
    return min(bounds) if bounds else None   # None: the whole stream


async def test_preemption_streams_match_jax(np_params):
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, 256, size=30).tolist() for _ in range(2)]
    max_new = 40
    # room for either sequence alone (~9 blocks each) but not both at full
    # length: forced recompute preemption
    jcore, tcore = make_cores(np_params, num_kv_blocks=16, max_num_seqs=2)
    jout, tout = await run_both(jcore, tcore, prompts, max_new)
    assert jcore.preemptions > 0 and tcore.preemptions > 0
    for (jt, jr, jq), (tt, tr, tq) in zip(jout, tout):
        assert tr.value == "length" and len(tt) == max_new
        assert jr.value == tr.value and len(jt) == len(tt)
        # a request preempted by neither engine must match in full
        boundary = _first_boundary(jq, tq)
        assert tt[:boundary] == jt[:boundary]


def _quant_prompts():
    """The quantized schedules' prompts: four sharing a 16-token prefix,
    and two of 30 tokens for the preemption."""
    rng = np.random.default_rng(4)
    prefix = rng.integers(1, 256, size=16).tolist()
    shared = [prefix + rng.integers(1, 256, size=n).tolist()
              for n in (3, 9, 17, 30)]
    rng = np.random.default_rng(24)
    return shared, [rng.integers(1, 256, size=30).tolist() for _ in range(2)]


@pytest.fixture(scope="module")
def jax_quant_streams(np_qparams):
    """The JAX engine's int4 + int8-KV runs of both quantized schedules,
    on ONE engine (64 blocks, 4 slots; its programs compiled once): the
    four prefix-sharing prompts together (16 tokens), with its prefix hits
    after them, then the two 30-token prompts together (40 tokens; the
    pool holds both, so nothing preempts). Shared by the two quantized
    cases."""
    cache = {}

    async def get():
        if not cache:
            jcore = make_cores(np_qparams, 64, 4, QGEOM, **QUANT)[0]
            shared, preempted = _quant_prompts()
            try:
                cache["shared"] = await serve_all(jcore, shared, 16)
                cache["match_hits"] = jcore.kv_manager.pool.match_hits
                cache["preempted"] = await serve_all(jcore, preempted, 40)
                cache["preemptions"] = jcore.preemptions
            finally:
                await jcore.stop()
        return cache
    return get


async def test_quantized_concurrent_greedy_streams_match_jax(
        np_qparams, jax_quant_streams):
    ref = await jax_quant_streams()
    tcore = make_port_core(np_qparams, 64, 4, QGEOM, **QUANT)
    assert tcore.kv["k"].dtype == torch.int8
    try:
        tout = await serve_all(tcore, _quant_prompts()[0], 16)
    finally:
        await tcore.stop()
    for (jt, jr, _), (tt, tr, _) in zip(ref["shared"], tout):
        assert len(tt) == 16 and tr.value == jr.value == "length"
        assert tt == jt
    assert tcore.kv_manager.pool.match_hits == ref["match_hits"] > 0


async def test_quantized_preemption_streams_match_jax(np_qparams,
                                                      jax_quant_streams):
    ref = await jax_quant_streams()
    tcore = make_port_core(np_qparams, 16, 2, QGEOM, **QUANT)
    try:
        tout = await serve_all(tcore, _quant_prompts()[1], 40)
    finally:
        await tcore.stop()
    assert tcore.preemptions > 0 and ref["preemptions"] == 0
    for (jt, jr, _), (tt, tr, tq) in zip(ref["preempted"], tout):
        assert tr.value == jr.value == "length" and len(tt) == len(jt) == 40
        boundary = _first_boundary(tq)
        assert tt[:boundary] == jt[:boundary]


SAMPLED = [dict(temperature=0.7, top_p=0.9, seed=11),
           dict(temperature=0.7, top_p=0.9, seed=12), GREEDY]


async def test_seeded_sampled_streams_match_jax(np_params):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (12, 20, 7)]
    jcore, tcore = make_cores(np_params, 64, 4)
    jout, tout = await run_both(jcore, tcore, prompts, 16, SAMPLED)
    for (jt, _, _), (tt, _, treq) in zip(jout, tout):
        assert len(tt) == 16 and tt == jt
        assert treq.key_step == 16
    # the two seeds draw different streams on the same model
    assert tout[0][0] != tout[1][0]


async def test_seeded_sampled_streams_match_jax_under_preemption(np_params):
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, 256, size=30).tolist() for _ in range(2)]
    jcore, tcore = make_cores(np_params, 16, 2)
    jout, tout = await run_both(jcore, tcore, prompts, 40, SAMPLED[:2])
    assert jcore.preemptions > 0 and tcore.preemptions > 0
    for (jt, _, jq), (tt, _, tq) in zip(jout, tout):
        assert len(tt) == len(jt) == 40
        # key_step runs on across the preemption, as in the JAX engine
        assert tq.key_step == jq.key_step == 40
        assert tt == jt
