"""The port's pipelined ragged engine against the JAX package's, on the CPU.

Both engines run ``ragged_dispatch=True, decode_dispatch_pipeline=True`` at
K = 1 over the same tiny model (the JAX init, converted with
``params_from_numpy``) in f32. A pure-decode dispatch defers its harvest
and the next dispatch chains off its device tokens (the chained-sample
merge); any churn drains the pipeline first. On the CPU the port's ragged
program runs eagerly at its row bucket, dead rows included. The cases:

- greedy streams of prompts longer than the row budget, at row budgets 6
  and 64;
- seeded sampled streams (temperature 0.7, top_p 0.9) beside a greedy one;
- recompute preemption under a small pool: the streams agree up to the
  first recompute boundary of either engine (a re-admission's sums differ
  from the ragged program's, the JAX package's own contract);
- int4 weights over an int8 pool (hidden 256);
- the MLA rank-128 geometry of ``tests/test_torch_mla.py`` over an f32 and
  an int8 latent pool;
- two prompts posted back to back, with the first token's fetch deferred
  and fetched at once;
- a request cancelled at the harvest of a dispatch while the next one,
  chained, is in flight: the chained dispatch's row of it is discarded.

Every case holds the streams equal to JAX's token for token, and the
ragged counters, ``host_roundtrips`` and the number of chained dispatches
(JAX's flight records marked ``chained``) equal to JAX's, with some
dispatch chained; the port's pipelined streams also equal its own
unpipelined ones (JAX's ``tests/test_ragged_attention.py``
``test_engine_ragged_pipelined_dispatch``).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.core import EngineCore as JEngineCore
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.engine.weights import params_from_numpy
from tests.test_torch_dispatch import SEEDED, Side, _requests
from tests.test_torch_engine import GEOM, QGEOM, QUANT
from tests.test_torch_mla import ENGINE as MLA_ENGINE
from tests.test_torch_mla import GEOM as MLA_GEOM
from tests.test_torch_mla import _np_params as mla_np_params

PIPELINED = dict(ragged_dispatch=True, decode_dispatch_pipeline=True)
BASE = dict(max_model_len=256, kv_block_size=8, num_kv_blocks=64,
            max_num_seqs=4, prefill_buckets=[32, 64, 128])
COUNTERS = ("ragged_dispatches", "ragged_rows_total",
            "ragged_prefill_rows_total", "ragged_decode_rows_total",
            "ragged_mixed_dispatches", "ragged_dispatches_saved",
            "host_roundtrips", "total_prefill_tokens", "total_decode_tokens")


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


def _llama_params(geom, seed):
    p = jllama.init_params(JModelConfig(**geom), jax.random.PRNGKey(seed),
                           dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def np_params():
    return _llama_params(GEOM, 0)


def _cores(np_params, geom, **kw):
    jcore = JEngineCore(JModelConfig(**geom), JEngineConfig(**kw),
                        params={k: jnp.asarray(v)
                                for k, v in np_params.items()},
                        attn_impl="xla", param_dtype=jnp.float32)
    return jcore, _port_core(np_params, geom, **kw)


def _port_core(np_params, geom, **kw):
    cfg = ModelConfig(**geom)
    return EngineCore(cfg, EngineConfig(dtype="float32", **kw),
                      params=params_from_numpy(np_params, cfg, "cpu",
                                               torch.float32),
                      device="cpu")


def _prompt(seed, n, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, size=n).tolist()


async def _concurrent(side, prompts, max_new, sampling=None):
    sampling = sampling or [None] * len(prompts)
    reqs = [await side.submit(p, f"r{i}", max_new=max_new,
                              sampling=sampling[i])
            for i, p in enumerate(prompts)]
    return await asyncio.gather(*(side.drain(r) for r in reqs))


async def _serve(core, jax_side, scenario):
    try:
        return await scenario(Side(core, jax_side))
    finally:
        await core.stop()


def _jax_chained(jcore) -> int:
    return sum(1 for r in jcore.flight.dump()
               if r["kind"] == "ragged" and r.get("chained"))


async def _check_case(np_params, geom, scenario, boundary=False, **kw):
    """Run ``scenario`` on the JAX and the port's pipelined engines and on
    the port's unpipelined one; return the three results after the common
    checks."""
    kw = {**PIPELINED, **kw}
    jcore, tcore = _cores(np_params, geom, **kw)
    jout = await _serve(jcore, True, scenario)
    tout = await _serve(tcore, False, scenario)
    plain = _port_core(np_params, geom,
                       **{**kw, "decode_dispatch_pipeline": False})
    pout = await _serve(plain, False, scenario)
    for (jt, jr, jq), (tt, tr, tq), (pt, _, _) in zip(jout, tout, pout):
        if boundary:
            bounds = [b for r in (jq, tq) for b in r.numeric_boundaries
                      if b > 0]
            first = min(bounds) if bounds else None
            assert tt[:first] == jt[:first]
            assert pt[:first] == tt[:first]
        else:
            assert tt == jt and pt == tt
        assert tr.value == jr.value
    for name in COUNTERS:
        assert getattr(tcore, name) == getattr(jcore, name), name
    assert tcore.ragged_chained_dispatches == _jax_chained(jcore) > 0
    assert plain.ragged_chained_dispatches == 0
    assert tcore._ragged_pending is None and not tcore._admissions
    return jout, tout, tcore


@pytest.mark.asyncio
@pytest.mark.parametrize("rows", [6, 64])
async def test_pipelined_ragged_greedy_streams_match_jax(np_params, rows):
    prompts = [_prompt(23, 30), _prompt(24, 17)]
    _, tout, tcore = await _check_case(
        np_params, GEOM,
        lambda side: _concurrent(side, prompts, 24),
        ragged_max_seq_rows=rows, **dict(BASE, max_num_seqs=2))
    assert all(len(t) == 24 for t, _, _ in tout)
    if rows == 6:
        assert tcore.ragged_mixed_dispatches > 0


@pytest.mark.asyncio
async def test_pipelined_ragged_seeded_streams_match_jax(np_params):
    prompts = [_prompt(5, n) for n in (12, 20, 7)]
    _, tout, _ = await _check_case(
        np_params, GEOM,
        lambda side: _concurrent(side, prompts, 16,
                                 [SEEDED, dict(SEEDED, seed=12), None]),
        ragged_max_seq_rows=6, **BASE)
    assert all(len(t) == 16 for t, _, _ in tout)
    assert tout[0][0] != tout[1][0]
    assert [q.key_step for _, _, q in tout] == [16, 16, 16]


@pytest.mark.asyncio
async def test_pipelined_ragged_preemption_streams_match_jax(np_params):
    prompts = [_prompt(23, 30), _prompt(25, 30)]
    _, tout, tcore = await _check_case(
        np_params, GEOM,
        lambda side: _concurrent(side, prompts, 40, [SEEDED, None]),
        boundary=True, **dict(BASE, num_kv_blocks=16, max_num_seqs=2))
    assert tcore.preemptions > 0
    assert all(len(t) == 40 for t, _, _ in tout)


@pytest.mark.asyncio
async def test_pipelined_ragged_int4_over_int8_pool_match_jax():
    np_q = _llama_params(QGEOM, 1)
    prefix = _prompt(4, 16)
    prompts = [prefix + _prompt(40 + n, n) for n in (3, 9, 17, 30)]
    _, tout, tcore = await _check_case(
        np_q, QGEOM, lambda side: _concurrent(side, prompts, 16),
        ragged_max_seq_rows=8, **QUANT, **BASE)
    assert tcore.kv["k"].dtype == torch.int8
    assert all(len(t) == 16 for t, _, _ in tout)


@pytest.mark.asyncio
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
async def test_pipelined_ragged_mla_streams_match_jax(kv_quant):
    np_m = mla_np_params(MLA_GEOM, 1)
    pa, pb = _prompt(41, 25), _prompt(43, 21)
    _, tout, tcore = await _check_case(
        np_m, MLA_GEOM,
        lambda side: _concurrent(side, [pa, pb], 16, [None, SEEDED]),
        ragged_max_seq_rows=8, kv_quantization=kv_quant, **MLA_ENGINE)
    assert tcore.kv["kv"].dtype == (torch.int8 if kv_quant == "int8"
                                    else torch.float32)
    assert all(len(t) == 16 for t, _, _ in tout)


@pytest.mark.asyncio
@pytest.mark.parametrize("overlap", [True, False],
                         ids=["deferred_fetch", "fetch_at_once"])
async def test_pipelined_ragged_back_to_back_admissions_match_jax(
        np_params, overlap):
    pa, pb = _prompt(41, 25), _prompt(43, 21)
    _, tout, tcore = await _check_case(
        np_params, GEOM,
        lambda side: _concurrent(side, [pa, pb], 16, [None, SEEDED]),
        ragged_max_seq_rows=8, overlap_admission_fetch=overlap, **BASE)
    # every ragged admission rides the batch as a prefill lane
    assert tcore.lane_admissions == 2


class _StopAfter:
    """A request context whose client stops once the request has
    generated ``n`` tokens."""

    def __init__(self, n: int):
        self.n, self.req = n, None

    @property
    def is_stopped(self) -> bool:
        return self.req is not None and self.req.generated >= self.n


@pytest.mark.asyncio
async def test_pipelined_ragged_cancel_with_a_chained_dispatch_in_flight(
        np_params):
    prompts = [_prompt(51, 9), _prompt(52, 11)]

    async def scenario(side):
        reqs = [_requests(side.jax_side, p, f"r{i}", 20)
                for i, p in enumerate(prompts)]
        reqs[0].ctx = _StopAfter(6)
        reqs[0].ctx.req = reqs[0]
        for r in reqs:
            await side.core.submit(r)
        return await asyncio.gather(*(side.drain(r) for r in reqs))

    jout, tout, tcore = await _check_case(np_params, GEOM, scenario,
                                          ragged_max_seq_rows=16, **BASE)
    (t0, r0, _), (t1, r1, _) = tout
    assert len(t0) == 6 and r0.value == "cancelled"
    assert len(t1) == 20 and r1.value == "length"
    assert tcore.requests_cancelled_total == 1
