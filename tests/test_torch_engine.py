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
  near-tie may legitimately flip there (the JAX package's own contract).
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


@pytest.fixture(scope="module")
def np_params():
    p = jllama.init_params(JModelConfig(**GEOM), jax.random.PRNGKey(0),
                           dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def _engine_kwargs(num_kv_blocks, max_num_seqs):
    return dict(max_model_len=256, kv_block_size=8,
                num_kv_blocks=num_kv_blocks, max_num_seqs=max_num_seqs,
                prefill_buckets=[32, 64, 128])


def make_cores(np_params, num_kv_blocks, max_num_seqs):
    jcore = JEngineCore(JModelConfig(**GEOM),
                        JEngineConfig(**_engine_kwargs(num_kv_blocks,
                                                       max_num_seqs)),
                        params={k: jnp.asarray(v)
                                for k, v in np_params.items()},
                        attn_impl="xla", param_dtype=jnp.float32)
    cfg = ModelConfig(**GEOM)
    tcore = EngineCore(cfg, EngineConfig(dtype="float32",
                                         **_engine_kwargs(num_kv_blocks,
                                                          max_num_seqs)),
                       params=params_from_numpy(np_params, cfg, "cpu",
                                                torch.float32),
                       device="cpu")
    return jcore, tcore


async def _collect(core, req, sentinel):
    await core.submit(req)
    toks = []
    while True:
        item, payload = await asyncio.wait_for(req.out_queue.get(), 60)
        if item is sentinel:
            return toks, payload, req
        toks.append(item)


async def run_both(jcore, tcore, prompts, max_new):
    """Serve ``prompts`` concurrently on each engine (greedy)."""
    jreqs = [JEngineRequest(rid=f"j{i}", prompt=list(p),
                            sampling=JSlotSampling(temperature=0.0),
                            max_new_tokens=max_new, eos_ids=frozenset())
             for i, p in enumerate(prompts)]
    treqs = [EngineRequest(rid=f"t{i}", prompt=list(p),
                           sampling=SlotSampling(temperature=0.0),
                           max_new_tokens=max_new, eos_ids=frozenset())
             for i, p in enumerate(prompts)]
    try:
        jout = await asyncio.gather(*(_collect(jcore, r, J_FINISH)
                                      for r in jreqs))
        tout = await asyncio.gather(*(_collect(tcore, r, FINISH_SENTINEL)
                                      for r in treqs))
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
