"""The port's ragged program (``engine/programs.py``) on the CPU.

A tiny f32 llama and its pool; the program's inputs come from
``build_ragged_batch`` as the engine packs them, over 4 slots:

- the bucketed eager run (``RaggedProgram.run_eager``: ``max_num_seqs``
  rows for a pure-decode batch, ``ragged_max_tokens`` rows for a mixed one,
  dead rows included) equals the family's ``ragged_forward`` over the used
  rows alone, as the port ran it before it had buckets: the live slots'
  logits within 1e-5 (the same f32 arithmetic; the CPU's matmuls may sum
  in another order at another row count) and their greedy tokens equal,
  and so are the pool rows they write;
- dead rows write only block 0, and no live row reads it: randomizing
  block 0 before the run changes no live slot's logits;
- device-keyed samples (``make_slot_keys`` on the device, as a CUDA graph
  draws them) are bit-equal to the engine's host-keyed
  ``EngineCore._sample_device`` over the same logits, in each sampling
  variant, with the rows that sample nothing at temperature 0;
- the chained-sample merge (``programs.ragged_merge``) equals the JAX
  package's ``_ragged_merge_jit`` on the same numpy arrays;
- the program's bucket follows the used rows and refuses more rows than
  its capacity.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.core import EngineCore as JEngineCore
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.core import EngineCore, EngineRequest
from dynamo_tpu_torch.engine.models import llama
from dynamo_tpu_torch.engine.programs import (RaggedProgram, ragged_merge,
                                              ragged_step_forward,
                                              sampling_variant)
from dynamo_tpu_torch.engine.ragged import build_ragged_batch
from dynamo_tpu_torch.engine.sampling import SlotSampling
from dynamo_tpu_torch.engine.weights import init_params

CFG = ModelConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                  max_position_embeddings=512)
B, BS, M, NB = 4, 8, 8, 40
L = 8                               # ragged_max_seq_rows
CAPACITY = B + 2 * L
LOGIT_ATOL = 1e-5


def _tables():
    """Slot i on blocks 1 + 8i ... 8 + 8i; the trash row all zeros."""
    t = np.zeros((B + 1, M), np.int32)
    for i in range(B):
        t[i] = 1 + i * M + np.arange(M)
    return t


def _batch(kind: str):
    rng = np.random.default_rng(3)
    if kind == "decode":          # slots 0, 1 and 3 decode; slot 2 is free
        return build_ragged_batch(CAPACITY, B, [(0, 5, 20), (1, 6, 33),
                                                (3, 7, 9)], [], L)
    # slot 0 decodes, slot 1 continues a prompt at 24, slot 3 starts one
    return build_ragged_batch(
        CAPACITY, B, [(0, 5, 20)],
        [(1, rng.integers(1, 256, size=11).tolist(), 24),
         (3, rng.integers(1, 256, size=6).tolist(), 0)], L)


def _inputs(batch, temperature=None, top_k=None, top_p=None):
    S = B + 1
    return {"tokens": batch.tokens.astype(np.int64),
            "positions": batch.positions, "row_slot": batch.row_slot,
            "tables": _tables(), "seq_starts": batch.seq_starts,
            "seq_counts": batch.seq_counts,
            "sample_rows": batch.sample_rows,
            "seeds": np.arange(S, dtype=np.int64) + 7,
            "steps": np.arange(S, dtype=np.int64) * 3,
            "temperature": (np.zeros(S, np.float32) if temperature is None
                            else temperature),
            "top_k": np.zeros(S, np.int64) if top_k is None else top_k,
            "top_p": np.ones(S, np.float32) if top_p is None else top_p}


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, 0, "cpu", torch.float32)


def _pool(seed=1):
    kv = llama.init_kv_cache(CFG, NB, BS, "cpu", torch.float32)
    g = torch.Generator().manual_seed(seed)
    for t in kv.values():
        t.copy_(torch.randn(t.shape, generator=g))
    return kv


def _program(params, kv):
    return RaggedProgram(params, kv, CFG, BS, B, M, CAPACITY, L, 0, "cpu")


def _used_rows_forward(params, kv, batch):
    n = batch.rows_used
    t = torch.from_numpy
    return llama.ragged_forward(
        params, kv, t(batch.tokens[:n].astype(np.int64)),
        t(batch.positions[:n]), t(_tables()), t(batch.row_slot[:n]),
        t(batch.seq_starts), t(batch.seq_counts), t(batch.sample_rows),
        CFG, BS, L)


@pytest.mark.parametrize("kind,rows", [("decode", B), ("mixed", CAPACITY)])
def test_bucketed_eager_run_equals_used_rows_forward(params, kind, rows):
    batch = _batch(kind)
    live = [sq.slot for sq in batch.seqs]
    kv_a, kv_b = _pool(), _pool()
    prog = _program(params, kv_a)
    assert prog.bucket(_inputs(batch)) == rows
    with torch.inference_mode():
        d = prog.run_eager("greedy", _inputs(batch), with_logits=True)
        want = _used_rows_forward(params, kv_b, batch)
    np.testing.assert_allclose(d.logits[live].numpy(), want[live].numpy(),
                               atol=LOGIT_ATOL, rtol=0)
    toks, _ = d.fetch()
    assert (toks[live] == want[live].argmax(-1).numpy()).all()
    for n in kv_a:                 # every block but the trash block
        np.testing.assert_allclose(kv_a[n][:, BS:].numpy(),
                                   kv_b[n][:, BS:].numpy(), atol=1e-6,
                                   rtol=0)


def test_dead_rows_write_only_block_zero(params):
    batch = _batch("mixed")
    live = [sq.slot for sq in batch.seqs]
    assert batch.rows_used < CAPACITY        # the bucket holds dead rows
    kv = _pool()
    before = {n: t.clone() for n, t in kv.items()}
    with torch.inference_mode():
        got = _program(params, kv).run_eager("greedy", _inputs(batch),
                                             with_logits=True).logits
    # the rows the live spans wrote, by flat pool index
    tables = _tables()
    written = {int(tables[s, p // BS]) * BS + p % BS
               for s, p in zip(batch.row_slot[:batch.rows_used],
                               batch.positions[:batch.rows_used])}
    for n, t in kv.items():
        changed = set(np.nonzero((t != before[n]).any(dim=(0, 2)).numpy()
                                 )[0].tolist())
        assert changed - written <= set(range(BS)), n
        assert changed & set(range(BS)), n     # the dead rows' writes
    # block 0 randomized anew: no live slot's logits move
    kv2 = {n: t.clone() for n, t in before.items()}
    g = torch.Generator().manual_seed(9)
    for t in kv2.values():
        t[:, :BS] = torch.randn(t[:, :BS].shape, generator=g)
    with torch.inference_mode():
        again = _program(params, kv2).run_eager("greedy", _inputs(batch),
                                                with_logits=True).logits
    assert torch.equal(again[live], got[live])


SAMPLINGS = {
    "greedy": [SlotSampling(), SlotSampling(top_p=0.9), None, SlotSampling()],
    "temperature": [SlotSampling(temperature=0.7, seed=11), SlotSampling(),
                    None, SlotSampling(temperature=1.3, seed=5)],
    "filtered": [SlotSampling(temperature=0.7, top_p=0.9, seed=11),
                 SlotSampling(top_k=3), None,
                 SlotSampling(temperature=0.9, top_k=20, seed=4)],
}


@pytest.mark.parametrize("variant", list(SAMPLINGS))
def test_device_keyed_samples_equal_host_keyed(params, variant):
    """Rows 0, 1 and 3 sample at their steps; slot 2 and the trash slot
    sample nothing (temperature 0), as the engine sends them."""
    core = EngineCore(CFG, EngineConfig(dtype="float32", max_model_len=64,
                                        kv_block_size=BS, num_kv_blocks=NB,
                                        max_num_seqs=B),
                      params=params, device="cpu")
    batch = _batch("decode")
    reqs = [None if s is None else EngineRequest(
        rid=str(i), prompt=[1], sampling=s, max_new_tokens=4,
        eos_ids=frozenset()) for i, s in enumerate(SAMPLINGS[variant])]
    reqs.append(None)                                   # the trash slot
    S = B + 1
    temperature = np.zeros(S, np.float32)
    top_k = np.zeros(S, np.int64)
    top_p = np.ones(S, np.float32)
    seeds = np.zeros(S, np.int64)
    steps = np.array([4, 9, 0, 2**31 + 5, 0], np.int64)
    for i, r in enumerate(reqs):
        if r is not None:
            r.key_step = int(steps[i])
            temperature[i] = r.sampling.temperature
            top_k[i] = r.sampling.top_k
            top_p[i] = r.sampling.top_p
            seeds[i] = r.sampling.seed
    live = np.array([r is not None for r in reqs])
    assert sampling_variant(temperature, top_k, top_p, live) == variant
    t = torch.from_numpy
    inp = _inputs(batch)
    with torch.inference_mode():
        toks, lps, logits = ragged_step_forward(
            params, _pool(), t(inp["tokens"][:B]), t(inp["positions"][:B]),
            t(inp["tables"]), t(inp["row_slot"][:B]), t(inp["seq_starts"]),
            t(inp["seq_counts"]), t(inp["sample_rows"]), t(seeds), t(steps),
            t(temperature), t(top_k), t(top_p), cfg=CFG, block_size=BS,
            max_rows=L, base_seed=core.cfg.seed, variant=variant,
            with_logits=True)
        want_t, want_l = core._sample_device(logits, reqs)
    assert torch.equal(toks, want_t)
    assert torch.equal(lps, want_l)


def test_ragged_merge_equals_jax():
    jcore = JEngineCore(
        JModelConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                     num_layers=1, num_heads=2, num_kv_heads=1, head_dim=16,
                     max_position_embeddings=64),
        JEngineConfig(max_model_len=64, kv_block_size=8, num_kv_blocks=16,
                      max_num_seqs=4, ragged_dispatch=True,
                      decode_dispatch_pipeline=True))
    rng = np.random.default_rng(0)
    prev = rng.integers(0, 1000, size=B + 1)
    srows = rng.integers(0, B + 1, size=CAPACITY)
    host = rng.integers(0, 1000, size=CAPACITY)
    mask = rng.random(CAPACITY) < 0.4
    want = np.asarray(jcore._ragged_merge_jit(
        jnp.asarray(prev, jnp.int32), jnp.asarray(srows, jnp.int32),
        jnp.asarray(host, jnp.int32), jnp.asarray(mask)))
    got = ragged_merge(torch.from_numpy(prev), torch.from_numpy(srows),
                       torch.from_numpy(host), torch.from_numpy(mask))
    assert mask.any() and not mask.all()
    np.testing.assert_array_equal(got.numpy(), want)


def test_bucket_follows_used_rows(params):
    prog = _program(params, _pool())
    counts = np.zeros(B + 1, np.int32)
    for used, rows in ((1, B), (B, B), (B + 1, CAPACITY),
                       (CAPACITY, CAPACITY)):
        counts[0] = used
        assert prog.bucket({"seq_counts": counts}) == rows
    counts[0] = CAPACITY + 1
    with pytest.raises(ValueError, match="capacity"):
        prog.bucket({"seq_counts": counts})
