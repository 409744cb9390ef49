"""The port's pool layout statistics and defrag pass against the JAX
package's, on the CPU.

- the free-run index coalesces; allocations land as few runs;
  ``frag_ratio`` reflects a shattered free space; ``relocate`` moves the
  hash registrations and refcounts and rejects bad targets;
- under the JAX suite's seeded churn (allocations with and without
  registration, releases, defrag-style relocations) the port's pool and
  JAX's make the same allocations and give the same ``frag_ratio``,
  ``contig_runs``, ``contiguity_ratio``, ``count_runs`` and
  ``defrag_moves_total`` after every step, and every registration still
  matches at its current blocks;
- end to end, on the split path and the ``--ragged`` path of the tiny
  llama and on the split path over an int8 pool and over MLA's latent
  pool: a request admitted into a shattered pool is moved by the idle
  defrag pass while it decodes; its
  stream equals its stream without interference and the JAX engine's,
  ``defrag_passes`` equals JAX's, the sequence's blocks become one run,
  and the pool tensors' ``data_ptr()`` are unchanged.
"""

import asyncio

import numpy as np
import pytest

from dynamo_tpu.engine.core import FINISH_SENTINEL as J_FINISH
from dynamo_tpu.engine.core import EngineRequest as JEngineRequest
from dynamo_tpu.engine.sampling import SlotSampling as JSlotSampling
from dynamo_tpu.llm.kv.pool import KvBlockPool as JKvBlockPool
from dynamo_tpu_torch.engine.core import FINISH_SENTINEL, EngineRequest
from dynamo_tpu_torch.engine.sampling import SlotSampling
from dynamo_tpu_torch.llm.kv.blocks import compute_block_hashes
from dynamo_tpu_torch.llm.kv.pool import FreeRunIndex, KvBlockPool
from tests.test_torch_kv_offload import engine_core, family_params


def test_free_run_index_coalesces():
    idx = FreeRunIndex()
    for b in (5, 7, 6, 1, 2):
        idx.add(b)
    assert idx.num_runs == 2 and idx.largest_run == 3
    assert idx.take(3) == [5, 6, 7]
    assert idx.num_runs == 1 and len(idx) == 2


def test_alloc_release_and_frag_ratio():
    pool = KvBlockPool(33)
    a = pool.alloc_uninit(8)
    assert pool.count_runs(a) == 1 and pool.contiguity_ratio() == 1.0
    comb = pool.alloc_uninit(24)
    pool.release(comb[::2])
    assert pool.frag_ratio() == pytest.approx(1 - 1 / 12)
    assert pool.contig_runs == 12
    pool.release(comb[1::2])
    pool.release(a)
    assert pool.frag_ratio() == 0.0 and pool.contig_runs == 1


def test_relocate_hash_registration_follows():
    pool = KvBlockPool(32)
    a = pool.alloc_uninit(4)
    h = compute_block_hashes(list(range(16)), 4)
    for i, bid in enumerate(a):
        pool.register(bid, h[i], 0, h[i - 1] if i else None)
    tgt = pool.alloc_uninit(4)
    pool.relocate(list(zip(a, tgt)))
    assert pool.free_blocks == 31 - 4
    assert pool.refcounts(tgt) == [1] * 4 and pool.refcounts([0]) == [0]
    pool.release(tgt)
    assert pool.match_prefix(h[:4]) == tgt
    entries = {e[1]: e[0] for e in pool.registered_entries()}
    assert [entries[h[i]] for i in range(4)] == tgt
    assert pool.defrag_moves_total == 4
    pool.release(tgt)


def test_relocate_rejects_bad_targets():
    pool = KvBlockPool(16)
    a = pool.alloc_uninit(2)
    h = compute_block_hashes(list(range(8)), 4)
    pool.register(a[0], h[0], 0, None)
    with pytest.raises(ValueError):
        pool.relocate([(a[1], a[0])])      # target registered
    pool.release(a)
    b = pool.alloc_uninit(1)
    with pytest.raises(ValueError):
        pool.relocate([(5, b[0])])         # source not resident


def _stats(pool):
    return (pool.free_blocks, pool.free_uninit_blocks, pool.reusable_blocks,
            pool.frag_ratio(), pool.contig_runs, pool.contiguity_ratio(),
            pool.defrag_moves_total, pool.used_blocks)


@pytest.mark.parametrize("seed", [99, 7])
def test_churn_statistics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    jp, tp = JKvBlockPool(257), KvBlockPool(257)
    hashes = compute_block_hashes(list(range(4 * 1024)), 4)
    held = []        # (blocks, first hash index or None)
    next_h = 0
    for _ in range(400):
        op = rng.integers(0, 8)
        if op <= 3:                                  # alloc + register
            n = int(rng.integers(2, 9))
            if n > tp.free_blocks:
                continue
            blocks = tp.alloc_uninit(n)
            assert jp.alloc_uninit(n) == blocks
            if next_h + n <= len(hashes) and rng.integers(0, 2):
                for i, bid in enumerate(blocks):
                    j = next_h + i
                    for p in (jp, tp):
                        p.register(bid, hashes[j], j,
                                   hashes[j - 1] if j else None)
                held.append((blocks, next_h))
                next_h += n
            else:
                held.append((blocks, None))
        elif op <= 5 and held:                       # release a sequence
            blocks, _ = held.pop(int(rng.integers(0, len(held))))
            jp.release(blocks)
            tp.release(blocks)
        elif held:                                   # defrag-style move
            i = int(rng.integers(0, len(held)))
            blocks, h0 = held[i]
            if len(blocks) > tp.free_uninit_blocks:
                continue
            tgt = tp.alloc_uninit(len(blocks))
            assert jp.alloc_uninit(len(blocks)) == tgt
            assert jp.count_runs(tgt) == tp.count_runs(tgt)
            jp.relocate(list(zip(blocks, tgt)))
            tp.relocate(list(zip(blocks, tgt)))
            held[i] = (tgt, h0)
        assert _stats(jp) == _stats(tp)
    for blocks, h0 in held:
        if h0 is not None:
            assert tp.match_prefix(hashes[h0:h0 + len(blocks)]) == blocks
    assert tp.defrag_moves_total > 0 and tp.contiguity_ratio() >= 0.5


# ------------------------------------------------------------ the engines

ENGINE = dict(max_model_len=256, kv_block_size=8, num_kv_blocks=64,
              max_num_seqs=2, prefill_buckets=[32],
              kv_defrag_threshold=0.01)
# (dispatch path, model): the split and ragged paths on the tiny llama,
# and the split path over an int8 pool and over MLA's latent pool
CASES = {"split-llama": ({}, "llama"),
         "ragged-llama": (dict(ragged_dispatch=True, ragged_max_seq_rows=16),
                          "llama"),
         "split-int8": ({}, "int8"), "split-mla": ({}, "mla")}


@pytest.fixture(scope="module")
def np_params():
    return family_params()


def make_core(np_params, jax_side, model="llama", **kw):
    return engine_core(np_params, model, jax_side, **dict(ENGINE, **kw))


def _request(jax_side, prompt, rid):
    mk = (JEngineRequest, JSlotSampling) if jax_side else (EngineRequest,
                                                           SlotSampling)
    return mk[0](rid=rid, prompt=list(prompt),
                 sampling=mk[1](temperature=0.0), max_new_tokens=24,
                 eos_ids=frozenset())


async def _drain(req, sentinel):
    toks = []
    while True:
        item, _ = await asyncio.wait_for(req.out_queue.get(), 60)
        if item is sentinel:
            return toks
        toks.append(item)


async def defrag_scenario(core, jax_side):
    """The JAX suite's scenario: a baseline stream, then the same request
    admitted into a shattered pool (the whole pool held, every other
    block released); the rest of the comb is released once it is
    admitted, and the idle pass moves it while it decodes."""
    sentinel = J_FINISH if jax_side else FINISH_SENTINEL
    prompt = np.random.default_rng(13).integers(1, 256, size=24).tolist()
    req = _request(jax_side, prompt, "base")
    await core.submit(req)
    base = await _drain(req, sentinel)
    pool = core.kv_manager.pool
    pool.reset()
    comb = pool.alloc_uninit(63)
    pool.release(comb[::2])
    req = _request(jax_side, prompt, "frag")
    await core.submit(req)
    while req.slot < 0:
        await asyncio.sleep(0.002)
    runs_before = pool.count_runs(core.slots[req.slot].blocks)
    pool.release(comb[1::2])
    seen = []
    while core.slots[req.slot] is req:
        seen.append(list(req.blocks))
        await asyncio.sleep(0.002)
    toks = await _drain(req, sentinel)
    return base, toks, runs_before, seen


@pytest.mark.parametrize("case", list(CASES))
async def test_defrag_pass_matches_jax(np_params, case):
    fields, model = CASES[case]
    out = []
    for jax_side in (True, False):
        core = make_core(np_params, jax_side, model=model, **fields)
        ptrs = None if jax_side else {k: v.data_ptr()
                                      for k, v in core.kv.items()}
        try:
            out.append(await defrag_scenario(core, jax_side)
                       + (core.defrag_passes,
                          core.kv_manager.pool.defrag_moves_total))
        finally:
            await core.stop()
        if not jax_side:
            assert {k: v.data_ptr() for k, v in core.kv.items()} == ptrs
            assert any(r["kind"] == "defrag" for r in core.flight.dump())
            assert core.metrics().kv_defrag_moves_total == out[-1][5]
    (jbase, jtoks, jruns, _, jpasses, jmoves), \
        (tbase, ttoks, truns, seen, tpasses, tmoves) = out
    assert tbase == jbase and ttoks == jtoks == tbase
    assert truns == jruns >= 2
    assert tpasses == jpasses == 1 and tmoves >= 2
    # the pass left the sequence's blocks one run (until decode grew it)
    assert min(KvBlockPool.count_runs(b) for b in seen) == 1


async def test_defrag_off_at_threshold_zero(np_params):
    core = make_core(np_params, False, kv_defrag_threshold=0.0)
    try:
        base, toks, runs, seen, = await defrag_scenario(core, False)
        assert toks == base and runs >= 2
        assert core.defrag_passes == 0
        assert min(KvBlockPool.count_runs(b) for b in seen) == runs
    finally:
        await core.stop()
