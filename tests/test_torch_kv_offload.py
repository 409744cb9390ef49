"""The port's host KV tier against the JAX package's, on the CPU.

- block copies: gather, scatter and ``move_blocks`` (overlapping ids), and
  the wire format, equal the JAX package's bytes in f32, bf16, int8 rows
  and MLA latent rows (exact: a block copy moves bytes);
- ``HostKvPool``: the same seeded sequence of stores, matches, pins,
  unpins and fetches gives JAX's placement decisions, evictions, LRU
  parking and bytes; the O(1) eviction of a mostly pinned pool; the
  stacked fetch layout;
- ``KvOffloadEngine``: a saturated queue drops with its counter and
  releases the holds; a write-back survives device eviction and is found
  by the manager's host match with the gathered bytes;
- end to end on the tiny llama (f32), int8-KV and MLA engines: a
  multi-turn conversation whose second turn onboards its prefix from the
  host tier gives the JAX engine's tokens and hit lengths, through the
  off-loop onboard, with the pool tensors' ``data_ptr()`` unchanged; an
  onboard overlapping another request's decode; a cancel during an
  onboard releases its blocks; a failed tier read re-admits cold, with
  the JAX engine's cold tokens. The tiny engines' weights and constructors
  (``family_params``, ``engine_core``, ``serve``) serve the disk and
  defrag test files too.

Engine streams are compared token for token (greedy; the JAX suite's own
contract for a restored prefix: the continuation is exact).
"""

import asyncio
import functools
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import block_copy as jbc
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.core import FINISH_SENTINEL as J_FINISH
from dynamo_tpu.engine.core import EngineCore as JEngineCore
from dynamo_tpu.engine.core import EngineRequest as JEngineRequest
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.models import mla as jmla
from dynamo_tpu.engine.sampling import SlotSampling as JSlotSampling
from dynamo_tpu.llm.kv.offload import HostKvPool as JHostKvPool
from dynamo_tpu.llm.protocols.common import FinishReason
from dynamo_tpu.runtime.engine import EngineContext
from dynamo_tpu_torch.engine import block_copy as tbc
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.core import FINISH_SENTINEL, EngineCore, EngineRequest
from dynamo_tpu_torch.engine.sampling import SlotSampling
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.kv.blocks import TokenBlockSequence
from dynamo_tpu_torch.llm.kv.offload import (HostKvPool, KvOffloadEngine,
                                             OffloadJob)
from dynamo_tpu_torch.llm.kv.pool import KvBlockManager

BS = 4
L, H, D = 2, 2, 8
NB = 16


def np_to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array (bf16 through ml_dtypes) as a torch tensor, bytes
    unchanged."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def torch_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def np_bytes(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


# the pool rows of each layout: (keys, lanes, numpy dtype, wire heads)
LAYOUTS = {"f32": (("k", "v"), H * D, np.float32, H),
           "bf16": (("k", "v"), H * D, ml_dtypes.bfloat16, H),
           "int8_rows": (("k", "v"), H * D + 4, np.int8, 1),
           "mla_rows": (("kv",), 192, np.float32, 1)}


def _pool(layout: str, seed: int) -> dict:
    keys, C, dt, _ = LAYOUTS[layout]
    r = np.random.default_rng(seed)
    if dt == np.int8:
        return {k: r.integers(-128, 128, size=(L, NB * BS, C)).astype(dt)
                for k in keys}
    return {k: r.normal(size=(L, NB * BS, C)).astype(dt) for k in keys}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_block_copies_and_wire_format_equal_jax_bytes(layout):
    heads = LAYOUTS[layout][3]
    src = _pool(layout, 0)
    jkv = {k: jnp.asarray(v) for k, v in src.items()}
    tkv = {k: np_to_torch(v) for k, v in src.items()}
    ptrs = {k: v.data_ptr() for k, v in tkv.items()}
    ids = [2, 5, 7, 5]
    jw = jbc.gather_blocks_to_host(jkv, ids, BS, heads)
    tw = tbc.gather_blocks_to_host(tkv, ids, BS, heads)
    for k in src:
        assert tuple(tw[k].shape) == jw[k].shape
        assert torch_bytes(tw[k]) == np_bytes(jw[k])
        # rows are the wire blocks on a leading axis, and back
        rows = tbc.gather_rows(tkv, ids, BS, heads)[k]
        assert torch.equal(tbc.rows_as_wire(rows), tw[k])
        assert torch.equal(tbc.from_rows(rows),
                           tbc.gather_blocks(tkv, ids, BS)[k])
        assert torch.equal(tbc.wire_as_rows(tw[k]), rows)
    # scatter into other blocks of a second pool, then an overlapping move
    dst_np = _pool(layout, 1)
    jdst = {k: jnp.asarray(v) for k, v in dst_np.items()}
    tdst = {k: np_to_torch(v) for k, v in dst_np.items()}
    dst_ptrs = {k: v.data_ptr() for k, v in tdst.items()}
    targets = [9, 11, 3, 12]
    jdst = jbc.scatter_blocks_from_host(jdst, targets, jw, BS)
    tbc.scatter_blocks_from_host(tdst, targets, tw, BS)
    jdst = jbc.move_blocks(jdst, [9, 11, 3], [11, 3, 14], BS)
    tbc.move_blocks(tdst, [9, 11, 3], [11, 3, 14], BS)
    for k in src:
        assert torch_bytes(tdst[k]) == np_bytes(jdst[k])
    # every write was in place
    assert {k: v.data_ptr() for k, v in tkv.items()} == ptrs
    assert {k: v.data_ptr() for k, v in tdst.items()} == dst_ptrs


def _host_ops(seed: int, n: int = 160):
    """A seeded sequence of host-pool operations over 24 hashes."""
    r = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        op = r.choice(["store", "store", "match", "pin", "unpin", "fetch"])
        hashes = [int(h) for h in r.integers(0, 24, size=r.integers(1, 4))]
        ops.append((str(op), hashes, int(r.integers(0, 1 << 30))))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_pool_decisions_equal_jax(seed):
    cap = 6
    jpool = JHostKvPool(cap, L, H, BS, D, dtype=np.float32)
    tpool = HostKvPool(cap, L, H, BS, D, dtype=torch.float32)
    jev, tev = [], []
    jpool.on_evict = lambda h, th, ph, v: jev.append((h, th, ph, np_bytes(
        v["k"])))
    tpool.on_evict = lambda h, th, ph, v: tev.append((h, th, ph, torch_bytes(
        v["k"])))
    pinned = []
    for op, hashes, vseed in _host_ops(seed):
        if op == "store":
            r = np.random.default_rng(vseed)
            vals = {k: r.normal(size=(L, H, len(hashes), BS, D)).astype(
                np.float32) for k in ("k", "v")}
            toks = [h + 100 for h in hashes]
            pars = [None] + hashes[:-1]
            a = jpool.store(hashes, vals, tokens_hashes=toks,
                            parent_hashes=pars)
            b = tpool.store(hashes, {k: torch.from_numpy(v)
                                     for k, v in vals.items()},
                            tokens_hashes=toks, parent_hashes=pars)
            assert a == b
        elif op == "match":
            assert jpool.match_prefix(hashes) == tpool.match_prefix(hashes)
        elif op == "pin":
            slots = jpool.match_prefix(hashes)
            assert slots == tpool.match_prefix(hashes)
            jpool.pin(slots)
            tpool.pin(slots)
            pinned.append(slots)
        elif op == "unpin" and pinned:
            slots = pinned.pop(0)
            jpool.unpin(slots)
            tpool.unpin(slots)
        elif op == "fetch":
            slots = jpool.match_prefix(hashes)
            assert slots == tpool.match_prefix(hashes)
            if slots:
                jf, tf = jpool.fetch(slots), tpool.fetch(slots)
                for k in jf:
                    assert torch_bytes(tf[k]) == np_bytes(jf[k])
        assert jpool._by_hash == tpool._by_hash
        assert list(jpool._lru) == list(tpool._lru)
        assert list(jpool._lru_parked) == list(tpool._lru_parked)
    assert jev == tev and len(jev) > 0
    assert sorted(jpool.resident_entries()) == sorted(
        tpool.resident_entries())
    assert (jpool.evicted_blocks_total, jpool.evict_scan_steps) == (
        tpool.evicted_blocks_total, tpool.evict_scan_steps)


def test_host_pool_eviction_o1_with_mostly_pinned_pool():
    cap = 64
    pool = HostKvPool(cap, L, H, BS, D)
    one = {"k": torch.zeros((L, H, 1, BS, D)),
           "v": torch.zeros((L, H, 1, BS, D))}
    for h in range(cap):
        assert len(pool.store([h], one)) == 1
    pool.pin([pool._by_hash[h] for h in range(cap - 1)])
    n_stores = 50
    for h in range(100, 100 + n_stores):
        assert len(pool.store([h], one)) == 1
    assert all(pool.contains(h) for h in range(cap - 1))
    assert pool.evicted_blocks_total == n_stores
    assert pool.evict_scan_steps <= cap + n_stores
    pool.unpin([pool._by_hash[h] for h in range(cap - 1)])
    assert len(pool.store([999], one)) == 1
    assert pool.contains(999) and len(pool) == cap


def test_host_pool_fetch_returns_stacked_layout():
    pool = HostKvPool(4, L, H, BS, D)
    vals = {"k": torch.stack([torch.full((L, H, BS, D), float(i))
                              for i in range(2)], dim=2),
            "v": torch.stack([torch.full((L, H, BS, D), 10.0 + i)
                              for i in range(2)], dim=2)}
    pool.store([7, 8], vals)
    slots = pool.match_prefix([7, 8])
    out = pool.fetch(slots)
    assert tuple(out["k"].shape) == (L, H, 2, BS, D)
    assert torch.all(out["k"][:, :, 1] == 1.0)
    assert torch.all(out["v"][:, :, 1] == 11.0)
    rows = pool.fetch_rows(slots)
    assert tuple(rows["k"].shape) == (2, L, H, BS, D)
    assert torch.equal(tbc.rows_as_wire(rows["v"]), out["v"])


async def test_offload_engine_backpressure_drops_with_counter():
    released = []
    host = HostKvPool(4, L, H, BS, D)
    eng = KvOffloadEngine(host, BS, get_kv=lambda: {}, num_heads=H,
                          release_holds=released.extend, max_queue_jobs=0)
    eng.enqueue(OffloadJob(block_ids=[3, 4], seq_hashes=[13, 14]))
    assert eng.dropped_jobs_total == 1
    assert released == [3, 4]          # holds released despite the drop
    eng.enqueue(OffloadJob(block_ids=[5], seq_hashes=[15]))
    assert eng.dropped_jobs_total == 2
    assert eng.offloaded_blocks_total == 0


def test_offload_engine_serves_a_second_event_loop():
    """An engine restarted by another ``asyncio.run`` keeps writing back:
    the pump's queue moves to the new loop with what it held."""
    kv = {k: torch.from_numpy(v) for k, v in _pool("f32", 4).items()}
    host = HostKvPool(8, L, H, BS, D)
    released = []
    eng = KvOffloadEngine(host, BS, get_kv=lambda: kv, num_heads=H,
                          release_holds=released.extend)

    async def one(bid, h):
        eng.enqueue(OffloadJob(block_ids=[bid], seq_hashes=[h]))
        await eng.drain()
        await eng.stop()
    asyncio.run(one(3, 13))
    eng.enqueue(OffloadJob(block_ids=[4], seq_hashes=[14]))  # no loop yet
    asyncio.run(one(5, 15))
    assert [host.contains(h) for h in (13, 14, 15)] == [True] * 3
    assert released == [3, 4, 5]


async def test_offload_engine_write_back_and_manager_fallthrough():
    kv = {k: torch.from_numpy(v) for k, v in _pool("f32", 3).items()}
    host = HostKvPool(8, L, H, BS, D)
    mgr = KvBlockManager(NB, BS, host_pool=host)
    eng = KvOffloadEngine(host, BS, get_kv=lambda: kv, num_heads=H,
                          release_holds=mgr.pool.release)
    prompt = list(range(10))  # 2 full blocks + partial
    plan = mgr.prepare_prefill(prompt)
    assert plan.hit_tokens == 0 and not plan.host_slots
    mgr.register_full_blocks(plan.all_blocks, plan.seq, 0)
    mgr.pool.hold(plan.all_blocks[:2])
    eng.enqueue(OffloadJob(block_ids=plan.all_blocks[:2],
                           seq_hashes=plan.seq.sequence_hashes[:2]))
    mgr.pool.release(plan.all_blocks)
    await eng.drain()
    assert eng.offloaded_blocks_total == 2
    assert eng.transfers[-1][:2] == (2, 2 * 2 * L * H * BS * D * 4)
    assert eng.transfers[-1][3] is None          # no card: no copy timing
    assert mgr.pool.used_blocks == 0             # the holds dropped
    mgr.pool.reset()
    plan2 = mgr.prepare_prefill(prompt)
    assert plan2.hit_tokens == 0 and len(plan2.host_slots) == 2
    assert plan2.host_hit_tokens == 8
    fetched = host.fetch(plan2.host_slots)
    orig = tbc.gather_blocks_to_host(kv, plan.all_blocks[:2], BS, H)
    assert torch.equal(fetched["k"], orig["k"])
    assert torch.equal(fetched["v"], orig["v"])
    await eng.stop()


# --------------------------------------------------------------- engines

GEOM = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position_embeddings=512)
MLA_GEOM = dict(model_type="deepseek_v2", vocab_size=256, hidden_size=64,
                intermediate_size=32, num_layers=3, num_heads=4,
                num_kv_heads=4, head_dim=96, q_lora_rank=0,
                kv_lora_rank=128, qk_nope_head_dim=32, qk_rope_head_dim=64,
                v_head_dim=32, num_experts=4, num_experts_per_tok=2,
                moe_norm_topk=False, first_k_dense=1,
                dense_intermediate_size=64, shared_expert_size=32,
                max_position_embeddings=512)
# model: (geometry, kv quantization)
MODELS = {"llama": (GEOM, "none"), "int8": (GEOM, "int8"),
          "mla": (MLA_GEOM, "none")}
ENGINE = dict(max_model_len=128, kv_block_size=4, num_kv_blocks=48,
              max_num_seqs=2, prefill_buckets=[32, 64, 128],
              host_kv_blocks=24)


@functools.lru_cache(maxsize=None)
def family_params() -> dict:
    """The JAX init's f32 weights of the tiny llama and MLA models, as
    numpy (seed 0), shared by the KV-tier test files."""
    out = {}
    for name, geom in (("llama", GEOM), ("mla", MLA_GEOM)):
        mod = jmla if name == "mla" else jllama
        p = mod.init_params(JModelConfig(**geom), jax.random.PRNGKey(0),
                            dtype=jnp.float32)
        out[name] = {k: np.asarray(v) for k, v in p.items()}
    return out


@pytest.fixture(scope="module")
def np_params():
    return family_params()


def engine_core(np_params, model: str, jax_side: bool, **cfg):
    """A JAX or a port engine over ``model``'s weights (``MODELS``: its
    geometry and KV quantization) with the EngineConfig fields ``cfg``."""
    geom, kvq = MODELS[model]
    p = np_params["mla" if model == "mla" else "llama"]
    cfg = dict(cfg, kv_quantization=kvq)
    if jax_side:
        return JEngineCore(JModelConfig(**geom), JEngineConfig(**cfg),
                           params={k: jnp.asarray(v) for k, v in p.items()},
                           attn_impl="xla", param_dtype=jnp.float32)
    mcfg = ModelConfig(**geom)
    return EngineCore(mcfg, EngineConfig(dtype="float32", **cfg),
                      params=params_from_numpy(p, mcfg, "cpu", torch.float32),
                      device="cpu")


def make_core(np_params, model: str, jax_side: bool, **kw):
    return engine_core(np_params, model, jax_side, **dict(ENGINE, **kw))


async def serve(core, prompt, rid, max_new=8, ctx=None):
    """(tokens, finish reason, prefix hit tokens) of one greedy request."""
    jax_side = isinstance(core, JEngineCore)
    mk = (JEngineRequest, JSlotSampling) if jax_side else (EngineRequest,
                                                           SlotSampling)
    req = mk[0](rid=rid, prompt=list(prompt),
                sampling=mk[1](temperature=0.0), max_new_tokens=max_new,
                eos_ids=frozenset(), ctx=ctx)
    await core.submit(req)
    sentinel = J_FINISH if jax_side else FINISH_SENTINEL
    toks = []
    while True:
        item, payload = await asyncio.wait_for(req.out_queue.get(), 120)
        if item is sentinel:
            return toks, payload, req.prefix_hit_tokens
        toks.append(item)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 256, size=n).tolist()


async def multi_turn(core):
    """Turn 1, then a device wipe, then turn 2 extending turn 1's prompt
    and answer: its prefix comes back from the host tier."""
    p1 = _prompt(5, 21)
    t1, _, h1 = await serve(core, p1, "t1")
    await core.offload_engine.drain()
    core.kv_manager.pool.reset()
    p2 = p1 + t1 + _prompt(6, 7)
    t2, _, h2 = await serve(core, p2, "t2")
    await core.offload_engine.drain()
    return t1, h1, t2, h2


@pytest.mark.parametrize("model", list(MODELS))
async def test_multi_turn_onboard_matches_jax(np_params, model):
    out = []
    for jax_side in (True, False):
        core = make_core(np_params, model, jax_side)
        try:
            ptrs = {k: getattr(v, "data_ptr", lambda: 0)()
                    for k, v in core.kv.items()}
            out.append(await multi_turn(core) + (core.host_onboards,))
            if not jax_side:
                # the onboard scattered into the pool in place
                assert {k: v.data_ptr() for k, v in core.kv.items()} == ptrs
                host = core.kv_manager.host_pool
                assert host.opaque_rows == (model != "llama")
                assert core.metrics().host_stored_total == \
                    host.stored_blocks_total > 0
                recs = [r for r in core.flight.dump()
                        if r["kind"] == "prefill"]
                assert recs[-1]["hit_host"] == out[-1][3]
                assert any(r["kind"] == "onboard" for r in core.flight.dump())
        finally:
            await core.stop()
    (jt1, jh1, jt2, jh2, jon), (tt1, th1, tt2, th2, ton) = out
    assert (tt1, th1) == (jt1, jh1) and th1 == 0
    assert tt2 == jt2 and th2 == jh2 >= 20
    assert ton == jon == 1


async def test_onboard_overlaps_active_decode(np_params):
    pa, pb = _prompt(11, 14), _prompt(12, 12)

    async def scenario(core):
        want_b = await serve(core, pb, "seed", max_new=4)
        await core.offload_engine.drain()
        core.kv_manager.pool.reset()
        a, b = await asyncio.gather(serve(core, pa, "a", max_new=16),
                                    serve(core, pb, "b", max_new=4))
        return want_b[0], a[0], b[0], b[2]

    out = []
    for jax_side in (True, False):
        core = make_core(np_params, "llama", jax_side)
        try:
            out.append(await scenario(core))
        finally:
            await core.stop()
        assert core.host_onboards == 1
    assert out[0] == out[1]
    assert out[1][0] == out[1][2] and out[1][3] >= 8


async def test_cancel_during_onboard_releases_blocks(np_params):
    core = make_core(np_params, "llama", False)
    prompt = _prompt(13, 12)
    try:
        await serve(core, prompt, "seed", max_new=4)
        await core.offload_engine.drain()
        core.kv_manager.pool.reset()
        gate = threading.Event()
        real = core._read_tier_rows

        def gated(plan):                 # hold the read open for the cancel
            gate.wait(30)
            return real(plan)
        core._read_tier_rows = gated
        used0 = core.kv_manager.pool.used_blocks
        ctx = EngineContext("victim")
        task = asyncio.ensure_future(serve(core, prompt, "victim", ctx=ctx))
        while not core.host_onboards:
            await asyncio.sleep(0.005)
        ctx.stop_generating()
        gate.set()
        _, reason, _ = await task
        assert reason == FinishReason.CANCELLED
        assert core.kv_manager.pool.used_blocks == used0
        assert not core.kv_manager.host_pool._pins
    finally:
        await core.stop()


@pytest.mark.parametrize("model", list(MODELS))
async def test_failed_tier_read_readmits_cold(np_params, model):
    prompt = _prompt(14, 18)
    jcore = make_core(np_params, model, True)
    try:
        want, _, _ = await serve(jcore, prompt, "cold")
    finally:
        await jcore.stop()
    core = make_core(np_params, model, False)
    try:
        await serve(core, prompt, "seed")
        await core.offload_engine.drain()
        core.kv_manager.pool.reset()
        host = core.kv_manager.host_pool

        def broken(slots, out=None):
            raise OSError("injected tier read failure")
        host.fetch_rows = broken
        got, reason, hit = await serve(core, prompt, "retry")
        assert got == want and reason == FinishReason.LENGTH
        assert core.onboard_cold_retries == 1 and hit == 0
        assert not host._pins
    finally:
        await core.stop()


def test_wire_heads_follow_the_pool():
    assert tbc.wire_kv_heads(ModelConfig(**GEOM), "none") == 2
    assert tbc.wire_kv_heads(ModelConfig(**GEOM), "int8") == 1
    assert tbc.wire_kv_heads(ModelConfig(**MLA_GEOM), "none") == 1
    seq = TokenBlockSequence(BS, list(range(9)))
    assert len(seq.sequence_hashes) == 2
