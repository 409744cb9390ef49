"""The port's native KV block pool (``dynamo_tpu_torch/llm/kv/native_pool.py``
over its own copy of the C++ source, ``csrc/host/kv_reuse_pool.cpp``) on the
CPU:

- the JAX suite's differential fuzz (``tests/test_kv_pool.py``), widened:
  the same seeded op sequences (alloc, register at a priority, release,
  hold, match, peek, relocate, reset) drive the port's native pool, the
  port's Python pool and the JAX package's pools, which must return the
  same block ids and matches, hold the same refcounts and registrations,
  report the same occupancy, hit and layout statistics, and fire the same
  stored / removed event streams;
- the pool factory's selection (``prefer_native``, ``DYN_NATIVE_KVPOOL=0``)
  and the parent-first ``reannounce`` of both pools;
- an engine over the native pool, whose streams and prefix hits under
  eviction equal the JAX engine's;
- the loader: concurrent builds into one directory agree on one complete
  library, and a missing compiler raises instead of falling back to the
  Python pool.
"""

import os
import threading

import numpy as np
import pytest

from dynamo_tpu.llm.kv.native_pool import NativeKvBlockPool as JNativePool
from dynamo_tpu.llm.kv.pool import KvBlockPool as JKvBlockPool
from dynamo_tpu_torch.llm.kv.blocks import compute_block_hashes
from dynamo_tpu_torch.llm.kv.native_pool import (NativeKvBlockPool,
                                                 load_native_pool_lib)
from dynamo_tpu_torch.llm.kv.pool import (KvBlockManager, KvBlockPool,
                                          make_kv_block_pool)
from dynamo_tpu_torch.utils import native
from tests.test_torch_dispatch import (GREEDY, LANES, _prompt, np_params,
                                       on_both)

assert np_params  # the module fixture, shared with the dispatch tests

POOLS = {"port_native": NativeKvBlockPool, "port_python": KvBlockPool,
         "jax_python": JKvBlockPool, "jax_native": JNativePool}


def _state(pool):
    """Everything a caller can read off a pool."""
    return dict(
        free=pool.free_blocks, used=pool.used_blocks,
        reusable=pool.reusable_blocks, uninit=pool.free_uninit_blocks,
        queries=pool.match_queries, hits=pool.match_hits,
        hit_rate=pool.hit_rate(), runs=pool.contig_runs,
        frag=pool.frag_ratio(), contiguity=pool.contiguity_ratio(),
        alloc_blocks=pool.alloc_blocks_total,
        alloc_runs=pool.alloc_runs_total,
        alloc_requests=pool.alloc_requests_total,
        defrag_moves=pool.defrag_moves_total,
        refcounts=pool.refcounts(list(range(pool.num_blocks))),
        registered=sorted(pool.registered_entries()))


def _by_step(events):
    """Per op: the stored events in order, and the removed hashes as a
    sorted list (the pools batch one call's removals differently: the
    Python pool fires one event a block, the native pool one a call, and a
    reset walks its blocks in another order)."""
    out = {}
    for step, kind, v in events:
        stored, removed = out.setdefault(step, ([], []))
        if kind == "s":
            stored.append(v)
        else:
            removed.extend(v)
    return {k: (st, sorted(rm)) for k, (st, rm) in out.items()}


@pytest.mark.parametrize("seed", [1337, 7, 2024])
def test_pools_fuzz_equal(seed):
    rng = np.random.default_rng(seed)
    n_blocks = 33
    events = {name: [] for name in POOLS}
    at = [0]                           # the op the events belong to
    pools = {}
    for name, cls in POOLS.items():
        ev = events[name]
        pools[name] = cls(
            n_blocks, on_stored=lambda *a, ev=ev: ev.append((at[0], "s", a)),
            on_removed=lambda h, ev=ev: ev.append((at[0], "r", list(h))))
    held = []                          # ids held once, the same in all
    hashes = compute_block_hashes(list(range(400)), 4)   # 100 chained
    for step in range(1500):
        at[0] = step
        op = int(rng.integers(0, 9))
        if op == 0:                                   # alloc
            n = int(rng.integers(1, 6))
            got = {name: p.alloc_uninit(n) for name, p in pools.items()}
            assert len({repr(g) for g in got.values()}) == 1, (step, got)
            if got["port_native"] is not None:
                held.extend(got["port_native"])
        elif op == 1 and held:                        # register
            bid = held[int(rng.integers(0, len(held)))]
            j = int(rng.integers(0, len(hashes)))
            parent = hashes[j - 1] if j else None
            prio = int(rng.integers(0, 3))
            for p in pools.values():
                p.register(bid, hashes[j], j, parent, priority=prio)
        elif op == 2 and held:                        # release some
            k = int(rng.integers(1, len(held) + 1))
            for p in pools.values():
                p.release(held[:k])
            del held[:k]
        elif op == 3:                                 # match a prefix
            j = int(rng.integers(1, len(hashes)))
            got = {name: p.match_prefix(hashes[:j])
                   for name, p in pools.items()}
            assert len({repr(g) for g in got.values()}) == 1, (step, got)
            held.extend(got["port_native"])
        elif op == 4:                                 # peek
            j = int(rng.integers(1, len(hashes)))
            assert len({p.peek_prefix(hashes[:j])
                        for p in pools.values()}) == 1, step
        elif op == 5 and held:                        # hold (pin) some
            k = int(rng.integers(1, min(len(held), 4) + 1))
            for p in pools.values():
                p.hold(held[:k])
            held.extend(held[:k])
        elif op == 6 and held:                        # relocate one block
            src = held[int(rng.integers(0, len(held)))]
            if pools["port_python"].refcounts([src])[0] != 1:
                continue
            got = {name: p.alloc_uninit(1) for name, p in pools.items()}
            assert len({repr(g) for g in got.values()}) == 1, (step, got)
            if got["port_native"] is None:
                continue
            dst = got["port_native"][0]
            for p in pools.values():
                p.relocate([(src, dst)])
            held[held.index(src)] = dst
        elif op == 7 and rng.random() < 0.05:         # reset (rare)
            for p in pools.values():
                p.reset()
        states = {name: _state(p) for name, p in pools.items()}
        ref = states["jax_python"]
        # the JAX native pool's reannounce shadow keeps a re-registered
        # block's old hash (ROADMAP C); the port's does not
        states["jax_native"]["registered"] = ref["registered"]
        for name, st in states.items():
            assert st == ref, (step, name,
                               {k: (v, ref[k]) for k, v in st.items()
                                if v != ref[k]})
    ref = _by_step(events["jax_python"])
    assert any(st for st, _ in ref.values())
    assert any(rm for _, rm in ref.values())
    for name in POOLS:
        assert _by_step(events[name]) == ref, name


@pytest.mark.parametrize("cls", [NativeKvBlockPool, KvBlockPool],
                         ids=["native", "python"])
def test_reannounce_orders_parents_before_children(cls):
    """A block registered before its parent is replayed after it, and an
    orphan (parent evicted) still replays, last."""
    pool = cls(16)
    h = compute_block_hashes(list(range(16)), 4)      # 4 chained hashes
    b = pool.alloc_uninit(4)
    pool.register(b[2], h[2], 2, h[1])                 # child first
    pool.register(b[1], h[1], 1, h[0])
    pool.register(b[0], h[0], 0, None)
    pool.register(b[3], 99, 3, 12345)                  # orphan
    seen = []
    n = pool.reannounce(lambda bid, sh, th, ph: seen.append(sh))
    assert n == 4 and seen[:3] == [h[0], h[1], h[2]] and seen[3] == 99


def test_factory_selects_the_pool(monkeypatch):
    assert isinstance(make_kv_block_pool(8), NativeKvBlockPool)
    assert isinstance(make_kv_block_pool(8, prefer_native=False),
                      KvBlockPool)
    assert isinstance(KvBlockManager(8, 4).pool, NativeKvBlockPool)
    monkeypatch.setenv("DYN_NATIVE_KVPOOL", "0")
    assert isinstance(make_kv_block_pool(8), KvBlockPool)
    assert isinstance(KvBlockManager(8, 4).pool, KvBlockPool)


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """The native pool was asked for and cannot build: the factory
    raises, it does not quietly hand back the Python pool."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-compiler-here"))
    with pytest.raises(RuntimeError, match="lib"):
        make_kv_block_pool(8)
    with pytest.raises(RuntimeError):
        KvBlockManager(8, 4)
    assert not list((tmp_path / "build").glob("*.so*"))   # nothing half-built
    monkeypatch.setenv("DYN_NATIVE_KVPOOL", "0")
    assert isinstance(make_kv_block_pool(8), KvBlockPool)


def test_concurrent_builds_agree(tmp_path):
    """Builds racing in one directory each compile to a temporary name
    and rename it into place: every caller gets the one complete library,
    and no temporary file is left."""
    out, errs = [], []

    def build():
        try:
            out.append(native.build("kv_reuse_pool", ["kv_reuse_pool.cpp"],
                                    build_dir=str(tmp_path)))
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs and not any(t.is_alive() for t in threads)
    assert len(set(out)) == 1 and os.path.getsize(out[0]) > 0
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(out[0])]
    pool = NativeKvBlockPool(8, lib=load_native_pool_lib(str(tmp_path)))
    assert pool.free_blocks == 7


async def test_native_pool_engine_matches_jax(np_params):
    """A port engine over the native pool (the default) serves prompts
    that share prefixes through a pool small enough to evict: its streams
    and prefix hits equal the JAX engine's."""
    shared = _prompt(71, 24)
    prompts = [shared + _prompt(72 + i, 5 + i) for i in range(4)]
    prompts += [_prompt(80, 40), shared + _prompt(73, 6)]

    async def scenario(side):
        out = []
        for i, p in enumerate(prompts):
            toks, _, req = await side.run(p, f"r{i}", max_new=10,
                                          sampling=GREEDY)
            out.append((toks, req.prefix_hit_tokens))
        return out

    jout, tout, jcore, tcore = await on_both(
        np_params, scenario, **dict(LANES, num_kv_blocks=20))
    assert isinstance(tcore.kv_manager.pool, NativeKvBlockPool)
    assert tout == jout
    assert sum(hit for _, hit in tout) >= 16
    assert tcore.kv_manager.pool.match_hits == \
        jcore.kv_manager.pool.match_hits
