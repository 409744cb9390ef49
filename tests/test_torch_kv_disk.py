"""The port's disk KV tier against the JAX package's, on the CPU.

- ``DiskKvStore``: put / match / fetch, LRU capacity eviction with pins,
  the same seeded sequence of puts, matches, pins and unpins giving JAX's
  eviction decisions and bytes; recovery (a torn manifest tail, orphans,
  a vanished and a truncated payload reaped, a block-size mismatch
  starting cold, blocks acknowledged before a ``kill -9`` surviving it);
  bf16 and int8 rows byte for byte across a reopen;
- a directory written by the JAX package is read by the port, and the
  reverse (f32, bf16, int8 rows): the same on-disk format;
- the tiered ``prepare_prefill`` (device, then host, then disk, pinned at
  the match) gives JAX's plans over the same seeded sequence of
  admissions, write-backs, spills, releases and wipes; the invariant
  check releases its holds and pins;
- ``DiskSpillEngine``: a saturated queue drops with its counter;
- end to end on the tiny llama, int8-KV and MLA engines: host evictions
  spill to disk and a later request promotes from there; a restarted
  engine on the same directory serves a prefix from disk; both with the
  JAX engine's tokens. The stop's flush persists more blocks than the
  spill queue holds. A slowed disk write, held by an event, does not stop
  another request from being served (the spill runs off the loop);
- a tiered run's recorder log (``kv_store``, ``kv_disk_store``, a host
  and a disk restore) replays with no difference, and the JAX package's
  ``check_log`` / ``check_inputs`` accept it.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import replay as jreplay
from dynamo_tpu.llm.kv.diskstore import DiskKvStore as JDiskKvStore
from dynamo_tpu.llm.kv.offload import HostKvPool as JHostKvPool
from dynamo_tpu.llm.kv.pool import KvBlockManager as JKvBlockManager
from dynamo_tpu_torch.engine import replay
from dynamo_tpu_torch.llm.kv.diskstore import (DiskKvStore, DiskSpillEngine,
                                               SpillJob)
from dynamo_tpu_torch.llm.kv.offload import HostKvPool
from dynamo_tpu_torch.llm.kv.pool import KvBlockManager
from tests.test_torch_kv_offload import MODELS, engine_core, family_params
from tests.test_torch_kv_offload import serve as serve_request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, H, BS, D = 2, 2, 4, 8


def _blk(x: float) -> dict:
    return {"k": torch.full((L, H, BS, D), x),
            "v": torch.full((L, H, BS, D), 10 + x)}


def np_to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def torch_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


# ------------------------------------------------------------------ store


def test_diskstore_put_match_fetch_roundtrip(tmp_path):
    store = DiskKvStore(str(tmp_path), capacity_blocks=8)
    assert store.put(101, _blk(1.0), tokens_hash=11, parent_hash=None) == []
    assert store.put(102, _blk(2.0), tokens_hash=12, parent_hash=101) == []
    assert store.put(101, _blk(9.0)) is None     # content addressing
    assert store.match_prefix([101, 102, 999]) == [101, 102]
    assert store.match_prefix([999]) == []
    out = store.fetch([101, 102])
    assert tuple(out["k"].shape) == (L, H, 2, BS, D)
    assert torch.all(out["k"][:, :, 0] == 1.0)
    assert torch.all(out["v"][:, :, 1] == 12.0)
    rows = store.fetch_rows([101, 102])
    assert tuple(rows["k"].shape) == (2, L, H, BS, D)
    assert store.registered_entries() == [(101, 11, None), (102, 12, 101)]
    assert store.hit_rate() > 0


def test_diskstore_capacity_lru_eviction_and_pins(tmp_path):
    store = DiskKvStore(str(tmp_path), capacity_blocks=3)
    for i in range(3):
        store.put(100 + i, _blk(float(i)))
    store.match_prefix([100])             # freshen: 101 becomes LRU
    assert store.put(200, _blk(9.0)) == [101]
    assert not store.contains(101) and store.contains(200)
    store.pin([102])
    store.match_prefix([100, 200])        # LRU order now: 102, 100, 200
    assert store.put(201, _blk(8.0)) == [100]
    assert store.contains(102)
    store.unpin([102])
    assert store.evicted_blocks_total == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_diskstore_decisions_equal_jax(tmp_path, seed):
    cap = 5
    js = JDiskKvStore(str(tmp_path / "jax"), cap, expect_block_size=BS)
    ts = DiskKvStore(str(tmp_path / "port"), cap, expect_block_size=BS)
    r = np.random.default_rng(seed)
    pinned = []
    for _ in range(60):
        op = r.choice(["put", "put", "match", "pin", "unpin"])
        hashes = [int(h) for h in r.integers(0, 14, size=r.integers(1, 4))]
        if op == "put":
            x = r.normal(size=(L, H, BS, D)).astype(np.float32)
            a = js.put(hashes[0], {"k": x, "v": x + 1}, tokens_hash=7,
                       parent_hash=None)
            b = ts.put(hashes[0], {"k": torch.from_numpy(x),
                                   "v": torch.from_numpy(x + 1)},
                       tokens_hash=7, parent_hash=None)
            assert a == b
        elif op == "match":
            assert js.match_prefix(hashes) == ts.match_prefix(hashes)
        elif op == "pin":
            m = js.match_prefix(hashes, pin=True)
            assert m == ts.match_prefix(hashes, pin=True)
            pinned.append(m)
        elif pinned:
            m = pinned.pop(0)
            js.unpin(m)
            ts.unpin(m)
        assert list(js._entries) == list(ts._entries)
        assert js._pins == ts._pins
    for h in js._entries:
        assert torch_bytes(ts.fetch([h])["k"]) == js.fetch([h])["k"].tobytes()
    # the manifests hold the same acknowledgements
    read = lambda s: [json.loads(x) for x in open(  # noqa: E731
        os.path.join(s.root, "manifest.jsonl"))]
    assert [(d["op"], d["h"]) for d in read(js)] == [
        (d["op"], d["h"]) for d in read(ts)]


def test_diskstore_survives_kill9_mid_spill(tmp_path):
    d = str(tmp_path / "kv")
    code = (
        "import sys, torch\n"
        "from dynamo_tpu_torch.llm.kv.diskstore import DiskKvStore\n"
        "store = DiskKvStore(sys.argv[1], capacity_blocks=100000)\n"
        "i = 0\n"
        "print('ready', flush=True)\n"
        "while True:\n"
        "    vals = {'k': torch.full((4, 2, 16, 64), float(i))}\n"
        "    store.put(i + 1, vals, tokens_hash=i, parent_hash=None)\n"
        "    print(i + 1, flush=True)\n"
        "    i += 1\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-c", code, d], env=env,
                            cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        acked = []
        deadline = time.monotonic() + 60
        while len(acked) < 5 and time.monotonic() < deadline:
            acked.append(int(proc.stdout.readline()))
        assert len(acked) >= 5, "writer made no progress"
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
    store = DiskKvStore(d, capacity_blocks=100000)
    for h in acked:
        assert store.contains(h), f"acknowledged block {h} lost"
        assert torch.all(store.fetch([h])["k"][:, :, 0] == float(h - 1))
    for h, _th, _ph in store.registered_entries():
        store.fetch([h])
    assert not [f for f in os.listdir(d) if f.startswith("tmp-")]


def test_diskstore_torn_manifest_and_orphans(tmp_path):
    d = str(tmp_path / "kv")
    store = DiskKvStore(d, capacity_blocks=8)
    store.put(1, _blk(1.0))
    store.put(2, _blk(2.0))
    store.close()
    with open(os.path.join(d, "manifest.jsonl"), "a") as f:
        f.write('{"op": "put", "h": 3, "f"')            # torn tail
    orphan = os.path.join(d, "blk-00000000000000ff.npz")
    with open(orphan, "wb") as f:
        np.savez(f, k=np.zeros((1,)))
    with open(os.path.join(d, "manifest.jsonl"), "a") as f:
        f.write(json.dumps({"op": "put", "h": 77, "f": "blk-gone.npz",
                            "n": 1}) + "\n")
    store2 = DiskKvStore(d, capacity_blocks=8)
    assert sorted(h for h, _t, _p in store2.registered_entries()) == [1, 2]
    assert not os.path.exists(orphan)
    assert torch.all(store2.fetch([2])["k"][:, :, 0] == 2.0)


def test_diskstore_recovery_reaps_truncated_payload(tmp_path):
    d = str(tmp_path / "kv")
    store = DiskKvStore(d, capacity_blocks=8)
    for h in (1, 2, 3):
        store.put(h, _blk(float(h)), tokens_hash=11 * h)
    fname = {e.seq_hash: e.fname for e in store._entries.values()}
    store.close()
    with open(os.path.join(d, fname[2]), "r+b") as f:
        f.truncate(16)
    os.unlink(os.path.join(d, fname[3]))
    store2 = DiskKvStore(d, capacity_blocks=8)
    assert [h for h, _t, _p in store2.registered_entries()] == [1]
    assert store2.reaped_corrupt_blocks == 1       # truncated (3: missing)
    assert not os.path.exists(os.path.join(d, fname[2]))
    assert store2.put(2, _blk(2.0)) == []
    assert torch.all(store2.fetch([2])["k"][:, :, 0] == 2.0)


def test_diskstore_roundtrips_bfloat16_and_int8(tmp_path):
    store = DiskKvStore(str(tmp_path), capacity_blocks=8)
    g = torch.Generator().manual_seed(3)
    bf = torch.randn((L, H, BS, D), generator=g).to(torch.bfloat16)
    i8 = torch.randint(-128, 127, (L, 1, BS, 64), generator=g,
                       dtype=torch.int8)
    store.put(1, {"k": bf, "v": bf + 1})
    store.close()
    out = DiskKvStore(str(tmp_path), capacity_blocks=8).fetch([1])
    assert out["k"].dtype == torch.bfloat16
    assert torch.equal(out["k"][:, :, 0], bf)
    assert torch.equal(out["v"][:, :, 0], bf + 1)
    store3 = DiskKvStore(str(tmp_path / "i8"), capacity_blocks=8)
    store3.put(2, {"kv": i8})
    got = store3.fetch([2])["kv"]
    assert got.dtype == torch.int8 and torch.equal(got[:, :, 0], i8)


def test_diskstore_block_size_mismatch_starts_cold(tmp_path):
    d = str(tmp_path / "kv")
    store = DiskKvStore(d, capacity_blocks=8, expect_block_size=4)
    store.put(1, _blk(1.0))
    store.close()
    assert len(DiskKvStore(d, capacity_blocks=8, expect_block_size=16)) == 0


DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16, "int8": np.int8}


def _rows(dt, seed):
    r = np.random.default_rng(seed)
    if dt == np.int8:
        return r.integers(-128, 128, size=(L, 1, BS, 36)).astype(dt)
    return r.normal(size=(L, H, BS, D)).astype(dt)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_disk_directories_cross_packages(tmp_path, dtype, direction):
    dt = DTYPES[dtype]
    blocks = {h: _rows(dt, h) for h in (11, 12, 13)}
    keys = ("kv",) if dt == np.int8 else ("k", "v")
    d = str(tmp_path / "kv")
    writer, reader = ((JDiskKvStore, DiskKvStore)
                      if direction == "jax_to_port"
                      else (DiskKvStore, JDiskKvStore))
    w = writer(d, 8, expect_block_size=BS)
    for i, (h, x) in enumerate(blocks.items()):
        vals = {k: x for k in keys}
        if writer is DiskKvStore:
            vals = {k: np_to_torch(v) for k, v in vals.items()}
        w.put(h, vals, tokens_hash=100 + h, parent_hash=h - 1 if i else None)
    w.close()
    r = reader(d, 8, expect_block_size=BS)
    assert r.restored_blocks == 3
    assert r.registered_entries() == w.registered_entries()
    got = r.fetch(list(blocks))
    for k in keys:
        want = np.stack([blocks[h] for h in blocks], axis=2).tobytes()
        have = (torch_bytes(got[k]) if reader is DiskKvStore
                else np.ascontiguousarray(got[k]).tobytes())
        assert have == want
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    assert meta["block_size"] == BS
    assert {v[1] for v in meta["layout"].values()} == {np.dtype(dt).name}


# ------------------------------------------------------- tiered planning


def _managers(tmp_path):
    out = []
    for side, (mgr_cls, host_cls, disk_cls) in {
            "jax": (JKvBlockManager, JHostKvPool, JDiskKvStore),
            "port": (KvBlockManager, HostKvPool, DiskKvStore)}.items():
        host = host_cls(6, L, H, BS, D)
        disk = disk_cls(str(tmp_path / side), 10, expect_block_size=BS)
        kw = {"prefer_native": False} if side == "jax" else {}
        out.append(mgr_cls(24, BS, host_pool=host, disk_store=disk, **kw))
    return out


def _plan_key(plan):
    if plan is None:
        return None
    return (plan.hit_blocks, plan.new_blocks, plan.hit_tokens,
            plan.host_slots, plan.disk_hashes, plan.host_hit_tokens,
            plan.disk_hit_tokens)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiered_prepare_prefill_plans_equal_jax(tmp_path, seed):
    jm, tm = _managers(tmp_path)
    r = np.random.default_rng(seed)
    stems = [r.integers(1, 50, size=16).tolist() for _ in range(4)]
    live = []                      # (jax plan, port plan)
    for _ in range(80):
        op = r.choice(["admit", "admit", "admit", "finish", "finish",
                       "spill", "wipe"])
        if op == "admit":
            stem = stems[int(r.integers(0, 4))]
            prompt = stem[:int(r.integers(5, 17))] + r.integers(
                1, 50, size=int(r.integers(0, 3))).tolist()
            jp, tp = jm.prepare_prefill(prompt), tm.prepare_prefill(prompt)
            assert _plan_key(jp) == _plan_key(tp)
            if jp is not None:
                n = jm.register_full_blocks(jp.all_blocks, jp.seq, 0)
                assert n == tm.register_full_blocks(tp.all_blocks, tp.seq, 0)
                if jp.disk_hashes:
                    jm.disk_store.unpin(jp.disk_hashes)
                    tm.disk_store.unpin(tp.disk_hashes)
                live.append((jp, tp, n))
        elif op == "finish" and live:
            jp, tp, n = live.pop(int(r.integers(0, len(live))))
            # write the registered blocks back to the host tier
            hashes = jp.seq.sequence_hashes[:n]
            vals = np.zeros((L, H, n, BS, D), np.float32)
            a = jm.host_pool.store(hashes, {"k": vals, "v": vals})
            b = tm.host_pool.store(hashes, {"k": torch.from_numpy(vals),
                                            "v": torch.from_numpy(vals)})
            assert a == b
            jm.pool.release(jp.all_blocks)
            tm.pool.release(tp.all_blocks)
        elif op == "spill":
            ents = sorted(jm.host_pool.resident_entries())
            assert ents == sorted(tm.host_pool.resident_entries())
            for h, _th, _ph, _slot in ents[:3]:
                x = np.zeros((L, H, BS, D), np.float32)
                assert jm.disk_store.put(h, {"k": x, "v": x}) == \
                    tm.disk_store.put(h, {"k": torch.from_numpy(x),
                                          "v": torch.from_numpy(x)})
        elif op == "wipe":
            jm.pool.reset()
            tm.pool.reset()
        assert jm.pool.free_blocks == tm.pool.free_blocks
    assert jm.host_pool.match_hits == tm.host_pool.match_hits > 0
    assert jm.disk_store.match_hits == tm.disk_store.match_hits > 0


def test_prepare_prefill_asserts_disk_pin_coverage(tmp_path):
    store = DiskKvStore(str(tmp_path), capacity_blocks=16)
    mgr = KvBlockManager(32, 4, disk_store=store)
    prompt = list(range(10))

    class OverReturningStore:
        def __init__(self):
            self.pinned, self.unpinned = [], []

        def match_prefix(self, hashes, pin=False):
            fake = list(range(900, 908))
            self.pinned.extend(fake)
            return fake

        def unpin(self, hashes):
            self.unpinned.extend(hashes)

    mgr.disk_store = OverReturningStore()
    free_before = mgr.pool.free_blocks
    with pytest.raises(RuntimeError, match="invariant"):
        mgr.prepare_prefill(prompt)
    assert mgr.pool.free_blocks == free_before
    assert mgr.disk_store.unpinned == mgr.disk_store.pinned
    mgr.disk_store = store
    plan = mgr.prepare_prefill(prompt)
    assert len(plan.new_blocks) >= len(plan.host_slots) + len(
        plan.disk_hashes)
    mgr.abort_plan(plan)


async def test_spill_engine_backpressure_drops_with_counter(tmp_path):
    store = DiskKvStore(str(tmp_path), capacity_blocks=8)
    eng = DiskSpillEngine(store, max_queue_jobs=0)
    assert not eng.offer(SpillJob(1, None, None, _blk(1.0)))
    assert eng.dropped_jobs_total == 1
    eng2 = DiskSpillEngine(store, max_queue_jobs=8)
    assert eng2.offer(SpillJob(2, 22, None, _blk(2.0)))
    await eng2.drain()
    assert store.contains(2)
    assert not eng2.offer(SpillJob(2, 22, None, _blk(2.0)))
    assert eng2.dropped_jobs_total == 0
    await eng2.stop()


# --------------------------------------------------------------- engines

ENGINE = dict(max_model_len=64, kv_block_size=4, num_kv_blocks=32,
              max_num_seqs=2, prefill_buckets=[32, 64])


@pytest.fixture(scope="module")
def np_params():
    return family_params()


def make_core(np_params, disk_dir, jax_side, host_blocks=16, model="llama"):
    return engine_core(np_params, model, jax_side, **dict(
        ENGINE, host_kv_blocks=host_blocks, kv_disk_dir=str(disk_dir),
        kv_disk_blocks=32))


async def serve(core, prompt, rid, max_new=4):
    """(tokens, prefix hit tokens) of one greedy request."""
    toks, _reason, hit = await serve_request(core, prompt, rid, max_new)
    return toks, hit


PA = list(range(1, 13))
PB = list(range(40, 52))


async def spill_and_promote(core):
    """A's host rows spill to disk under B's write-back, then A promotes
    from disk after a device wipe."""
    a, _ = await serve(core, PA, "a")
    await core.offload_engine.drain()
    await serve(core, PB, "b")
    await core.offload_engine.drain()
    await core.spill_engine.drain()
    core.kv_manager.pool.reset()
    a2, hit = await serve(core, PA, "a2")
    return a, a2, hit, core.disk_onboards


@pytest.mark.parametrize("model", list(MODELS))
async def test_host_eviction_spills_and_promotes_like_jax(
        np_params, tmp_path, model):
    out = []
    for side in ("jax", "port"):
        core = make_core(np_params, tmp_path / side, side == "jax",
                         host_blocks=3, model=model)
        try:
            out.append(await spill_and_promote(core))
            if side == "port":
                assert core.spill_engine.spilled_blocks_total >= 1
                m = core.metrics()
                assert m.disk_stored_total >= 1 and m.disk_hit_rate > 0
        finally:
            await core.stop()
    assert out[0] == out[1]
    a, a2, hit, disk_onboards = out[1]
    assert a2 == a and hit >= 4 and disk_onboards >= 1


@pytest.mark.parametrize("model", list(MODELS))
async def test_warm_restart_serves_prefix_from_disk_like_jax(np_params,
                                                             tmp_path, model):
    out = []
    for side in ("jax", "port"):
        d = tmp_path / side
        core = make_core(np_params, d, side == "jax", model=model)
        try:
            ref, hit1 = await serve(core, PA, "cold")
        finally:
            await core.stop()           # flushes host → disk
        assert hit1 == 0 and len(core.disk_store) >= 2
        core2 = make_core(np_params, d, side == "jax", model=model)
        try:
            assert core2.disk_store.restored_blocks >= 2
            warm, hit2 = await serve(core2, PA, "warm")
            out.append((ref, warm, hit2, core2.disk_onboards))
        finally:
            await core2.stop()
    assert out[0] == out[1]
    ref, warm, hit2, onboards = out[1]
    assert warm == ref and hit2 >= 8 and onboards == 1


async def test_flush_persists_more_than_the_spill_queue_holds(np_params,
                                                              tmp_path):
    """The stop's host→disk flush waits for room in a full spill queue:
    every host-resident block reaches the disk, none is dropped."""
    core = make_core(np_params, tmp_path / "kv", False)
    core.spill_engine.max_queue_jobs = 1
    try:
        await serve(core, PA, "a")
        await serve(core, PB, "b")
        await core.offload_engine.drain()
        resident = [h for h, *_ in core.kv_manager.host_pool
                    .resident_entries()]
        assert len(resident) >= 5
    finally:
        await core.stop()
    assert all(core.disk_store.contains(h) for h in resident)
    assert core.spill_engine.dropped_jobs_total == 0


async def test_slowed_disk_write_does_not_block_serving(np_params, tmp_path):
    """A spill whose file write is held by an event (a stuck disk) leaves
    the loop serving: a request whose admission asks the disk tier, and
    whose write-back evicts host rows, completes while the write waits.
    The hold sits inside ``put``'s write, where the store's locks are as a
    real slow write finds them."""
    core = make_core(np_params, tmp_path / "kv", False, host_blocks=3)
    gate = threading.Event()
    entered = threading.Event()
    left = threading.Event()
    store = core.disk_store
    real_write = store._write_block

    def held_write(*a, **k):
        entered.set()
        gate.wait(30)
        left.set()
        return real_write(*a, **k)
    store._write_block = held_write
    try:
        await serve(core, PA, "a")
        await core.offload_engine.drain()
        await serve(core, PB, "b")           # its write-back evicts A's rows
        await core.offload_engine.drain()
        for _ in range(2000):
            if entered.is_set():
                break
            await asyncio.sleep(0.005)
        assert entered.is_set(), "no spill reached the disk"
        # the write is held: the loop still serves a fresh request
        queries = store.match_queries
        toks, _ = await serve(core, list(range(80, 90)), "c")
        await core.offload_engine.drain()
        assert len(toks) == 4 and not left.is_set()
        assert store.match_queries > queries
        gate.set()
        await core.spill_engine.drain()
        assert core.spill_engine.spilled_blocks_total >= 1
    finally:
        gate.set()
        await core.stop()


async def test_tiered_run_replays_and_passes_jax_checkers(np_params,
                                                          tmp_path):
    core = make_core(np_params, tmp_path / "kv", False, host_blocks=3)
    core.recorder = replay.Recorder()
    try:
        await spill_and_promote(core)
        await serve(core, PB, "b2")       # B restored from the host tier
    finally:
        await core.stop()
    events = core.recorder.events
    kinds = {e["ev"] for e in events}
    assert {"kv_store", "kv_disk_store", "hit_transfer"} <= kinds
    hits = [e for e in events if e["ev"] == "hit_transfer"]
    assert any(e["disk_hit"] > 0 for e in hits)
    assert any(e["host_hit"] > 0 for e in hits)
    out = replay.replay(core, events)
    assert replay.compare_replay(events, out) == []
    assert out["prefill"]
    assert jreplay.check_log(events, ENGINE["kv_block_size"]) == []
    assert jreplay.check_inputs(events) == []
