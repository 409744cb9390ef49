"""The port's KV router (``dynamo_tpu_torch/llm/kv_router/``) against the JAX
package's on the CPU:

- the same seeded streams of stored (device / host / disk tiers) and
  removed events and of worker metrics, and the same requests, through
  the port's router and the JAX one (its native radix tree): the same
  overlap scores (raw, tier-weighted, remote), block frequencies, chosen
  workers and ``KVHitRateEvent`` stream, including after a worker is gone;
- the cases of the JAX suite's ``tests/test_kv_router.py`` that have a
  port counterpart: the radix index (consecutive matches, pruning, a sole
  chain holder, re-rooted duplicate hashes, frequencies on a driven clock,
  both against the JAX native tree), the indexer's event flow, the
  scheduler's cost behaviour (each case also against the JAX scheduler),
  a router over mock workers, an engine publishing to an indexer, and the
  pool re-announce after a lease reclaim;
- the wire: the port's events and metrics read by the JAX package and the
  reverse, and ``ForwardPassMetrics.from_dict`` of a port engine's
  metrics dropping nothing;
- the engine's ``reannounce_kv`` (parents before children, then a
  warm-started disk tier) and the launcher's ``wire_kv_events`` over a real
  daemon restart: the lease reclaim re-announces the pool and the
  router's index recovers.
"""

import asyncio
import dataclasses
import json
import random

import numpy as np
import pytest

from dynamo_tpu.llm.kv_router import ForwardPassMetrics as JMetrics
from dynamo_tpu.llm.kv_router import KvRouter as JKvRouter
from dynamo_tpu.llm.kv_router import KvScheduler as JKvScheduler
from dynamo_tpu.llm.kv_router import RouterEvent as JRouterEvent
from dynamo_tpu.llm.kv_router.indexer import RadixIndexNative as JNative
from dynamo_tpu.llm.kv_router.scoring import Endpoint as JEndpoint
from dynamo_tpu.llm.kv_router.scoring import \
    ProcessedEndpoints as JProcessedEndpoints
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.core import (FINISH_SENTINEL, EngineCore,
                                          EngineRequest)
from dynamo_tpu_torch.engine.sampling import SlotSampling
from dynamo_tpu_torch.llm.kv.blocks import compute_block_hashes
from dynamo_tpu_torch.llm.kv.pool import make_kv_block_pool
from dynamo_tpu_torch.llm.kv_router import (Endpoint, ForwardPassMetrics,
                                            KvIndexer, KvRouter, KvScheduler,
                                            ProcessedEndpoints, RouterEvent)
from dynamo_tpu_torch.llm.kv_router.indexer import RadixIndexPython
from dynamo_tpu_torch.llm.kv_router.protocols import (KvRemovedEvent,
                                                      KvStoredEvent)
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher

pytestmark = pytest.mark.anyio

BS = 4
WAIT = 10.0


# ------------------------------------------ the routers on the same streams

def _event_stream(rng, n_workers, chains, n):
    """Seeded RouterEvent dicts: chains stored in runs (sometimes in a
    colder tier), removals of stored hashes, and re-stores."""
    out = []
    for _ in range(n):
        w = int(rng.integers(0, n_workers)) + 1
        chain = chains[int(rng.integers(0, len(chains)))]
        if rng.random() < 0.75:
            a = int(rng.integers(0, len(chain) - 1))
            b = int(rng.integers(a + 1, min(len(chain), a + 6) + 1))
            tier = rng.choice(["device", "device", "device", "host", "disk",
                               "remote"])
            out.append({"worker_id": w, "event_id": len(out) + 1,
                        "stored": {"parent_hash": chain[a - 1] if a else None,
                                   "block_hashes": chain[a:b],
                                   "tokens_hashes": [], "lora_id": 0,
                                   "tier": str(tier)}})
        else:
            k = int(rng.integers(0, len(chain)))
            out.append({"worker_id": w, "event_id": len(out) + 1,
                        "removed": {"block_hashes": chain[k:k + 2]}})
    return out


def _metrics(rng, n_workers):
    return {w: {"request_active_slots": int(rng.integers(0, 8)),
                "request_total_slots": 8,
                "kv_active_blocks": int(rng.integers(0, 60)),
                "kv_total_blocks": 100,
                "remote_link_gbps": float(rng.choice([0.0, 25.0])),
                "kv_bytes_per_block": 65536,
                "prefill_tok_per_s": float(rng.choice([0.0, 5e4]))}
            for w in range(1, n_workers + 1)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_decisions_match_jax(seed):
    rng = np.random.default_rng(seed)
    tokens = [rng.integers(1, 1000, size=40).tolist() for _ in range(6)]
    chains = [compute_block_hashes(t, BS) for t in tokens]
    t_hits, j_hits = [], []
    port = KvRouter(BS, on_hit_rate=lambda e: t_hits.append(
        dataclasses.asdict(e)), frequency_expiration_s=5.0)
    jax = JKvRouter(BS, on_hit_rate=lambda e: j_hits.append(
        dataclasses.asdict(e)), frequency_expiration_s=5.0)
    n_workers = 4
    for rnd in range(12):
        for ev in _event_stream(rng, n_workers, chains, 15):
            port.on_kv_event(RouterEvent.from_dict(ev))
            jax.on_kv_event(JRouterEvent.from_dict(ev))
        if rnd % 3 == 0:
            m = _metrics(rng, n_workers)
            port.on_metrics(m)
            jax.on_metrics(m)
        if rnd == 8:
            port.on_worker_gone(2)
            jax.on_worker_gone(2)
            assert port.indexer.worker_blocks(2) == 0
        for _ in range(4):
            t = tokens[int(rng.integers(0, len(tokens)))]
            t = t[:int(rng.integers(BS, len(t) + 1))]
            ours = port.indexer.find_matches_for_request(t)
            theirs = jax.indexer.find_matches_for_request(t)
            assert ours.scores == theirs.scores
            assert ours.weighted == pytest.approx(theirs.weighted)
            assert ours.remote_blocks == theirs.remote_blocks
            assert port.schedule(t) == jax.schedule(t)
            assert port.last_frequencies == jax.last_frequencies
    assert t_hits == j_hits and len(t_hits) >= 40
    assert any(h["overlap_blocks"] > 0 for h in t_hits)


# ----------------------------------------------------------- the radix index

def test_index_consecutive_requirement():
    idx = RadixIndexPython()
    h = compute_block_hashes(list(range(16)), BS)  # 4 blocks
    idx.apply_stored(1, None, h)          # worker 1 has all 4
    idx.apply_stored(2, None, h[:1])      # worker 2 has block 0 only
    idx.apply_stored(3, None, h[:1])      # worker 3: blocks 0 and 2 (gap)
    idx.apply_stored(3, h[1], h[2:3])
    assert idx.find_matches(h).scores == {1: 4, 2: 1, 3: 1}


def test_index_remove_worker_prunes():
    idx = RadixIndexPython()
    h = compute_block_hashes(list(range(8)), BS)
    idx.apply_stored(1, None, h)
    idx.apply_stored(2, None, h[:1])
    idx.remove_worker(1)
    assert idx.find_matches(h).scores == {2: 1}
    assert idx.node_count() == 1  # worker 1's deeper node pruned


def test_remove_worker_sole_chain_holder():
    idx, ref = RadixIndexPython(), JNative()
    h = compute_block_hashes(list(range(40)), BS)  # 10-block chain
    for i in (idx, ref):
        i.apply_stored(7, None, h)
        i.remove_worker(7)
        assert i.node_count() == 0 and i.find_matches(h).scores == {}
        i.remove_worker(7)               # a no-op, the tree still usable
        i.apply_stored(8, None, h[:2])
    assert idx.find_matches(h).scores == ref.find_matches(h).scores == {8: 2}


def test_duplicate_hash_reroot_matches_jax_native():
    """Out-of-order events root a hash at two positions; both trees keep
    the same flat-map winner, so removals agree."""
    idx, ref = RadixIndexPython(), JNative()
    h = compute_block_hashes(list(range(12)), BS)
    for i in (idx, ref):
        i.apply_stored(1, h[0], h[1:2])   # parent unknown: re-rooted
        i.apply_stored(1, None, h[:1])    # parent arrives
        i.apply_stored(1, h[0], h[1:2])   # child again, correct position
        i.apply_removed(1, h[1:2])
    assert idx.node_count() == ref.node_count()
    assert idx.find_matches(h).scores == ref.find_matches(h).scores


def test_frequency_tracking_matches_jax_native():
    idx, ref = (RadixIndexPython(expiration_s=10.0),
                JNative(expiration_s=10.0))
    h = compute_block_hashes(list(range(16)), BS)
    got = []
    for i in (idx, ref):
        i.apply_stored(1, None, h)
        got.append([(r.scores, r.frequencies) for r in (
            i.find_matches(h, now=0.0), i.find_matches(h, now=1.0),
            i.find_matches(h[:2], now=2.0), i.find_matches(h, now=11.5))])
    assert got[0] == got[1]
    assert [f for _, f in got[0]] == [[], [1, 1, 1, 1], [2, 2], [1, 1]]
    assert RadixIndexPython().find_matches(h).frequencies == []


async def test_kv_indexer_event_flow_and_frequencies():
    indexer = KvIndexer(BS, expiration_s=60.0)
    tokens = list(range(12))
    h = compute_block_hashes(tokens, BS)
    await indexer.enqueue_event(RouterEvent(
        worker_id=7, stored=KvStoredEvent(parent_hash=None, block_hashes=h)))
    await asyncio.wait_for(indexer.drain(), WAIT)
    assert indexer.find_matches_for_request(tokens).frequencies == []
    r = indexer.find_matches_for_request(tokens)
    assert r.scores == {7: 3} and r.frequencies == [1, 1, 1]
    await indexer.enqueue_event(RouterEvent(
        worker_id=7, removed=KvRemovedEvent(block_hashes=[h[-1]])))
    await asyncio.wait_for(indexer.drain(), WAIT)
    assert indexer.find_matches_for_request(tokens).scores == {7: 2}
    assert indexer.worker_blocks(7) == 2


# -------------------------------------------------------------- the scheduler

def _eps(loads, slots=(0, 8), jax=False):
    ep, fpm, pe = ((JEndpoint, JMetrics, JProcessedEndpoints) if jax else
                   (Endpoint, ForwardPassMetrics, ProcessedEndpoints))
    return pe([ep(worker_id=i, metrics=fpm(
        request_active_slots=slots[0], request_total_slots=slots[1],
        kv_active_blocks=load, kv_total_blocks=100))
        for i, load in enumerate(loads)])


SCHEDULER_CASES = {
    # equal load → cache-hit weighted (alpha = 0.3): the overlap wins
    "prefers_overlap_when_balanced": ([10, 10, 10], (0, 8), 64, {2: 10}),
    # full overlap on a massively overloaded worker → balance mode
    "balance_mode_avoids_hot_worker": ([95, 2, 2], (0, 8), 64, {0: 16}),
    # a burst must not dogpile one worker (optimistic accounting)
    "optimistic_accounting_spreads_burst": ([0, 0, 0, 0], (0, 8), 256, {}),
}


@pytest.mark.parametrize("case", list(SCHEDULER_CASES))
def test_scheduler_cases_match_jax(case):
    loads, slots, isl, overlap = SCHEDULER_CASES[case]
    t_ev, j_ev = [], []
    ours = KvScheduler(BS, on_hit_rate=t_ev.append)
    theirs = JKvScheduler(BS, on_hit_rate=j_ev.append)
    ours.update_endpoints(_eps(loads, slots))
    theirs.update_endpoints(_eps(loads, slots, jax=True))
    picks = [ours.schedule(isl_tokens=isl, overlap_scores=overlap)
             for _ in range(8)]
    assert picks == [theirs.schedule(isl_tokens=isl, overlap_scores=overlap)
                     for _ in range(8)]
    assert [dataclasses.asdict(e) for e in t_ev] == \
        [dataclasses.asdict(e) for e in j_ev]
    if case == "prefers_overlap_when_balanced":
        assert picks[0] == 2
    elif case == "balance_mode_avoids_hot_worker":
        assert picks[0] != 0
    else:
        assert len(set(picks)) > 1


def test_scheduler_skips_full_workers():
    eps = ProcessedEndpoints([
        Endpoint(worker_id=0, metrics=ForwardPassMetrics(
            request_active_slots=8, request_total_slots=8)),
        Endpoint(worker_id=1, metrics=ForwardPassMetrics(
            request_active_slots=0, request_total_slots=8,
            kv_active_blocks=50))])
    events = []
    s = KvScheduler(BS, on_hit_rate=events.append)
    s.update_endpoints(eps)
    assert s.schedule(isl_tokens=32, overlap_scores={0: 8}) == 1
    assert len(events) == 1 and events[0].isl_blocks == 8
    assert events[0].overlap_blocks == 0


def test_scheduler_tie_break_is_seeded():
    """The tie-break shuffle is ``random.Random(0)``'s: two schedulers (or
    two runs) make the same choices."""
    a, b = KvScheduler(BS), KvScheduler(BS, rng=random.Random(0))
    for s in (a, b):
        s.update_endpoints(_eps([5, 5, 5, 5]))
    assert [a.schedule(8, {}) for _ in range(6)] == \
        [b.schedule(8, {}) for _ in range(6)]


def test_full_router_with_mock_workers():
    """A request whose prefix lives on worker 2 routes there; once worker
    2 is gone it routes elsewhere with no overlap."""
    router = KvRouter(BS)
    tokens = list(range(32))
    h = compute_block_hashes(tokens, BS)
    router.on_kv_event(RouterEvent(
        worker_id=2, stored=KvStoredEvent(parent_hash=None,
                                          block_hashes=h[:6])))
    router.on_metrics({
        w: ForwardPassMetrics(request_total_slots=8, kv_active_blocks=load,
                              kv_total_blocks=100)
        for w, load in ((0, 10), (1, 10), (2, 12))})
    assert router.schedule(tokens) == (2, 6)
    router.on_worker_gone(2)
    router.on_metrics({w: {"request_total_slots": 8, "kv_active_blocks": 10}
                       for w in (0, 1)})
    worker, overlap = router.schedule(tokens)
    assert worker in (0, 1) and overlap == 0


# ------------------------------------------------------------------- the wire

def test_events_and_metrics_cross_the_packages():
    ev = RouterEvent(worker_id=9, event_id=3, stored=KvStoredEvent(
        parent_hash=11, block_hashes=[12, 13], tokens_hashes=[1, 2],
        tier="disk"))
    rm = RouterEvent(worker_id=9, event_id=4,
                     removed=KvRemovedEvent(block_hashes=[13]))
    for e in (ev, rm):
        assert JRouterEvent.from_dict(e.to_dict()).to_dict() == e.to_dict()
        assert RouterEvent.from_dict(
            JRouterEvent.from_dict(e.to_dict()).to_dict()) == e
    # every JAX metrics field is the port's, the port adds its own at the end
    jf = [f.name for f in dataclasses.fields(JMetrics)]
    tf = [f.name for f in dataclasses.fields(ForwardPassMetrics)]
    assert tf[:len(jf)] == jf
    j = JMetrics(kv_active_blocks=5, disk_used_blocks=2)
    assert ForwardPassMetrics.from_dict(j.to_dict()).to_dict() == \
        {**j.to_dict(), **{k: 0 for k in tf[len(jf):]}}


def _tiny_core(**cfg):
    mcfg = ModelConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                       num_layers=1, num_heads=2, num_kv_heads=2, head_dim=16,
                       max_position_embeddings=128)
    kw = dict(max_model_len=64, kv_block_size=8, num_kv_blocks=16,
              max_num_seqs=2)
    kw.update(cfg)
    return EngineCore(mcfg, EngineConfig(dtype="float32", **kw),
                      device="cpu")


async def _run(core, prompt, rid="x", max_new=4):
    req = EngineRequest(rid=rid, prompt=prompt,
                        sampling=SlotSampling(temperature=0.0),
                        max_new_tokens=max_new, eos_ids=frozenset())
    await core.submit(req)
    while True:
        item, _ = await asyncio.wait_for(req.out_queue.get(), 60)
        if item is FINISH_SENTINEL:
            return req


async def test_engine_publishes_kv_events_to_router():
    """Engine block registration flows through the publisher into a
    router's indexer; the engine's metrics read through the router's
    ``ForwardPassMetrics`` lose nothing."""
    indexer = KvIndexer(8)

    async def sink(ev):
        indexer.apply_event(ev)

    core = _tiny_core()
    core.kv_event_publisher = KvEventPublisher(worker_id=42, sink=sink)
    prompt = np.random.default_rng(0).integers(1, 64, size=20).tolist()
    try:
        await _run(core, prompt)
        await asyncio.wait_for(core.kv_event_publisher.drain(), WAIT)
        d = core.metrics().to_dict()
    finally:
        await core.stop()
    assert indexer.find_matches_for_request(prompt).scores == {42: 2}
    assert ForwardPassMetrics.from_dict(d).to_dict() == {
        **ForwardPassMetrics().to_dict(), **d}


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
async def test_pool_reannounce_recovers_index_after_lease_reclaim(native):
    """A transient lease expiry wipes the worker's blocks from the index;
    the pool's re-announce replays every stored block (parents first) and
    the index recovers; invalidated blocks are not replayed."""
    indexer = KvIndexer(BS)

    async def sink(ev):
        indexer.apply_event(ev)

    pub = KvEventPublisher(worker_id=5, sink=sink)
    pool = make_kv_block_pool(16, on_stored=pub.publish_stored,
                              on_removed=pub.publish_removed,
                              prefer_native=native)
    tokens = list(range(16))                       # 4 chained blocks
    h = compute_block_hashes(tokens, BS)
    bids = pool.alloc_uninit(len(h))
    parent = None
    for bid, sh in zip(bids, h):
        pool.register(bid, sh, sh ^ 0xABCD, parent)
        parent = sh
    await asyncio.wait_for(pub.drain(), WAIT)
    assert indexer.find_matches_for_request(tokens).scores == {5: 4}
    indexer.remove_worker(5)
    assert indexer.find_matches_for_request(tokens).scores == {}
    assert pool.reannounce() == 4
    await asyncio.wait_for(pub.drain(), WAIT)
    assert indexer.find_matches_for_request(tokens).scores == {5: 4}
    pool.release(bids)
    pool.reset()
    await asyncio.wait_for(pub.drain(), WAIT)
    assert pool.reannounce() == 0


async def test_engine_reannounce_kv_parents_first_then_disk(tmp_path):
    """``reannounce_kv`` replays the device pool parents first, then the
    disk tier's blocks the device pool lacks, tagged "disk"; a warm-started
    disk tier alone is announced the same way."""
    prompt = np.random.default_rng(3).integers(1, 64, size=33).tolist()
    core = _tiny_core(num_kv_blocks=12, host_kv_blocks=4,
                      kv_disk_dir=str(tmp_path), kv_disk_blocks=32)
    try:
        await _run(core, prompt)
        await core.flush_host_to_disk()
    finally:
        await core.stop()
    for cold in (False, True):
        seen = []

        class Rec:
            def publish_stored(self, bid, h, th, ph, tier="device"):
                seen.append((h, ph, tier))

        core = _tiny_core(num_kv_blocks=12, host_kv_blocks=4,
                          kv_disk_dir=str(tmp_path), kv_disk_blocks=32)
        core.kv_event_publisher = Rec()
        try:
            if not cold:
                await _run(core, prompt, rid="again")
            seen.clear()               # the live announces of the run
            n = core.reannounce_kv()
        finally:
            await core.stop()
        assert n == len(seen) and n >= 4
        # the device pool replays every parent before its child (the disk
        # tier's blocks follow in the store's order, as in the JAX engine)
        order = [h for h, _, t in seen if t == "device"]
        for h, ph, tier in seen:
            if tier == "device" and ph in order:
                assert order.index(ph) < order.index(h)
        tiers = [t for _, _, t in seen]
        if cold:
            assert set(tiers) == {"disk"}
        else:
            assert tiers[0] == "device"
            # the device announces precede the disk tier's
            assert tiers == sorted(tiers, key=lambda t: t != "device")


async def test_lease_reclaim_reannounces_the_pool(tmp_path):
    """The launcher's ``wire_kv_events`` over a real daemon: the daemon
    restarts empty, the worker's keepalive reclaims its lease id, and the
    re-announced pool rebuilds a router's index of this worker."""
    from dynamo_tpu_torch.launch.run import wire_kv_events
    from dynamo_tpu_torch.llm.kv_router.protocols import KV_EVENTS_SUBJECT
    from dynamo_tpu_torch.runtime.distributed import (DistributedRuntime,
                                                      Endpoint)
    from dynamo_tpu_torch.runtime.server import DiscoveryServer

    daemon = DiscoveryServer(host="127.0.0.1")
    await daemon.start()
    worker_rt = await DistributedRuntime.connect(daemon.address)
    router_rt = await DistributedRuntime.connect(daemon.address)
    worker_rt.LEASE_TTL = 1.5            # keepalive refreshes every 0.5 s
    core = _tiny_core()
    indexer = KvIndexer(8)
    sub = None
    try:
        ep = Endpoint.parse_path(worker_rt, "dyn://rt/worker/generate")
        await wire_kv_events(core, worker_rt, ep)
        comp = router_rt.namespace("rt").component("worker")
        sub = await comp.subscribe_event(KV_EVENTS_SUBJECT)
        reclaimed = asyncio.Event()
        inner = worker_rt.store.on_lease_reclaimed
        worker_rt.store.on_lease_reclaimed = lambda lid: (inner(lid),
                                                          reclaimed.set())
        prompt = np.random.default_rng(1).integers(1, 64, size=20).tolist()
        await _run(core, prompt)
        wid = worker_rt.worker_id

        async def pump(stop_at):
            while indexer.find_matches_for_request(prompt).scores != stop_at:
                msg = await sub.next(timeout=WAIT)
                assert msg is not None, "no kv event"
                indexer.apply_event(RouterEvent.from_dict(
                    json.loads(msg.payload)))

        await asyncio.wait_for(pump({wid: 2}), WAIT)
        indexer.remove_worker(wid)     # what a router does on the DELETE
        reclaimed.clear()
        port = daemon.port
        await daemon.close()
        daemon = DiscoveryServer(host="127.0.0.1", port=port)
        await daemon.start()
        await asyncio.wait_for(reclaimed.wait(), WAIT)
        await asyncio.wait_for(pump({wid: 2}), WAIT)
        assert worker_rt.worker_id == wid
    finally:
        if sub is not None:
            sub.close()
        await core.stop()
        await router_rt.shutdown()
        await worker_rt.shutdown()
        await daemon.close()

