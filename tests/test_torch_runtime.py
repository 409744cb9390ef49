"""The port's distributed runtime (``dynamo_tpu_torch.runtime``) on the CPU,
mirroring the JAX package's ``tests/test_distributed_runtime.py`` and
``tests/test_discovery_resilience.py``, and held against the JAX package's
runtime across the wire:

- the codec's frames and two-part request messages, byte for byte against
  ``dynamo_tpu.runtime.codec``, and each package decoding the other's;
- the memory KV store (create / validate / watch / delete / cas), leases
  (keepalive refreshes, expiry on a driven clock, revoke), the bus
  (serve, broadcast, queue redelivery);
- endpoints served and called in one process (round robin, direct,
  removal on stop, remote errors, a client kill reaching the worker,
  stats, path parsing, fire-and-forget dedup), and through a daemon over
  TCP (lease expiry, calls across a daemon restart, lease reclaim with key
  replay, a watch surviving the restart);
- a port worker and caller against the JAX daemon, and JAX ones against
  the port's daemon, each daemon a subprocess: one endpoint served by one
  package and called by the other, both ways.

No test waits on a fixed sleep: each wait is an awaited event or a bounded
poll of a condition, with a timeout.
"""

import asyncio
import json
import sys

import pytest

from dynamo_tpu.runtime import codec as jcodec
from dynamo_tpu.runtime.distributed import DistributedRuntime as JRuntime
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu.runtime.engine import ResponseStream as JResponseStream
from dynamo_tpu.runtime.engine import engine_from_fn as j_engine_from_fn
from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.runtime.bus import MemoryBus
from dynamo_tpu_torch.runtime.codec import (Frame, FrameKind,
                                            RequestControlMessage,
                                            decode_two_part, encode_two_part)
from dynamo_tpu_torch.runtime.distributed import (DistributedRuntime,
                                                  Endpoint, EndpointServer)
from dynamo_tpu_torch.runtime.engine import (Context, ResponseStream,
                                             engine_from_fn)
from dynamo_tpu_torch.runtime.kvstore import MemoryKvStore, WatchEventType
from dynamo_tpu_torch.runtime.server import DiscoveryServer

pytestmark = pytest.mark.anyio

WAIT = 10.0          # the bound of every wait below, in seconds


async def wait_until(pred, timeout=WAIT, what="condition"):
    """Poll ``pred()`` (sync or async) until true; fail after ``timeout``."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        got = pred()
        if asyncio.iscoroutine(got):
            got = await got
        if got:
            return got
        if loop.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


def counting_engine(n=5, stream_cls=ResponseStream, from_fn=engine_from_fn):
    async def gen(request):
        async def stream():
            for i in range(n):
                if request.ctx.is_stopped:
                    return
                yield {"i": i, "echo": request.data}
                await asyncio.sleep(0)
        return stream_cls(stream(), request.ctx)
    return from_fn(gen)


# ------------------------------------------------------------------ codec

CONTROL_MESSAGES = {
    "bare": dict(id="r1"),
    "stream": dict(id="r2", connection_info=("10.0.0.7:4242", "abc123")),
    "deadline_tenant": dict(id="r3", connection_info=("h:1", "s"),
                            deadline_ms=1234.5, tenant="t0",
                            priority="batch"),
    "many_in": dict(id="r4", request_type="many_in"),
}


def _control(mod, kw):
    kw = dict(kw)
    if "connection_info" in kw:
        addr, sid = kw["connection_info"]
        kw["connection_info"] = mod.ConnectionInfo(address=addr,
                                                   stream_id=sid)
    return mod.RequestControlMessage(**kw)


@pytest.mark.parametrize("name", list(CONTROL_MESSAGES))
def test_two_part_bytes_match_jax(name):
    payload = json.dumps({"token_ids": [1, 2, 3], "x": name}).encode()
    ours = encode_two_part(_control(codec, CONTROL_MESSAGES[name]), payload)
    theirs = jcodec.encode_two_part(_control(jcodec, CONTROL_MESSAGES[name]),
                                    payload)
    assert ours == theirs
    # each package decodes the other's message to the same fields
    c_t, p_t = decode_two_part(theirs)
    c_j, p_j = jcodec.decode_two_part(ours)
    assert p_t == p_j == payload
    assert c_t.to_json() == c_j.to_json()
    # the port sends no trace record; a received one is read and kept
    assert c_t.trace is None
    traced = _control(jcodec, CONTROL_MESSAGES[name])
    traced.trace = {"trace_id": "t", "parent_span": "p", "origin_ts": 1.0}
    c_back, _ = decode_two_part(jcodec.encode_two_part(traced, payload))
    assert c_back.trace == traced.trace and c_back.id == traced.id


FRAMES = {
    "data": (FrameKind.DATA, b'{"h": 1}', b"\x00payload\xff"),
    "prologue": (FrameKind.PROLOGUE, b'{"stream_id": "s", "error": null}',
                 b""),
    "error": (FrameKind.ERROR, b'{"error": "boom"}', b""),
}


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_bytes_match_jax(name):
    kind, header, data = FRAMES[name]
    ours = codec.encode_frame(Frame(kind, header, data))
    theirs = jcodec.encode_frame(jcodec.Frame(jcodec.FrameKind(int(kind)),
                                              header, data))
    assert ours == theirs


def test_control_frames_match_jax():
    for ours, theirs in ((codec.ControlMessage.stop(),
                          jcodec.ControlMessage.stop()),
                         (codec.ControlMessage.kill(),
                          jcodec.ControlMessage.kill()),
                         (codec.ControlMessage.sentinel(),
                          jcodec.ControlMessage.sentinel())):
        assert codec.encode_frame(ours) == jcodec.encode_frame(theirs)


# --------------------------------------------------------------- kvstore

async def test_kvstore_create_watch_delete():
    store = MemoryKvStore()
    assert await store.kv_create("a/b:1", b"v1")
    assert not await store.kv_create("a/b:1", b"v2")          # atomic create
    assert await store.kv_create_or_validate("a/b:1", b"v1")  # same value ok
    assert not await store.kv_create_or_validate("a/b:1", b"other")
    w = await store.watch_prefix("a/")
    ev = await w.next(timeout=WAIT)
    assert ev.type == WatchEventType.PUT and ev.entry.key == "a/b:1"
    await store.kv_put("a/c:2", b"v2")
    assert (await w.next(timeout=WAIT)).entry.key == "a/c:2"
    await store.kv_delete("a/b:1")
    assert (await w.next(timeout=WAIT)).type == WatchEventType.DELETE
    w.close()


async def test_kvstore_cas():
    store = MemoryKvStore()
    assert await store.kv_cas("k", None, b"v1")          # create-if-absent
    assert not await store.kv_cas("k", None, b"v2")      # exists now
    assert not await store.kv_cas("k", b"stale", b"v2")  # wrong expected
    assert await store.kv_cas("k", b"v1", b"v2")
    assert (await store.kv_get("k")).value == b"v2"


async def test_lease_expiry_deletes_keys_and_fires_watch():
    t = [0.0]
    store = MemoryKvStore(now=lambda: t[0])
    lease = await store.lease_create(ttl=1.0)
    await store.kv_put("ns/components/c/e:%x" % lease.id, b"info",
                       lease_id=lease.id)
    w = await store.watch_prefix("ns/components/")
    assert (await w.next(timeout=WAIT)).type == WatchEventType.PUT
    t[0] = 2.0  # past the TTL without a refresh
    store._expire_due()
    assert (await w.next(timeout=WAIT)).type == WatchEventType.DELETE
    assert await store.kv_get_prefix("ns/") == []
    assert not await store.lease_refresh(lease.id)
    await store.close()


async def test_lease_keepalive_refreshes_and_revoke_deletes():
    """The keepalive task refreshes every TTL/3 (each refresh moves the
    lease's deadline); a revoke stops it and drops the lease's keys."""
    store = MemoryKvStore()
    refreshed = asyncio.Event()
    seen = []
    real_refresh = store.lease_refresh

    async def counting_refresh(lease_id):
        seen.append(lease_id)
        if len(seen) >= 3:
            refreshed.set()
        return await real_refresh(lease_id)

    store.lease_refresh = counting_refresh
    lease = await store.lease_create(ttl=0.15)
    await store.kv_put("k", b"v", lease_id=lease.id)
    lease.start_keepalive()
    await asyncio.wait_for(refreshed.wait(), WAIT)
    assert set(seen) == {lease.id}
    assert (await store.kv_get("k")).value == b"v"
    w = await store.watch_prefix("k")
    assert (await w.next(timeout=WAIT)).type == WatchEventType.PUT
    await lease.revoke()
    assert (await w.next(timeout=WAIT)).type == WatchEventType.DELETE
    assert await store.kv_get("k") is None
    assert not await real_refresh(lease.id)
    await store.close()


# ------------------------------------------------------------------- bus

async def test_bus_serve_and_broadcast():
    bus = MemoryBus()
    srv = await bus.serve("ns|c.e-1")
    sub1 = await bus.subscribe("evt.ns.*")
    sub2 = await bus.subscribe("evt.ns.*")
    await bus.publish("ns|c.e-1", b"req")
    await bus.publish("evt.ns.kv_events", b"ev")
    assert (await srv.next(timeout=WAIT)).payload == b"req"
    assert (await sub1.next(timeout=WAIT)).payload == b"ev"
    assert (await sub2.next(timeout=WAIT)).payload == b"ev"
    with pytest.raises(RuntimeError):
        await bus.serve("ns|c.e-1")  # exactly-one server per subject


async def test_work_queue_ack_nack_redelivery():
    bus = MemoryBus()
    q = await bus.work_queue("prefill")
    await q.enqueue(b"job1")
    await q.enqueue(b"job2")
    assert await q.depth() == 2
    item = await q.dequeue(timeout=WAIT, ack_deadline=30.0)
    assert item.payload == b"job1"
    await q.nack(item.id)                      # explicit return
    item = await q.dequeue(timeout=WAIT)
    assert item.payload == b"job1" and item.deliveries == 2
    await q.ack(item.id)
    item2 = await q.dequeue(timeout=WAIT, ack_deadline=0.05)
    # the deadline passes un-acked: the item comes back on redelivery
    item2b = await q.dequeue(timeout=WAIT)
    assert item2b.payload == item2.payload and item2b.deliveries == 2
    await q.ack(item2b.id)
    assert await q.dequeue(timeout=0.05) is None


# ----------------------------------------------------- in-process endpoints

async def test_serve_and_call_endpoint_roundtrip():
    rt = DistributedRuntime.in_process()
    ep = rt.namespace("ns").component("worker").endpoint("generate")
    await ep.serve(counting_engine(3))
    client = await ep.client().start()
    await client.wait_for_instances(timeout=WAIT)
    items = await (await client.generate(Context({"prompt": "hi"}))).collect()
    assert [d["i"] for d in items] == [0, 1, 2]
    assert items[0]["echo"] == {"prompt": "hi"}
    await client.close()
    await rt.shutdown()


async def test_routing_round_robin_and_direct():
    rt = DistributedRuntime.in_process()
    hits = {"a": 0, "b": 0}

    def make(name):
        async def gen(request):
            hits[name] += 1
            return ResponseStream.from_iterable([{"w": name}], request.ctx)
        return engine_from_fn(gen)

    # two runtimes sharing one store/bus = two worker instances
    rt2 = DistributedRuntime(rt.store, rt.bus)
    ep1 = rt.namespace("ns").component("w").endpoint("gen")
    ep2 = rt2.namespace("ns").component("w").endpoint("gen")
    await ep1.serve(make("a"))
    s2 = await ep2.serve(make("b"))
    client = await ep1.client().start()
    await wait_until(lambda: len(client.instances) == 2, what="2 instances")
    for _ in range(4):
        await (await client.round_robin(Context({}))).collect()
    assert hits["a"] == 2 and hits["b"] == 2
    out = await (await client.direct(Context({}), s2.lease_id)).collect()
    assert out == [{"w": "b"}] and hits["b"] == 3
    await client.close()
    await rt2.shutdown()
    await rt.shutdown()


async def test_instance_removed_on_server_stop():
    rt = DistributedRuntime.in_process()
    ep = rt.namespace("ns").component("w").endpoint("gen")
    server = await ep.serve(counting_engine(1))
    client = await ep.client().start()
    await client.wait_for_instances(timeout=WAIT)
    await server.stop()
    await wait_until(lambda: not client.instances, what="instance removal")
    await client.close()
    await rt.shutdown()


async def test_remote_error_propagates():
    rt = DistributedRuntime.in_process()

    async def bad(request):
        raise ValueError("engine exploded")

    ep = rt.namespace("ns").component("w").endpoint("gen")
    await ep.serve(engine_from_fn(bad))
    client = await ep.client().start()
    await client.wait_for_instances(timeout=WAIT)
    with pytest.raises(RuntimeError, match="engine exploded"):
        await client.generate(Context({}))
    await client.close()
    await rt.shutdown()


async def test_client_kill_reaches_worker_context():
    rt = DistributedRuntime.in_process()
    stopped = asyncio.Event()
    seen = {"count": 0}

    async def slow(request):
        async def stream():
            for i in range(1000):
                if request.ctx.is_stopped:
                    stopped.set()
                    return
                seen["count"] = i
                yield {"i": i}
                await asyncio.sleep(0.01)
        return ResponseStream(stream(), request.ctx)

    ep = rt.namespace("ns").component("w").endpoint("gen")
    await ep.serve(engine_from_fn(slow))
    client = await ep.client().start()
    await client.wait_for_instances(timeout=WAIT)
    ctx = Context({})
    got = 0
    async for _item in await client.generate(ctx):
        got += 1
        if got == 3:
            ctx.ctx.kill()
    assert got == 3
    # the worker observes the kill through the upstream control frame
    await asyncio.wait_for(stopped.wait(), WAIT)
    assert seen["count"] < 999
    await client.close()
    await rt.shutdown()


async def test_stats_scrape():
    rt = DistributedRuntime.in_process()
    ep = rt.namespace("ns").component("w").endpoint("gen")
    server = await ep.serve(counting_engine(1),
                            stats_handler=lambda: {"kv_active_blocks": 7},
                            stats_interval=0.05)
    client = await ep.client().start()
    await client.wait_for_instances(timeout=WAIT)
    stats = await wait_until(client.collect_stats, what="stats")
    assert stats[server.lease_id]["kv_active_blocks"] == 7
    await client.close()
    await rt.shutdown()


async def test_endpoint_path_parsing():
    rt = DistributedRuntime.in_process()
    ep = Endpoint.parse_path(rt, "dyn://ns/comp/ep")
    assert (ep.namespace, ep.component, ep.name) == ("ns", "comp", "ep")
    assert Endpoint.parse_path(rt, "ns.comp.ep").path == "dyn://ns/comp/ep"
    with pytest.raises(ValueError):
        Endpoint.parse_path(rt, "dyn://only/two")
    with pytest.raises(ValueError):
        Endpoint.parse_path(rt, "dyn://bad|ns/c/e")
    await rt.shutdown()


class _Once:
    def __init__(self, fail_first=False):
        self.calls = 0
        self.fail_first = fail_first

    async def generate(self, ctx):
        self.calls += 1
        if self.fail_first and self.calls == 1:
            raise RuntimeError("transient overload")

        async def gen():
            yield b"ok"
        return gen()


async def test_fire_and_forget_duplicate_dropped():
    eng = _Once()
    srv = EndpointServer(endpoint=None, engine=eng,
                         decode_req=lambda b: b, encode_resp=lambda x: x)
    payload = encode_two_part(
        RequestControlMessage(id="ff-1", connection_info=None), b"body")
    await srv._handle(payload)
    await srv._handle(payload)          # duplicate redelivery
    assert eng.calls == 1
    await srv._handle(encode_two_part(
        RequestControlMessage(id="ff-2", connection_info=None), b"body"))
    assert eng.calls == 2               # a distinct id is still served


async def test_fire_and_forget_retry_after_failure_executes():
    eng = _Once(fail_first=True)
    srv = EndpointServer(endpoint=None, engine=eng,
                         decode_req=lambda b: b, encode_resp=lambda x: x)
    payload = encode_two_part(
        RequestControlMessage(id="ff-retry", connection_info=None), b"body")
    await srv._handle(payload)          # attempt 1: the engine rejects
    await srv._handle(payload)          # redelivery: must run
    assert eng.calls == 2
    await srv._handle(payload)          # a second success IS a duplicate
    assert eng.calls == 2


# ------------------------------------------------------ through the daemon

async def test_networked_runtime_end_to_end():
    daemon = DiscoveryServer()
    await daemon.start()
    worker_rt = await DistributedRuntime.connect(daemon.address)
    caller_rt = await DistributedRuntime.connect(daemon.address)
    try:
        await (worker_rt.namespace("ns").component("w").endpoint("gen")
               .serve(counting_engine(4)))
        client = await (caller_rt.namespace("ns").component("w")
                        .endpoint("gen").client().start())
        await client.wait_for_instances(timeout=WAIT)
        items = await (await client.generate(Context({"q": 42}))).collect()
        assert [d["i"] for d in items] == [0, 1, 2, 3]
        assert items[0]["echo"] == {"q": 42}
        q1 = await worker_rt.bus.work_queue("prefill_queue")
        q2 = await caller_rt.bus.work_queue("prefill_queue")
        await q1.enqueue(b"payload")
        item = await q2.dequeue(timeout=WAIT)
        assert item.payload == b"payload"
        await q2.ack(item.id)
        assert await caller_rt.store.kv_cas("k", None, b"v1")
        assert not await caller_rt.store.kv_cas("k", b"nope", b"v2")
        assert await worker_rt.store.kv_cas("k", b"v1", b"v2")
        await client.close()
    finally:
        await caller_rt.shutdown()
        await worker_rt.shutdown()
        await daemon.close()


async def test_networked_lease_expiry_removes_instance():
    """A worker that stops refreshing: the daemon expires its lease and
    the caller's client drops the instance."""
    daemon = DiscoveryServer()
    await daemon.start()
    worker_rt = await DistributedRuntime.connect(daemon.address)
    caller_rt = await DistributedRuntime.connect(daemon.address)
    try:
        worker_rt.LEASE_TTL = 0.3
        await (worker_rt.namespace("ns").component("w").endpoint("gen")
               .serve(counting_engine(1)))
        client = await (caller_rt.namespace("ns").component("w")
                        .endpoint("gen").client().start())
        await client.wait_for_instances(timeout=WAIT)
        worker_rt._primary_lease._task.cancel()   # abrupt: no revoke
        await wait_until(lambda: not client.instances, what="expiry")
        await client.close()
    finally:
        await caller_rt.shutdown()
        await worker_rt.shutdown()
        await daemon.close()


async def restart(srv: DiscoveryServer) -> DiscoveryServer:
    """Kill the daemon and bring up a FRESH one (empty state) on the same
    address — the worst restart case."""
    host, port = srv.host, srv.port
    await srv.close()
    srv2 = DiscoveryServer(host=host, port=port)
    await srv2.start()
    return srv2


async def test_calls_retry_across_restart():
    srv = DiscoveryServer(host="127.0.0.1")
    await srv.start()
    rt = await DistributedRuntime.connect(srv.address)
    try:
        await rt.store.kv_put("k1", b"v1")
        srv = await restart(srv)
        await rt.store.kv_put("k2", b"v2")       # reconnects transparently
        e = await rt.store.kv_get("k2")
        assert e is not None and e.value == b"v2"
        assert rt.store._conn.reconnects == 1
    finally:
        await rt.shutdown()
        await srv.close()


async def test_lease_reclaimed_and_keys_replayed():
    srv = DiscoveryServer(host="127.0.0.1")
    await srv.start()
    rt = await DistributedRuntime.connect(srv.address)
    rt.LEASE_TTL = 0.6                  # fast keepalive cycles
    try:
        lease = await rt.primary_lease()
        wid = lease.id
        await rt.store.kv_put("disc/worker", b"addr", lease_id=wid)
        lost, reclaimed = [], asyncio.Event()
        rt.on_lease_lost = lambda: lost.append(1)
        rt.store.on_lease_reclaimed = lambda lid: reclaimed.set()
        srv = await restart(srv)
        # the fresh daemon knows nothing; the next keepalive refresh
        # fails, reclaims the SAME lease id and replays the leased key
        await asyncio.wait_for(reclaimed.wait(), WAIT)
        e = await rt.store.kv_get("disc/worker")
        assert e is not None and e.value == b"addr" and e.lease_id == wid
        assert rt.worker_id == wid and not lost
    finally:
        await rt.shutdown()
        await srv.close()


async def test_watch_stream_survives_restart():
    srv = DiscoveryServer(host="127.0.0.1")
    await srv.start()
    rt_w = await DistributedRuntime.connect(srv.address)
    rt_p = await DistributedRuntime.connect(srv.address)
    try:
        watcher = await rt_w.store.watch_prefix("inst/")
        await rt_p.store.kv_put("inst/a", b"1")
        ev = await watcher.next(timeout=WAIT)
        assert ev is not None and ev.entry.key == "inst/a"
        srv = await restart(srv)
        # the watcher's connection replays its registration; the put
        # after the restart must reach the SAME watcher object
        await wait_until(lambda: rt_w.store._conn.reconnects >= 1,
                         what="watcher reconnect")
        await rt_p.store.kv_put("inst/b", b"2")

        async def got_b():
            e = await watcher.next(timeout=0.1)
            return e is not None and e.entry.key == "inst/b"
        await wait_until(got_b, what="inst/b on the replayed watch")
    finally:
        await rt_w.shutdown()
        await rt_p.shutdown()
        await srv.close()


# ------------------------------------------- across the packages, over TCP

DAEMONS = {"jax": "dynamo_tpu.runtime.server",
           "port": "dynamo_tpu_torch.runtime.server"}


async def start_daemon(module: str):
    """A daemon subprocess on a free port; returns (process, address)."""
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", module, "--host", "127.0.0.1", "--port", "0",
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.DEVNULL)
    try:
        while True:
            line = await asyncio.wait_for(proc.stdout.readline(), 60)
            if not line:
                raise AssertionError(f"{module} exited before listening")
            if b"listening on" in line:
                return proc, line.decode().rsplit(" ", 1)[-1].strip()
    except BaseException:
        proc.kill()
        await proc.wait()
        raise


async def stop_daemon(proc) -> None:
    proc.terminate()
    try:
        await asyncio.wait_for(proc.wait(), WAIT)
    except asyncio.TimeoutError:
        proc.kill()
        await proc.wait()


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
@pytest.mark.parametrize("daemon", list(DAEMONS))
async def test_cross_package_serve_and_call(daemon, server_pkg):
    """One package serves an endpoint through the daemon of ``daemon``,
    the other calls it: discovery, the bus request plane, the TCP
    dial-back, stats and a client kill all cross the packages."""
    proc, addr = await start_daemon(DAEMONS[daemon])
    port_rt = await DistributedRuntime.connect(addr)
    jax_rt = await JRuntime.connect(addr)
    try:
        if server_pkg == "port":
            srv_rt, call_rt, ctx_cls = port_rt, jax_rt, JContext
            engine = counting_engine(4)
        else:
            srv_rt, call_rt, ctx_cls = jax_rt, port_rt, Context
            engine = counting_engine(4, JResponseStream, j_engine_from_fn)
        server = await (srv_rt.namespace("xp").component("w")
                        .endpoint("gen").serve(
                            engine, stats_handler=lambda: {"kv_active_blocks": 3},
                            stats_interval=0.05))
        client = await (call_rt.namespace("xp").component("w")
                        .endpoint("gen").client().start())
        ids = await client.wait_for_instances(timeout=WAIT)
        assert ids == [server.lease_id]
        items = await (await client.direct(ctx_cls({"q": daemon}),
                                           server.lease_id)).collect()
        assert [d["i"] for d in items] == [0, 1, 2, 3]
        assert items[0]["echo"] == {"q": daemon}
        stats = await wait_until(client.collect_stats, what="stats")
        assert stats[server.lease_id] == {"kv_active_blocks": 3}
        # an event published by one package reaches the other's subscriber
        sub = await (call_rt.namespace("xp").component("w")
                     .subscribe_event("kv_events"))
        await (srv_rt.namespace("xp").component("w")
               .publish_event("kv_events", {"n": 1}))
        msg = await sub.next(timeout=WAIT)
        assert json.loads(msg.payload) == {"n": 1}
        sub.close()
        await server.stop()
        await wait_until(lambda: not client.instances, what="deregistration")
        await client.close()
    finally:
        await port_rt.shutdown()
        await jax_rt.shutdown()
        await stop_daemon(proc)


async def test_port_daemon_refuses_data_dir():
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "dynamo_tpu_torch.runtime.server",
        "--port", "0", "--data-dir", "/nonexistent",
        stdout=asyncio.subprocess.DEVNULL, stderr=asyncio.subprocess.PIPE)
    _, err = await asyncio.wait_for(proc.communicate(), 60)
    assert proc.returncode != 0
    assert b"ROADMAP A7" in err and b"--data-dir" in err
