"""The port's fleet KV fabric against the JAX package's, on the CPU.

The JAX suite's own cases (``tests/test_native_dataplane.py``,
``tests/test_kv_fabric.py``), each held against the JAX package:

- the data plane (``runtime/native_tcp.py`` over ``csrc/host/
  data_plane.cpp``): the port's senders (C++ and asyncio) and the JAX
  package's write the same bytes on the socket, each package's receiver
  reads the other's frames; an error prologue and an ERROR finish; STOP
  and KILL through the flag poll; 3000 frames in order through the
  backpressure; a peer that closes unblocks a sender past its high-water
  mark; with ``DYN_NATIVE_DATAPLANE`` on a library that does not build
  raises, and ``=0`` selects the asyncio sender;
- the object tier (``llm/kv/remotestore.py``): a block's npz bytes equal
  the JAX package's both ways (the zip's clock held still: the members'
  timestamps are the write's), bf16 and int8 byte for byte; a root written
  by either package is read by the other; durability, torn objects reaped,
  the admission gate wired into the match;
- the link model (``llm/kv/fabric.py``): the gate's decisions, modeled
  seconds and crossovers, the prefill-rate estimator and the link table
  equal JAX's over the same inputs;
- the fabric end to end over the port's daemon: a prefix on worker A's
  disk fetched by worker B over ``fetch_native`` (the stream equals the
  JAX engine's cold stream), a dead peer, a torn frame, the JSON path
  byte-identical to the data plane (fuzzed) and the declined data plane
  counted, the probe over the data plane and its fallback;
- the remote rung: disk evictions promoted to the object store and
  announced as "remote"; prefill-as-a-service (``components/
  prefill_service.py``) publishing to a root a recorded engine admits
  from, whose ``kv_remote_restore`` replays bit for bit from the bytes and
  from the root, and whose log the JAX package's ``check_log`` /
  ``check_inputs`` accept;
- the router cases ``tests/test_torch_kv_router.py`` does not hold: the
  remote holder's credit against the link, fabric credit for blocks held
  elsewhere, runtime tier weights, the daemon link's bounded retry
  (``test_router_decisions_match_jax`` there already holds tier-tagged
  and link-priced decisions on seeded streams);
- cross-package pairs over one daemon: a JAX ``KvFabricServer`` serves a
  port ``KvFabric`` and the reverse, with byte-equal blocks; a port
  ``PrefillService`` publishes to a root a JAX engine admits, and the
  reverse, with equal streams.

Tolerance: token streams are compared for equality (both engines run the
same numpy f32 weights, ``test_torch_kv_offload``'s tiny llama); blocks,
frames and npz bytes byte for byte; the link model's floats within 1e-12
relative. Not ported here: ``test_llmctl_kv_set_weights_live`` (waits for
``llmctl`` and ``llm/kv/admin.py``, ROADMAP A7.6, A10) and
``test_remote_metrics_exported_as_gauges`` (the metrics component, A10).
"""

import asyncio
import base64
import contextlib
import json
import os
import threading
import time
from unittest import mock

import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.components.prefill_service import \
    PrefillService as JPrefillService
from dynamo_tpu.engine import replay as jreplay
from dynamo_tpu.llm.kv import fabric as jfabric
from dynamo_tpu.llm.kv import remotestore as jremote
from dynamo_tpu.runtime.distributed import DistributedRuntime as JRuntime
from dynamo_tpu.runtime.distributed import Endpoint as JEndpoint
from dynamo_tpu.runtime.native_tcp import \
    NativeStreamSender as JNativeStreamSender
from dynamo_tpu.runtime.tcp import StreamSender as JStreamSender
from dynamo_tpu.runtime.tcp import TcpStreamServer as JTcpStreamServer
from dynamo_tpu_torch.components.prefill_service import PrefillService
from dynamo_tpu_torch.engine import replay
from dynamo_tpu_torch.llm.kv import fabric as tfabric
from dynamo_tpu_torch.llm.kv import remotestore as tremote
from dynamo_tpu_torch.llm.kv.fabric import (AdmissionGate, KvFabric,
                                            KvFabricServer, LinkStats,
                                            PeerLinkTable,
                                            PrefillRateEstimator)
from dynamo_tpu_torch.llm.kv.remotestore import (FsObjectStore,
                                                 ObjectKvBackend,
                                                 RemoteKvStore,
                                                 pack_block_bytes,
                                                 unpack_block_bytes)
from dynamo_tpu_torch.llm.kv_router.protocols import RouterEvent
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher
from dynamo_tpu_torch.runtime import tcp
from dynamo_tpu_torch.runtime.codec import ControlMessage, FrameKind
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime, Endpoint
from dynamo_tpu_torch.runtime.native_tcp import NativeStreamSender
from dynamo_tpu_torch.runtime.server import DiscoveryServer
from dynamo_tpu_torch.runtime.tcp import StreamSender, TcpStreamServer
from dynamo_tpu_torch.utils import native
from tests.test_torch_kv_disk import np_to_torch, torch_bytes
from tests.test_torch_kv_offload import engine_core, family_params, serve

pytestmark = pytest.mark.anyio

L, H, BS, D = 2, 2, 4, 8
PROMPT = list(range(1, 13))            # 3 full blocks of 4
SUFFIXED = PROMPT + [40, 41, 42]
ENGINE = dict(max_model_len=64, kv_block_size=4, num_kv_blocks=32,
              max_num_seqs=2, prefill_buckets=[32, 64])
TIERS = dict(host_kv_blocks=16, kv_disk_blocks=32)
WAIT = 30.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny engines run on one intra-op thread (the suite runs beside
    other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def core(jax_side: bool, disk_dir=None, **kw):
    """A tiny llama engine of either package, with host and disk tiers
    under ``disk_dir`` when given."""
    cfg = dict(ENGINE)
    if disk_dir is not None:
        cfg.update(TIERS, kv_disk_dir=str(disk_dir))
    cfg.update(kw)
    return engine_core(family_params(), "llama", jax_side, **cfg)


@pytest.fixture(scope="module")
def want():
    """The JAX engine's cold greedy streams (4 tokens) of PROMPT and
    SUFFIXED, built and run once: every stream here is held to them."""
    cache = {}

    async def get(prompt=tuple(PROMPT)):
        if not cache:
            jcore = core(True, enable_prefix_reuse=False)
            try:
                for p in (PROMPT, SUFFIXED):
                    cache[tuple(p)] = (await serve(jcore, p, "want", 4))[0]
            finally:
                await jcore.stop()
        return cache[tuple(prompt)]
    return get


async def until(cond, timeout: float = WAIT) -> None:
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, "timed out"
        await asyncio.sleep(0.02)


@contextlib.asynccontextmanager
async def daemon():
    srv = DiscoveryServer(host="127.0.0.1")
    await srv.start()
    try:
        yield srv
    finally:
        await srv.close()


def _blk(x: float) -> dict:
    return {"k": torch.full((L, H, BS, D), x),
            "v": torch.full((L, H, BS, D), 10 + x)}


def _jblk(x: float) -> dict:
    return {"k": np.full((L, H, BS, D), x, np.float32),
            "v": np.full((L, H, BS, D), 10 + x, np.float32)}


def _blocks_of(rng, n=12):
    """Seeded per-block dicts of each row kind (f32 pairs, bf16, int8
    opaque rows), as numpy (JAX) and torch (port) values."""
    out = []
    for i in range(n):
        L_, H_ = int(rng.integers(1, 3)), int(rng.integers(1, 3))
        BS_, D_ = int(rng.choice([2, 4])), int(rng.choice([4, 8]))
        kind = i % 3
        if kind == 0:
            jv = {"k": rng.normal(size=(L_, H_, BS_, D_)).astype(np.float32),
                  "v": rng.normal(size=(L_, H_, BS_, D_)).astype(np.float32)}
        elif kind == 1:
            jv = {"k": rng.normal(size=(L_, H_, BS_, D_))
                  .astype(ml_dtypes.bfloat16)}
        else:
            jv = {"kv": rng.integers(-128, 127, size=(L_, 1, BS_, 64))
                  .astype(np.int8)}
        out.append((jv, {k: np_to_torch(v) for k, v in jv.items()}))
    return out


@contextlib.contextmanager
def still_clock():
    """Hold the zip writer's clock: an npz member's header carries its
    write time, so the bytes of two packings compare only at one time."""
    with mock.patch("time.time", return_value=1.7e9):
        yield


# ------------------------------------------------------------- data plane


@pytest.fixture
async def receivers():
    """A stream server of each package."""
    srvs = {"port": TcpStreamServer(host="127.0.0.1"),
            "jax": JTcpStreamServer(host="127.0.0.1")}
    for s in srvs.values():
        await s.start()
    yield srvs
    for s in srvs.values():
        await s.close()


SENDERS = {"port-native": NativeStreamSender, "port-python": StreamSender,
           "jax-native": JNativeStreamSender, "jax-python": JStreamSender}


@pytest.mark.parametrize("rx_pkg", ["port", "jax"])
@pytest.mark.parametrize("sender", list(SENDERS))
async def test_sender_wire_compat(receivers, sender, rx_pkg):
    """Every sender's frames read back through either package's receiver:
    the prologue, data frames with and without a header, the sentinel."""
    server = receivers[rx_pkg]
    rx = server.register()
    s = await SENDERS[sender].connect(server.connection_info(rx))
    await s.send(b'{"tok": 1}')
    await s.send(b'{"tok": 2}', header=b'{"meta": true}')
    await s.finish()
    assert (await rx.wait_connected(5)).error is None
    f1 = await rx.next_frame(timeout=5)
    assert int(f1.kind) == 0 and f1.data == b'{"tok": 1}' and f1.header == b""
    f2 = await rx.next_frame(timeout=5)
    assert f2.data == b'{"tok": 2}' and f2.header == b'{"meta": true}'
    assert int((await rx.next_frame(timeout=5)).kind) == int(
        FrameKind.SENTINEL)
    rx.close()
    server.unregister(rx.stream_id)


async def _socket_bytes(sender_cls, frames) -> bytes:
    """Every byte a sender writes for a prologue, ``frames`` and a
    sentinel, read raw off the socket."""
    got = bytearray()
    done = asyncio.Event()

    async def on_conn(reader, writer):
        while True:
            chunk = await reader.read(1 << 16)
            if not chunk:
                break
            got.extend(chunk)
        writer.close()
        done.set()

    srv = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    port = srv.sockets[0].getsockname()[1]
    s = await sender_cls.connect(tcp.ConnectionInfo(
        address=f"127.0.0.1:{port}", stream_id="s" * 32))
    for header, data in frames:
        await s.send(data, header=header)
    await s.finish()
    await asyncio.wait_for(done.wait(), 10)
    srv.close()
    await srv.wait_closed()
    return bytes(got)


async def test_native_sender_bytes_equal_jax():
    """The port's C++ sender writes the JAX package's bytes, frame for
    frame, as its asyncio sender does: token frames and one 8 MiB
    payload in KV_CHUNK-like pieces."""
    rng = np.random.default_rng(3)
    frames = [(b"", b'{"tok": %d}' % i) for i in range(5)]
    frames.append((b'{"h": 7}', rng.bytes(8 << 20)))
    want = await _socket_bytes(JNativeStreamSender, frames)
    assert await _socket_bytes(NativeStreamSender, frames) == want
    assert await _socket_bytes(StreamSender, frames) == want


@pytest.mark.parametrize("rx_pkg", ["port", "jax"])
async def test_native_error_prologue_and_finish_error(receivers, rx_pkg):
    server = receivers[rx_pkg]
    rx = server.register()
    sender = await NativeStreamSender.connect(server.connection_info(rx),
                                              error="bad request")
    await sender.finish()
    assert (await rx.wait_connected(5)).error == "bad request"
    rx.close()
    rx2 = server.register()
    sender2 = await NativeStreamSender.connect(server.connection_info(rx2))
    await sender2.send(b"x")
    await sender2.finish(error="engine exploded")
    await rx2.wait_connected(5)
    await rx2.next_frame(timeout=5)
    err = await rx2.next_frame(timeout=5)
    assert int(err.kind) == int(FrameKind.ERROR)
    assert json.loads(err.header)["error"] == "engine exploded"
    rx2.close()


@pytest.mark.parametrize("rx_pkg", ["port", "jax"])
async def test_native_stop_kill_flags(receivers, rx_pkg):
    from dynamo_tpu.runtime.codec import ControlMessage as JControl
    control = ControlMessage if rx_pkg == "port" else JControl
    server = receivers[rx_pkg]
    rx = server.register()
    sender = await NativeStreamSender.connect(server.connection_info(rx))
    stops, kills = [], []
    sender.on_stop = lambda: stops.append(1)
    sender.on_kill = lambda: kills.append(1)
    await rx.wait_connected(5)
    await rx.send_control(control.stop())
    await until(lambda: stops, 2.0)
    assert stops == [1] and not sender.killed
    await rx.send_control(control.kill())
    await until(lambda: kills, 2.0)
    assert kills == [1] and sender.killed
    await sender.send(b"dropped")          # a killed stream drops, no raise
    await sender.finish()
    rx.close()


async def test_native_many_frames_backpressure(receivers):
    """3000 frames arrive in order and intact."""
    server = receivers["port"]
    rx = server.register()
    sender = await NativeStreamSender.connect(server.connection_info(rx))

    async def produce():
        for i in range(3000):
            await sender.send(json.dumps({"i": i}).encode())
        await sender.finish()

    async def consume():
        await rx.wait_connected(5)
        n = 0
        while True:
            f = await rx.next_frame(timeout=10)
            if f is None:
                continue
            if f.kind == FrameKind.SENTINEL:
                return n
            assert json.loads(f.data)["i"] == n
            n += 1

    _, n = await asyncio.gather(produce(), consume())
    assert n == 3000
    rx.close()


async def test_native_sender_stops_waiting_when_peer_closes():
    """A sender past its high-water mark whose peer closed without reading
    raises at its next send instead of waiting on a queue that never
    drains (the JAX sender's wait ends only on a socket error)."""
    accepted = asyncio.Event()

    async def on_conn(reader, writer):
        accepted.set()
        writer.close()                     # reads nothing, closes

    srv = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    port = srv.sockets[0].getsockname()[1]
    s = await NativeStreamSender.connect(tcp.ConnectionInfo(
        address=f"127.0.0.1:{port}", stream_id="c" * 32))
    await accepted.wait()
    big = bytes(4 << 20)

    async def flood():
        for _ in range(64):
            await s.send(big)

    with pytest.raises(ConnectionError):
        await asyncio.wait_for(flood(), 10)
    await s.finish()
    srv.close()
    await srv.wait_closed()


async def test_stream_sender_selection(monkeypatch, receivers):
    """``open_stream_sender``: the C++ sender by default, the asyncio one
    under DYN_NATIVE_DATAPLANE=0, and a data plane that does not build
    raises (no quiet fallback)."""
    server = receivers["port"]
    for env, cls in (("1", NativeStreamSender), ("0", StreamSender)):
        monkeypatch.setenv("DYN_NATIVE_DATAPLANE", env)
        rx = server.register()
        s = await tcp.open_stream_sender(server.connection_info(rx))
        assert type(s) is cls
        await s.finish()
        rx.close()
    monkeypatch.setenv("DYN_NATIVE_DATAPLANE", "1")

    def broken(*a, **kw):
        raise RuntimeError("building libdata_plane failed: no compiler")
    monkeypatch.setattr(native, "_CACHE", {})
    monkeypatch.setattr(native, "build", broken)
    rx = server.register()
    with pytest.raises(RuntimeError, match="no compiler"):
        await tcp.open_stream_sender(server.connection_info(rx))
    with pytest.raises(RuntimeError, match="no compiler"):
        tfabric.dataplane_serving_available()
    monkeypatch.setenv(tfabric.DATAPLANE_ENV, "0")
    assert tfabric.dataplane_serving_available() is False


# ---------------------------------------------------------- object tier


def test_pack_block_bytes_equal_jax_both_ways():
    """A block's npz bytes equal the JAX package's, and each package
    unpacks the other's to the same values and chain meta (f32, bf16,
    int8 rows)."""
    for jv, tv in _blocks_of(np.random.default_rng(5)):
        with still_clock():
            jb = jremote.pack_block_bytes(jv, tokens_hash=9, parent_hash=3)
            tb = pack_block_bytes(tv, tokens_hash=9, parent_hash=3)
        assert tb == jb
        vals, th, ph = unpack_block_bytes(jb)
        jvals, jth, jph = jremote.unpack_block_bytes(tb)
        assert (th, ph) == (jth, jph) == (9, 3)
        for k in jv:
            assert torch_bytes(vals[k]) == jv[k].tobytes()
            assert vals[k].dtype == tv[k].dtype
            assert jvals[k].dtype == jv[k].dtype
            np.testing.assert_array_equal(jvals[k], jv[k])
    with pytest.raises(ValueError):
        unpack_block_bytes(b"\x93NUMPY-torn-payload")


def test_object_store_roundtrip_and_durability(tmp_path):
    """put is acknowledged iff durable, a fresh backend over the same root
    sees every acknowledged block, ``.tmp-`` droppings are never listed,
    and the chain meta survives."""
    b = ObjectKvBackend(FsObjectStore(str(tmp_path)))
    assert b.put(101, _blk(1.0), tokens_hash=11, parent_hash=None) == []
    assert b.put(202, _blk(2.0), tokens_hash=22, parent_hash=101) == []
    assert b.put(101, _blk(9.0)) is None          # content-addressed no-op
    with open(os.path.join(str(tmp_path), "blocks", ".tmp-crash"),
              "wb") as f:
        f.write(b"partial")
    b2 = ObjectKvBackend(str(tmp_path))
    assert b2.contains(101) and b2.contains(202) and not b2.contains(303)
    assert sorted(b2.registered_entries()) == [(101, 11, None),
                                               (202, 22, 101)]
    out = RemoteKvStore(b2).fetch([101, 202])
    assert tuple(out["k"].shape) == (L, H, 2, BS, D)
    assert torch.all(out["k"][:, :, 0] == 1.0)
    assert torch.all(out["v"][:, :, 1] == 12.0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_object_root_shared_across_packages(tmp_path, writer):
    """A root one package wrote is the other's: the same keys and object
    bytes, the chain meta, and equal fetched values."""
    rng = np.random.default_rng(7)
    blocks = []
    for dt in (np.float32, ml_dtypes.bfloat16):
        jv = {k: rng.normal(size=(L, H, BS, D)).astype(dt) for k in "kv"}
        blocks.append((jv, {k: np_to_torch(v) for k, v in jv.items()}))
    hashes = [-5, 2**62 + 3]
    root = str(tmp_path / "obj")
    with still_clock():
        if writer == "port":
            w = ObjectKvBackend(root, capacity_blocks=4)
            for h, (_jv, tv) in zip(hashes, blocks):
                w.put(h, tv, tokens_hash=h + 1, parent_hash=None)
        else:
            w = jremote.ObjectKvBackend(root, capacity_blocks=4)
            for h, (jv, _tv) in zip(hashes, blocks):
                w.put(h, jv, tokens_hash=h + 1, parent_hash=None)
        other = str(tmp_path / "other")
        if writer == "port":
            o = jremote.ObjectKvBackend(other)
            for h, (jv, _tv) in zip(hashes, blocks):
                o.put(h, jv, tokens_hash=h + 1, parent_hash=None)
        else:
            o = ObjectKvBackend(other)
            for h, (_jv, tv) in zip(hashes, blocks):
                o.put(h, tv, tokens_hash=h + 1, parent_hash=None)
    listing = FsObjectStore(root).list_objects("blocks/")
    assert [k for k, _s, _m in listing] == [
        k for k, _s, _m in FsObjectStore(other).list_objects("blocks/")]
    for key, _s, _m in listing:
        assert (FsObjectStore(root).get_object(key)
                == FsObjectStore(other).get_object(key))
    tr = RemoteKvStore(ObjectKvBackend(root))
    jr = jremote.RemoteKvStore(jremote.ObjectKvBackend(root))
    assert sorted(tr.registered_entries()) == sorted(jr.registered_entries())
    for h in hashes:
        t, j = tr.fetch([h]), jr.fetch([h])
        for k in j:
            assert torch_bytes(t[k]) == np.ascontiguousarray(j[k]).tobytes()


def test_object_store_concurrent_puts_of_one_key(tmp_path):
    """Writers of one key never share a temporary file: every put of two
    threads racing on the same key is acknowledged, the object holds one
    writer's whole bytes, and no ``.tmp-`` dropping is left."""
    st = FsObjectStore(str(tmp_path))
    payloads = [bytes([i]) * (1 << 16) for i in (1, 2)]
    errors = []

    def writer(data):
        try:
            for _ in range(50):
                assert st.put_object("blocks/blk-1.npz", data) == len(data)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(d,)) for d in payloads]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert st.get_object("blocks/blk-1.npz") in payloads
    assert os.listdir(os.path.join(str(tmp_path), "blocks")) == ["blk-1.npz"]


def test_remote_store_apply_put_equals_jax(tmp_path):
    """``apply_put`` (the literal placement a mirror replays) deletes
    exactly the eviction set, then stores, the same objects as JAX's."""
    roots = {}
    with still_clock():
        for pkg, blk in ((tremote, _blk), (jremote, _jblk)):
            root = str(tmp_path / pkg.__name__)
            rs = pkg.RemoteKvStore(pkg.ObjectKvBackend(root))
            rs.apply_put(1, [], blk(1.0), tokens_hash=11)
            rs.apply_put(2, [], blk(2.0), tokens_hash=22, parent_hash=1)
            rs.apply_put(3, [1], blk(3.0))
            rs.apply_put(2, [], blk(9.0))      # held: a content no-op
            roots[pkg] = root
    t, j = (FsObjectStore(roots[p]) for p in (tremote, jremote))
    keys = [k for k, _s, _m in t.list_objects("blocks/")]
    assert keys == [k for k, _s, _m in j.list_objects("blocks/")]
    assert len(keys) == 2
    for k in keys:
        assert t.get_object(k) == j.get_object(k)


def test_object_store_reaps_truncated_payload(tmp_path):
    """A torn object is a miss: fetch raises KeyError, the object is
    reaped and counted, residency drops; the JAX store agrees."""
    for pkg, blk in ((tremote, _blk), (jremote, _jblk)):
        root = str(tmp_path / pkg.__name__)
        b = pkg.ObjectKvBackend(root)
        b.put(7, blk(3.0))
        key = "blocks/" + os.listdir(os.path.join(root, "blocks"))[0]
        with open(os.path.join(root, key), "r+b") as f:
            f.truncate(10)
        rs = pkg.RemoteKvStore(b)
        with pytest.raises(KeyError):
            rs.fetch([7])
        assert b.reaped_corrupt_total == 1 and rs.fetch_failures_total == 1
        assert not b.contains(7)


def test_remote_store_admission_gate_wires_into_match(tmp_path):
    """The admission callable sees the whole matched run: a reject is a
    miss (counted), an accept returns the run pinned; JAX's store makes
    the same calls and answers."""
    outs = []
    for pkg, blk in ((tremote, _blk), (jremote, _jblk)):
        rs = pkg.RemoteKvStore(pkg.ObjectKvBackend(
            str(tmp_path / pkg.__name__)))
        for i, h in enumerate((1, 2, 3)):
            rs.put(h, blk(float(i)))
        seen = []

        def gate(n, holders, seen=seen):
            seen.append((n, holders))
            return False
        rs.admission = gate
        a = rs.match_prefix([1, 2, 3, 9])
        rs.admission = lambda n, holders: True
        b = rs.match_prefix([1, 2, 9], pin=True)
        rs.unpin([1, 2])
        outs.append((a, b, seen, rs.admission_rejects_total, rs.hit_rate()))
    assert outs[0] == outs[1]
    assert outs[0][:4] == ([], [1, 2], [(3, [[], [], []])], 1)


# --------------------------------------------------------- the link model

LINKS = [LinkStats(rtt_s=1e-3, gbps=10.0), LinkStats(rtt_s=0.5, gbps=1e-4),
         LinkStats(rtt_s=0.05, gbps=10.0), LinkStats(rtt_s=float("inf"),
                                                     gbps=0.0)]


@pytest.mark.parametrize("rate", [1000.0, 0.0, 4.1e4])
def test_admission_gate_equals_jax(rate):
    """Decisions, modeled fetch / recompute seconds and crossovers equal
    JAX's over links and depths; the overrides bypass the model; an
    unknown rate admits."""
    for mode in ("auto", "always", "never"):
        g = AdmissionGate(1 << 20, 16, prefill_tok_per_s=rate, mode=mode)
        jg = jfabric.AdmissionGate(1 << 20, 16, prefill_tok_per_s=rate,
                                   mode=mode)
        for link in LINKS:
            jl = jfabric.LinkStats(rtt_s=link.rtt_s, gbps=link.gbps)
            for n in (1, 4, 8, 16, 64):
                assert g.admit(n, link) == jg.admit(n, jl)
                for a, b in ((g.modeled_fetch_s(n, link),
                              jg.modeled_fetch_s(n, jl)),
                             (g.modeled_recompute_s(n),
                              jg.modeled_recompute_s(n))):
                    assert a == pytest.approx(b, rel=1e-12)
            assert g.crossover_blocks(link) == pytest.approx(
                jg.crossover_blocks(jl), rel=1e-12)
        assert (g.accepts_total, g.rejects_total) == (jg.accepts_total,
                                                      jg.rejects_total)
    fast, slow = LINKS[0], LINKS[1]
    gate = AdmissionGate(1 << 20, 16, prefill_tok_per_s=1000.0)
    assert gate.admit(8, fast) and not gate.admit(8, slow)
    assert 0 < gate.crossover_blocks(fast) < 1
    assert gate.crossover_blocks(slow) == float("inf")
    assert not gate.admit(1, LINKS[2]) and gate.admit(16, LINKS[2])
    with pytest.raises(ValueError):
        AdmissionGate(1, 1, 1.0, mode="sometimes")


def test_prefill_rate_estimator_equals_jax():
    """A young engine's stream (two compile-inflated admissions, then a
    steady ~10k tok/s): unknown during warm-up, the steady rate after,
    one slow admission moving the EMA by alpha; degenerate inputs
    ignored. JAX's estimator reads the same rate at every step."""
    est, jest = PrefillRateEstimator(), jfabric.PrefillRateEstimator()
    stream = ([(512, 5.0), (512, 4.0)] + [(512, 0.05)] * 20
              + [(512, 5.0), (0, 1.0), (512, 0.0)])
    for i, (tok, wall) in enumerate(stream):
        est.observe(tok, wall)
        jest.observe(tok, wall)
        assert est.rate() == jest.rate()
        if i < 2:
            assert est.rate() == 0.0
        if i == 21:
            assert est.rate() == pytest.approx(512 / 0.05, rel=0.01)
    assert est.rate() > (1 - 0.31) * 512 / 0.05
    assert (est.samples, est.warmup_skipped) == (jest.samples,
                                                 jest.warmup_skipped) == (23, 2)


async def test_prefill_rate_feeds_the_gate(tmp_path):
    """The engine's measured rate is the gate's recompute side: a young
    engine's gate admits a slow link; after its warm-up prefills it
    rejects it, with JAX's decision over the same rate."""
    c = core(False)
    try:
        gate = AdmissionGate(1 << 20, 16,
                             prefill_tok_per_s=c.measured_prefill_tok_per_s)
        slow = LINKS[1]
        assert gate.admit(4, slow)
        for i in range(3):
            await serve(c, [5 + i] * 9, f"w{i}", 1)
        rate = c.measured_prefill_tok_per_s()
        assert rate > 0 and c.prefill_rate_estimator.warmup_skipped == 2
        assert not gate.admit(4, slow)
        jgate = jfabric.AdmissionGate(1 << 20, 16, prefill_tok_per_s=rate)
        assert not jgate.admit(4, jfabric.LinkStats(rtt_s=0.5, gbps=1e-4))
        m = c.metrics()
        assert m.prefill_tok_per_s == rate
        assert m.kv_bytes_per_block == 2 * 2 * 4 * 32 * 4   # L K/V bs C f32
    finally:
        await c.stop()


def test_peer_link_table_and_breaker_equal_jax():
    """Probe then decay-average, the default for unknown peers, drop, the
    holder's link, and the breaker's trips, half-open trial and recovery:
    the same readings as JAX's table on the same observations."""
    clock = [0.0]
    tabs = [PeerLinkTable(default_gbps=1.0, default_rtt_s=1e-3,
                          now=lambda: clock[0]),
            jfabric.PeerLinkTable(default_gbps=1.0, default_rtt_s=1e-3,
                                  now=lambda: clock[0])]
    for t in tabs:
        t.observe_rtt(7, 0.010)
        t.observe_transfer(7, nbytes=10_000_000, seconds=0.01)
    assert [t.get(7).to_dict() for t in tabs] == [
        {"rtt_s": 0.010, "gbps": pytest.approx(1.0), "samples": 2}] * 2
    for t in tabs:
        t.observe_transfer(7, nbytes=10_000_000, seconds=0.10)
    assert tabs[0].get(7).gbps == tabs[1].get(7).gbps
    assert 0.1 < tabs[0].get(7).gbps < 1.0
    assert tabs[0].get(99).gbps == 1.0
    for t in tabs:
        t.drop(7)
        t.observe_transfer(3, 10_000_000, 0.01)
    assert tabs[0].get(7).gbps == 1.0
    assert tabs[0].link_for_holders([[], [3]]) is tabs[0].get(3)
    assert tabs[0].link_for_holders([[], []]) is tabs[0].default
    for step in ("fail", "fail", "fail", "check", "wait", "trial", "ok"):
        for t in tabs:
            if step == "fail":
                t.record_failure(3)
            elif step == "trial":
                assert t.breaker(3).allow()
                assert not t.usable(3)          # one trial at a time
            elif step == "ok":
                t.record_success(3, 0.01)
        if step == "wait":
            clock[0] += 31.0
        snaps = [t.breaker_snapshot() for t in tabs]
        assert snaps[0] == snaps[1]
        assert tabs[0].usable(3) == tabs[1].usable(3)
        if step == "check":
            assert tabs[0].link_for_holders([[3]]).gbps == 0.0
            assert tabs[0].open_breaker_count() == 1
    assert tabs[0].breaker_trips_total() == tabs[1].breaker_trips_total() == 1
    assert tabs[0].usable(3)


# ----------------------------------------------------- fabric end to end


async def _attach(c, srv, path="dyn://ns/worker/generate"):
    rt = await DistributedRuntime.connect(srv.address)
    fab = await KvFabric.attach(c, rt, Endpoint.parse_path(rt, path))
    return rt, fab


async def _disk_only_worker(tmp_path, name: str):
    """A worker whose KV of PROMPT is on its disk only: served once, then
    stopped (flushed), then restarted warm on the same directory."""
    c = core(False, tmp_path / name)
    await serve(c, PROMPT, "cold", 4)
    await c.stop()
    c = core(False, tmp_path / name)
    assert c.disk_store.restored_blocks >= 2
    return c


async def test_loopback_peer_fetch_equals_jax(tmp_path, want):
    """Worker A's prefix is on its disk only; its reannounce (tier "disk"
    kv_events) feeds worker B's fabric index over the bus; B fetches it
    over fetch_native (the data plane, no fallback) and onboards it: the
    stream equals the JAX engine's cold stream."""
    async with daemon() as srv:
        core_a = await _disk_only_worker(tmp_path, "a")
        rt_a, fab_a = await _attach(core_a, srv)
        rt_b = fab_b = core_b = None
        try:
            core_b = core(False, tmp_path / "b")
            rt_b, fab_b = await _attach(core_b, srv)
            wid_a = rt_a.worker_id
            assert fab_b.links.get(wid_a).samples >= 2   # probed at attach
            assert fab_b.probe_fallbacks_total == 0
            comp = rt_a.namespace("ns").component("worker")

            async def sink(ev):
                await comp.publish_event("kv_events", ev)
            core_a.kv_event_publisher = KvEventPublisher(worker_id=wid_a,
                                                         sink=sink)
            assert core_a.reannounce_kv() >= 2
            await core_a.kv_event_publisher.drain()
            await until(lambda: fab_b.store.peer_block_count() >= 2)
            toks, _, hit = await serve(core_b, PROMPT, "via-fabric", 4)
            assert toks == await want()
            assert hit >= 8
            assert core_b.remote_onboards == 1
            assert core_b.remote_fetch_failures == 0
            assert fab_b.dataplane_fetches_total == 1
            assert fab_b.dataplane_fallbacks_total == 0
            assert fab_a.server.dataplane_fetches_served == 1
            assert fab_a.server.blocks_served >= 2
            rec = [r for r in core_b.flight.dump()
                   if r["kind"] == "prefill"][-1]
            assert rec["hit_remote"] == hit
            m = core_b.metrics()
            assert m.remote_hit_rate > 0 and m.remote_link_gbps > 0
            assert m.remote_dataplane_fetches_total == 1
        finally:
            for fab in (fab_b, fab_a):
                if fab is not None:
                    await fab.close()
            if core_b is not None:
                await core_b.stop()
            await core_a.stop()
            for rt in (rt_b, rt_a):
                if rt is not None:
                    await rt.shutdown()


async def test_peer_gone_graceful_fallback_to_recompute(tmp_path, want):
    """A peer that died between announce and fetch costs the recompute
    only: the stream equals the JAX cold stream, the failure is counted,
    and the engine serves on."""
    core_a = await _disk_only_worker(tmp_path, "a")
    hashes = [h for h, _t, _p in core_a.disk_store.registered_entries()]
    await core_a.stop()
    async with daemon() as srv:
        core_b = core(False, tmp_path / "b")
        rt_b, fab_b = await _attach(core_b, srv)
        try:
            fab_b.store.note_peer_stored(0xDEAD, hashes)
            toks, _, _ = await serve(core_b, PROMPT, "fallback", 4)
            assert toks == await want()
            assert core_b.remote_fetch_failures == 1
            assert core_b.remote_store.fetch_failures_total == 1
            assert (await serve(core_b, PROMPT, "again", 4))[0] == toks
        finally:
            await fab_b.close()
            await core_b.stop()
            await rt_b.shutdown()


class StubServer(KvFabricServer):
    """A kv_fabric peer serving canned packed bytes (no engine)."""

    def __init__(self, blobs):
        super().__init__(core=None)
        self.blobs = blobs

    def _pin_host(self, hashes):
        return {}

    def _read_block(self, seq_hash, held):
        return self.blobs.get(seq_hash)

    def _serveable(self, seq_hash):
        return seq_hash in self.blobs


class JStubServer(jfabric.KvFabricServer):
    def __init__(self, blobs):
        super().__init__(core=None)
        self.blobs = blobs

    def _read_block(self, seq_hash):
        return self.blobs.get(seq_hash)

    def _serveable(self, seq_hash):
        return seq_hash in self.blobs


async def _client(rt, pkg="port", path="dyn://ns/worker/kv_fabric"):
    """A fetch-side fabric wired by hand (no engine)."""
    if pkg == "port":
        fab = KvFabric(RemoteKvStore(), PeerLinkTable(),
                       AdmissionGate(1, 1, 1.0), runtime=rt)
        fab.bind_loop()
        fab.client = Endpoint.parse_path(rt, path).client()
    else:
        fab = jfabric.KvFabric(jremote.RemoteKvStore(),
                               jfabric.PeerLinkTable(),
                               jfabric.AdmissionGate(1, 1, 1.0), runtime=rt)
        fab._loop = asyncio.get_running_loop()
        fab.client = JEndpoint.parse_path(rt, path).client()
    await fab.client.start()
    await fab.client.wait_for_instances()
    return fab


@pytest.mark.parametrize("pair", ["port-port", "jax-port", "port-jax"])
async def test_dataplane_vs_json_byte_identical(pair):
    """Fetched over the data plane or the JSON op, between any pair of
    packages (server-client) over one daemon, the blocks are the served
    bytes, byte for byte (fuzzed kinds, counts and runs); a missing hash
    is a KeyError on both paths."""
    server_pkg, client_pkg = pair.split("-")
    blobs, originals = {}, {}
    for i, (jv, tv) in enumerate(_blocks_of(np.random.default_rng(12))):
        h = 1000 + i
        blobs[h] = (pack_block_bytes(tv, tokens_hash=i)
                    if server_pkg == "port"
                    else jremote.pack_block_bytes(jv, tokens_hash=i))
        originals[h] = jv
    async with daemon() as srv:
        rts = {"port": await DistributedRuntime.connect(srv.address),
               "jax": await JRuntime.connect(srv.address)}
        rt_s = (await DistributedRuntime.connect(srv.address)
                if pair == "port-port" else rts[server_pkg])
        ep_cls = Endpoint if server_pkg == "port" else JEndpoint
        stub = (StubServer if server_pkg == "port" else JStubServer)(blobs)
        await ep_cls.parse_path(rt_s, "dyn://ns/worker/kv_fabric").serve(
            stub, decode_req=json.loads)
        fab = None
        try:
            fab = await _client(rts[client_pkg], client_pkg)
            wid = rt_s.worker_id
            hashes = sorted(blobs)
            for run in ([hashes[0]], hashes[:5], hashes[3:9], hashes):
                nat = await fab._fetch_blobs_native(wid, run)
                via_json = await fab._fetch_blobs_json(wid, run)
                assert nat == via_json == [blobs[h] for h in run]
                for h, blob in zip(run, nat):
                    vals, th, _ = unpack_block_bytes(blob)
                    assert th == h - 1000
                    for k, arr in originals[h].items():
                        assert torch_bytes(vals[k]) == arr.tobytes()
            assert fab.dataplane_fetches_total == 4
            assert stub.dataplane_fetches_served == 4
            with pytest.raises(KeyError):
                await fab._fetch_blobs_native(wid, [999999])
            with pytest.raises(KeyError):
                await fab._fetch_blobs_json(wid, [999999])
        finally:
            if fab is not None:
                await fab.close()
            for rt in {id(r): r for r in (*rts.values(), rt_s)}.values():
                await rt.shutdown()


async def test_dataplane_declined_falls_back_to_json(monkeypatch):
    """A peer under DYN_KV_FABRIC_DATAPLANE=0 declines fetch_native: the
    fetch rides the JSON op with the same values, the fallback counted."""
    blobs = {7: pack_block_bytes(_blk(4.0), tokens_hash=1)}
    async with daemon() as srv:
        rt_s = await DistributedRuntime.connect(srv.address)
        rt_c = await DistributedRuntime.connect(srv.address)
        await Endpoint.parse_path(rt_s, "dyn://ns/worker/kv_fabric").serve(
            StubServer(blobs), decode_req=json.loads)
        fab = await _client(rt_c)
        try:
            monkeypatch.setenv(tfabric.DATAPLANE_ENV, "0")  # the server side
            out = await fab.fetch_async(rt_s.worker_id, [7])
            assert torch.equal(out["k"][:, :, 0], _blk(4.0)["k"])
            assert fab.dataplane_fallbacks_total == 1
            assert fab.dataplane_fetches_total == 0
            assert fab.metrics()["remote_dataplane_fallbacks_total"] == 1
        finally:
            await fab.close()
            await rt_c.shutdown()
            await rt_s.shutdown()


async def test_torn_native_frame_falls_back_to_recompute(tmp_path, want):
    """A torn block payload over the data plane is a fetch failure, not
    an error: the frames arrived (a data-plane fetch counted), the unpack
    failed, the engine recomputed, the stream equals JAX's cold one."""
    core_a = await _disk_only_worker(tmp_path, "a")
    hashes = [h for h, _t, _p in core_a.disk_store.registered_entries()]
    await core_a.stop()
    torn = {h: b"\x93NUMPY-torn-payload" for h in hashes}
    async with daemon() as srv:
        rt_s = await DistributedRuntime.connect(srv.address)
        await Endpoint.parse_path(rt_s, "dyn://ns/worker/kv_fabric").serve(
            StubServer(torn), decode_req=json.loads)
        core_b = core(False, tmp_path / "b")
        rt_b, fab_b = await _attach(core_b, srv)
        try:
            fab_b.store.note_peer_stored(rt_s.worker_id, hashes)
            toks, _, _ = await serve(core_b, PROMPT, "torn", 4)
            assert toks == await want()
            assert core_b.remote_fetch_failures == 1
            assert fab_b.dataplane_fetches_total == 1
            assert fab_b.links.breaker(rt_s.worker_id).consecutive_failures \
                == 1
            assert (await serve(core_b, PROMPT, "again", 4))[0] == toks
        finally:
            await fab_b.close()
            await core_b.stop()
            await rt_b.shutdown()
            await rt_s.shutdown()


async def test_probe_rides_dataplane_with_fallback(monkeypatch):
    """The bandwidth probe rides the data plane; a peer that declines is
    probed through the request plane's echo, counted."""
    async with daemon() as srv:
        rt_s = await DistributedRuntime.connect(srv.address)
        rt_c = await DistributedRuntime.connect(srv.address)
        await Endpoint.parse_path(rt_s, "dyn://ns/worker/kv_fabric").serve(
            KvFabricServer(None), decode_req=json.loads)
        fab = await _client(rt_c)
        try:
            link = await fab.probe(rt_s.worker_id, nbytes=1 << 16)
            assert link.samples >= 2 and link.gbps > 0
            assert fab.probe_fallbacks_total == 0
            monkeypatch.setenv(tfabric.DATAPLANE_ENV, "0")
            before = fab.links.get(rt_s.worker_id).samples
            link2 = await fab.probe(rt_s.worker_id, nbytes=1 << 14)
            assert fab.probe_fallbacks_total == 1
            assert link2.samples > before and link2.gbps > 0
        finally:
            await fab.close()
            await rt_c.shutdown()
            await rt_s.shutdown()


async def test_server_reads_pinned_host_slots_while_writebacks_evict():
    """The server resolves and pins host slots on the loop, where the
    write-back pump stores and evicts: a pump that fills the full host
    pool while a fetch reads it off the loop evicts other slots, and the
    fetched bytes are the hash's own. The pool's pins move only on the
    loop and are all released after."""
    from types import SimpleNamespace

    from dynamo_tpu_torch.llm.kv.offload import HostKvPool
    host = HostKvPool(4, L, H, BS, D)

    def store(hashes):
        host.store(hashes, {k: torch.stack([_blk(float(h))[k]
                                            for h in hashes], dim=2)
                            for k in "kv"},
                   tokens_hashes=[h + 1 for h in hashes],
                   parent_hashes=[None] * len(hashes))

    store([1, 2, 3, 4])
    loop = asyncio.get_running_loop()
    loop_thread = threading.get_ident()
    pin_threads = []
    for name in ("pin", "unpin"):
        def wrapped(slots, _f=getattr(host, name)):
            pin_threads.append(threading.get_ident())
            return _f(slots)
        setattr(host, name, wrapped)
    row_copy = host.row_copy
    evicted = []

    async def writeback_flood():
        for h in range(100, 108):
            before = set(host._by_hash)
            store([h])
            evicted.extend(before - set(host._by_hash))
            await asyncio.sleep(0)

    def racing_row_copy(slot):
        if not evicted:
            asyncio.run_coroutine_threadsafe(writeback_flood(),
                                             loop).result(WAIT)
        return row_copy(slot)

    host.row_copy = racing_row_copy
    srv = KvFabricServer(SimpleNamespace(
        disk_store=None, kv_manager=SimpleNamespace(host_pool=host)))
    r = await srv._handle({"op": "fetch", "hashes": [1, 2]})
    assert r["ok"] and r["missing"] == [] and sorted(evicted) == [
        3, 4, 100, 101, 102, 103, 104, 105]
    for h in (1, 2):
        values, th, _ph = unpack_block_bytes(
            base64.b64decode(r["blocks"][str(h)]))
        assert th == h + 1
        for k in "kv":
            assert torch.equal(values[k], _blk(float(h))[k])
    assert host._pins == {} and set(pin_threads) == {loop_thread}
    r = await srv._handle({"op": "fetch", "hashes": [3]})
    assert r["missing"] == [3]


def test_fetch_sync_refuses_its_own_loop():
    """fetch_sync waits on the fabric's loop: called on that loop's thread
    it raises instead of deadlocking."""
    async def body():
        fab = KvFabric(RemoteKvStore(), PeerLinkTable(),
                       AdmissionGate(1, 1, 1.0))
        fab.bind_loop()
        with pytest.raises(RuntimeError, match="loop it waits on"):
            fab.fetch_sync(1, [1])
    asyncio.run(body())


# ------------------------------------------------------- the remote rung


async def test_disk_eviction_promotes_to_object_store(tmp_path):
    """Disk capacity evictions land in the shared object store
    write-behind, with their chain meta, announced "remote" once no
    warmer tier holds the hash; a device eviction demotes a hash whose
    only residency left is the object store to "remote"."""
    events = []

    class Pub(KvEventPublisher):
        def _enqueue(self, ev: RouterEvent) -> None:
            events.append(ev)

    c = core(False, tmp_path / "kv", host_kv_blocks=3, kv_disk_blocks=4,
             kv_remote_dir=str(tmp_path / "obj"))
    c.kv_event_publisher = Pub(worker_id=5)
    try:
        for i, base in enumerate((1, 40, 80, 120)):
            await serve(c, list(range(base, base + 12)), f"r{i}", 4)
            await c.offload_engine.drain()
            await c.spill_engine.drain()
            await asyncio.sleep(0.05)      # the thread → loop hop
        await c.remote_spill_engine.drain()
        assert c.disk_store.evicted_blocks_total >= 1
        assert c.remote_store.used_blocks >= 1
        ents = c.remote_store.registered_entries()
        assert any(th is not None for _h, th, _p in ents)
        # the JAX package's store over the same root serves them
        other = jremote.RemoteKvStore(jremote.ObjectKvBackend(
            str(tmp_path / "obj")))
        h0 = ents[0][0]
        assert other.contains(h0)
        assert torch_bytes(c.remote_store.fetch([h0])["k"]) == \
            np.ascontiguousarray(other.fetch([h0])["k"]).tobytes()
        assert not [e for e in events
                    if e.stored is not None and e.stored.tier == "remote"]
        events.clear()
        c.kv_manager.pool.reset()
        assert any(e.stored is not None and e.stored.tier == "remote"
                   for e in events)
        assert c.metrics().remote_used_blocks == c.remote_store.used_blocks
    finally:
        await c.stop()


async def test_prefill_publish_then_remote_admit_and_replay(tmp_path, want):
    """A prefill-publish worker publishes PROMPT's prefix; a recorded
    engine on the same root admits it through the remote rung (K1-free
    prefix, the suffix prefilled) with the JAX engine's cold stream, and
    its kv_remote_restore replays bit for bit from the carried bytes and
    from the root; the JAX checkers accept the log."""
    root = str(tmp_path / "obj")
    runtime = DistributedRuntime.in_process()
    core_p = core(False, tmp_path / "p", kv_remote_dir=root)
    try:
        svc = PrefillService(core_p, runtime)
        r = await svc.publish(PROMPT, rid="pub-1")
        assert r["ok"] and r["published"] == 3 == core_p.prefill_published_blocks
        assert len(r["hashes"]) == 3
        # content-addressed: a warm chain (device hit) writes nothing
        r2 = await svc.publish(PROMPT, rid="pub-2")
        assert r2["published"] == 0 and r2["prefix_hit_tokens"] == 8
        status = await svc._handle({"op": "status"})
        assert status["prefill_published_blocks_total"] == 3
        assert core_p.metrics().prefill_published_blocks_total == 3
    finally:
        await core_p.stop()
    core_d = core(False, tmp_path / "d", kv_remote_dir=root)
    core_d.recorder = replay.Recorder()
    try:
        toks, _, hit = await serve(core_d, SUFFIXED, "admit", 4)
        assert toks == await want(tuple(SUFFIXED))
        assert hit == 12 and core_d.remote_onboards == 1
        assert core_d.total_prefill_tokens == len(SUFFIXED) - 12
        ev = core_d.recorder.events
        restores = [e for e in ev if e["ev"] == "kv_remote_restore"]
        assert len(restores) == 1
        assert len(restores[0]["remote_targets"]) == 3
        assert replay.compare_replay(ev, replay.replay(core_d, ev)) == []
        stripped = [dict(e, values=None) if e["ev"] == "kv_remote_restore"
                    else e for e in ev]
        assert replay.compare_replay(
            stripped, replay.replay(core_d, stripped)) == []
        assert jreplay.check_log(ev, 4) == []
        assert jreplay.check_inputs(ev) == []
    finally:
        await core_d.stop()
        await runtime.shutdown()


@pytest.mark.parametrize("publisher", ["port", "jax"])
async def test_prefill_publish_cross_package(tmp_path, want, publisher):
    """One package's PrefillService publishes to a root the other
    package's engine admits from, with the JAX cold stream either way."""
    root = str(tmp_path / "obj")
    pub_jax = publisher == "jax"
    runtime = (JRuntime if pub_jax else DistributedRuntime).in_process()
    core_p = core(pub_jax, tmp_path / "p", kv_remote_dir=root)
    try:
        svc = (JPrefillService if pub_jax else PrefillService)(core_p,
                                                               runtime)
        assert (await svc.publish(PROMPT, rid="pub"))["published"] == 3
    finally:
        await core_p.stop()
        await runtime.shutdown()
    core_d = core(not pub_jax, tmp_path / "d", kv_remote_dir=root,
                  kv_remote_admission="always")
    try:
        toks, _, hit = await serve(core_d, SUFFIXED, "admit", 4)
        assert toks == await want(tuple(SUFFIXED))
        assert hit == 12 and core_d.remote_onboards == 1
    finally:
        await core_d.stop()


async def test_failed_queue_publish_is_redelivered():
    """A queue item whose publish fails is nacked for redelivery, and the
    redelivery publishes (it is the same sighting, not a later one); past
    ``MAX_DELIVERIES`` the item is dropped. The JAX service acks a failed
    publish at once (its retry branch is never reached), so this case
    holds the port alone."""
    from types import SimpleNamespace

    from dynamo_tpu_torch.llm.protocols.disagg import PrefillPublishRequest

    class Queue:
        def __init__(self):
            self.acks, self.nacks = [], []

        async def ack(self, i):
            self.acks.append(i)

        async def nack(self, i):
            self.nacks.append(i)

    q = Queue()
    core_stub = SimpleNamespace(remote_store=SimpleNamespace(object=object()))
    svc = PrefillService(core_stub, None, queue=q, publish_min_hits=2)
    outcomes = iter([OSError("object store refused"), None,
                     OSError("a"), OSError("b"), OSError("c")])

    async def publish(token_ids, sampling=None, rid="publish"):
        e = next(outcomes)
        if e is not None:
            raise e
        return {"ok": True, "published": 3}

    svc.publish = publish
    payload = PrefillPublishRequest("r", PROMPT).to_json()
    item = lambda i, n: SimpleNamespace(id=i, payload=payload,  # noqa: E731
                                        deliveries=n)
    await svc._handle_item(item(1, 1))       # first sighting: skipped
    await svc._handle_item(item(2, 1))       # second: publish fails
    assert (q.acks, q.nacks) == ([1], [2])
    await svc._handle_item(item(2, 2))       # redelivered: publishes
    assert (q.acks, q.nacks) == ([1, 2], [2])
    assert (svc.publishes_done, svc.publishes_failed) == (1, 1)
    other = PrefillPublishRequest("s", SUFFIXED).to_json()
    for n in (1, 1, 2, 3):
        await svc._handle_item(SimpleNamespace(id=3, payload=other,
                                               deliveries=n))
    assert (q.acks, q.nacks) == ([1, 2, 3, 3], [2, 3, 3])
    assert svc.publishes_failed == 4


async def test_fabric_servers_cross_package(tmp_path):
    """Over one daemon, a JAX worker's KvFabricServer serves a port
    KvFabric and a port worker's serves a JAX KvFabric, over the data
    plane: each client receives the serving worker's disk blocks byte for
    byte (and its chain meta); the two engines' blocks of the same prompt
    agree within 1e-5 (XLA's and PyTorch's CPU matmuls sum in another
    order)."""
    core_t = await _disk_only_worker(tmp_path, "t")
    jcore = core(True, tmp_path / "j")
    await serve(jcore, PROMPT, "cold", 4)
    await jcore.stop()
    jcore = core(True, tmp_path / "j")
    hashes = sorted(h for h, _t, _p in core_t.disk_store.registered_entries())
    assert hashes == sorted(h for h, _t, _p
                            in jcore.disk_store.registered_entries())
    async with daemon() as srv:
        t_rt = await DistributedRuntime.connect(srv.address)
        j_rt = await JRuntime.connect(srv.address)
        await Endpoint.parse_path(t_rt, "dyn://ns/t/kv_fabric").serve(
            KvFabricServer(core_t), decode_req=json.loads)
        await JEndpoint.parse_path(j_rt, "dyn://ns/j/kv_fabric").serve(
            jfabric.KvFabricServer(jcore), decode_req=json.loads)
        t_fab = await _client(t_rt, "port", "dyn://ns/j/kv_fabric")
        j_fab = await _client(j_rt, "jax", "dyn://ns/t/kv_fabric")
        try:
            got_t = await t_fab.fetch_async(j_rt.worker_id, hashes)
            got_j = await j_fab.fetch_async(t_rt.worker_id, hashes)
            served_j = jcore.disk_store.fetch(hashes)
            served_t = core_t.disk_store.fetch(hashes)
            for k in served_j:
                assert torch_bytes(got_t[k]) == served_j[k].tobytes()
                assert np.ascontiguousarray(got_j[k]).tobytes() == \
                    torch_bytes(served_t[k])
                np.testing.assert_allclose(served_t[k].numpy(), served_j[k],
                                           atol=1e-5)
            blob = (await t_fab._fetch_blobs_native(j_rt.worker_id,
                                                    hashes[:1]))[0]
            jblob = (await j_fab._fetch_blobs_native(t_rt.worker_id,
                                                     hashes[:1]))[0]
            assert unpack_block_bytes(blob)[1:] == \
                jremote.unpack_block_bytes(jblob)[1:] == \
                core_t.disk_store.meta_for(hashes[0])
            assert t_fab.dataplane_fallbacks_total == 0
            assert j_fab.dataplane_fallbacks_total == 0
        finally:
            await t_fab.close()
            await j_fab.close()
            await t_rt.shutdown()
            await j_rt.shutdown()
            await core_t.stop()
            await jcore.stop()


# --------------------------------------------------------------- launcher


def test_launcher_fabric_flags(tmp_path):
    """The launcher's remote-tier and fabric flags take the JAX launcher's
    defaults and reach the engine's config; a prefill-publish worker
    without the object tier exits with the JAX service's refusal."""
    from dynamo_tpu.launch import run as jlauncher
    from dynamo_tpu_torch.launch import run as launcher
    from tests.test_torch_disagg import _write_model_dir
    flags = ("kv_remote_dir", "kv_remote_blocks", "kv_fabric",
             "kv_remote_admission", "role")
    a = launcher.build_parser().parse_args(["in=none"])
    ja = jlauncher.build_parser().parse_args(["in=none"])
    assert {f: getattr(a, f) for f in flags} == \
        {f: getattr(ja, f) for f in flags}
    mdir = str(tmp_path / "m")
    _write_model_dir(mdir)
    common = ["--model-path", mdir, "--random-weights", "--device", "cpu",
              "--kv-block-size", "16", "--host-kv-blocks", "8",
              "--kv-disk-dir", str(tmp_path / "d"), "--kv-disk-blocks", "8"]
    a = launcher.build_parser().parse_args(
        ["in=none", *common, "--kv-remote-dir", str(tmp_path / "o"),
         "--kv-remote-blocks", "64", "--kv-remote-admission", "never"])
    core = launcher.build_core(a)
    assert (core.cfg.kv_remote_dir, core.cfg.kv_remote_blocks,
            core.cfg.kv_remote_admission) == (str(tmp_path / "o"), 64,
                                              "never")
    assert core.remote_store.object.capacity == 64
    with pytest.raises(SystemExit, match="needs the durable object tier"):
        asyncio.run(launcher.amain(["in=none", "out=torch", "--role",
                                    "prefill-publish", *common]))


# ----------------------------------------------------------------- router


def _metrics(pkg, load=0, link_gbps=0.0, rtt_s=1e-3, bpb=1 << 20,
             prefill=1e4):
    return pkg.ForwardPassMetrics(
        request_active_slots=0, request_total_slots=8,
        kv_active_blocks=load, kv_total_blocks=1024,
        remote_link_gbps=link_gbps, remote_link_rtt_s=rtt_s,
        kv_bytes_per_block=bpb, prefill_tok_per_s=prefill)


def _router_pkgs():
    import importlib
    out = {}
    for name, root in (("port", "dynamo_tpu_torch"), ("jax", "dynamo_tpu")):
        out[name] = {m: importlib.import_module(f"{root}.llm.kv_router.{m}")
                     for m in ("indexer", "protocols", "scheduler",
                               "scoring")}
        out[name]["blocks"] = importlib.import_module(f"{root}.llm.kv.blocks")
    return out


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_router_prefers_remote_holder_only_when_transfer_pays(pkg):
    """A 4-block prefix announced at tier "remote" on worker 1: a fast
    link keeps its credit (1 wins), a hopeless one strips it (the
    lighter 2 wins), in both packages."""
    m = _router_pkgs()[pkg]
    bs = 16
    tokens = list(range(4 * bs))
    idx = (m["indexer"].KvIndexer(block_size=bs) if pkg == "port" else
           m["indexer"].KvIndexer(block_size=bs, prefer_native=False))
    hashes = m["blocks"].compute_block_hashes(tokens, bs)
    idx.apply_event(m["protocols"].RouterEvent(
        worker_id=1, stored=m["protocols"].KvStoredEvent(
            parent_hash=None, block_hashes=hashes, tier="remote")))
    overlap = idx.find_matches(hashes)
    assert overlap.scores == {1: 4} and overlap.remote_blocks == {1: 4}

    def pick(link_gbps, rtt_s):
        sched = m["scheduler"].KvScheduler(block_size=bs)
        sched.update_endpoints(m["scoring"].ProcessedEndpoints([
            m["scoring"].Endpoint(1, _metrics(m["protocols"], load=50,
                                              link_gbps=link_gbps,
                                              rtt_s=rtt_s)),
            m["scoring"].Endpoint(2, _metrics(m["protocols"], load=49)),
        ]))
        return sched.schedule(len(tokens), overlap)

    assert pick(10.0, 1e-3) == 1
    assert pick(1e-6, 2.0) == 2


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_router_fabric_fetchable_credit(pkg):
    """Blocks worker 1 holds are fetchable by a fabric-attached worker 2:
    with a fast link the idle 2 wins over the drowning holder; a dark
    candidate gets no fabric credit."""
    m = _router_pkgs()[pkg]
    bs = 16
    overlap = m["indexer"].OverlapScores({1: 8}, weighted={1: 8.0})
    fast = _metrics(m["protocols"], link_gbps=10.0, rtt_s=1e-4)
    dark = _metrics(m["protocols"], link_gbps=0.0)
    adj = m["scoring"].network_adjusted_overlap
    assert adj(0.0, 0, 0, 8, bs, fast) > 0
    assert adj(0.0, 0, 0, 8, bs, dark) == 0.0
    sched = m["scheduler"].KvScheduler(block_size=bs)
    sched.update_endpoints(m["scoring"].ProcessedEndpoints([
        m["scoring"].Endpoint(1, _metrics(m["protocols"], load=1000,
                                          link_gbps=10.0, rtt_s=1e-4)),
        m["scoring"].Endpoint(2, _metrics(m["protocols"], load=0,
                                          link_gbps=10.0, rtt_s=1e-4)),
    ]))
    assert sched.schedule(8 * bs, overlap) == 2


def test_router_adjusted_overlap_equals_jax():
    """``network_adjusted_overlap`` over a grid of depths and links: the
    port's value is JAX's."""
    pk = _router_pkgs()
    for depth in (0, 2, 8):
        for remote in (0, 2):
            for gbps, rtt in ((10.0, 1e-4), (0.0, 1e-3), (1e-3, 0.5)):
                a = pk["port"]["scoring"].network_adjusted_overlap(
                    float(depth), depth, remote, 8, 16,
                    _metrics(pk["port"]["protocols"], link_gbps=gbps,
                             rtt_s=rtt))
                b = pk["jax"]["scoring"].network_adjusted_overlap(
                    float(depth), depth, remote, 8, 16,
                    _metrics(pk["jax"]["protocols"], link_gbps=gbps,
                             rtt_s=rtt))
                assert a == pytest.approx(b, rel=1e-12)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_tier_weights_runtime_settable(pkg):
    sc = _router_pkgs()[pkg]["scoring"]
    try:
        eff = sc.set_tier_weights({"remote": 0.9, "disk": 0.1,
                                   "bogus": 7.0, "host": None})
        assert eff["remote"] == 0.9 and eff["disk"] == 0.1
        assert "bogus" not in sc.TIER_WEIGHTS
        assert sc.tier_weighted_depth(2, ["disk", "remote"]) == \
            pytest.approx(1.0)
        assert sc.set_tier_weights({"device": 5.0})["device"] == 1.0
    finally:
        sc.reset_tier_weights()
    assert sc.TIER_WEIGHTS["disk"] == 0.5


async def test_netstore_bounded_jittered_retry_with_counter():
    """A transient daemon hiccup retries (jittered, counted) instead of
    failing; a dead daemon fails in bounded attempts."""
    from dynamo_tpu_torch.runtime import netstore
    from dynamo_tpu_torch.runtime.netstore import NetKvStore, _Conn
    async with daemon() as srv:
        store = await NetKvStore.connect(srv.address)
        conn = store._conn
        real = conn._call_once
        fails = {"n": 2}

        async def flaky(op, **kw):
            if fails["n"] > 0:
                fails["n"] -= 1
                raise ConnectionError("transient hiccup")
            return await real(op, **kw)

        conn._call_once = flaky
        before = netstore.retries_total()
        t0 = time.monotonic()
        await store.kv_put("k", b"v")
        assert conn.retries_total == 2
        assert netstore.retries_total() == before + 2
        assert time.monotonic() - t0 < conn.RETRY_WINDOW / 2
        assert (await store.kv_get("k")).value == b"v"

        async def dead(op, **kw):
            raise ConnectionError("daemon gone")

        conn._call_once = dead
        t0 = time.monotonic()
        with pytest.raises(ConnectionError):
            await store.kv_put("k2", b"v")
        assert time.monotonic() - t0 < conn.RETRY_WINDOW
        assert conn.retries_total >= 2 + (_Conn.MAX_CALL_RETRIES - 1)
        conn._call_once = real
        await store.close()
