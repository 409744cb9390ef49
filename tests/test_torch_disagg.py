"""The port's disaggregated prefill and decode against the JAX package's, on
the CPU (every case of ``tests/test_disagg.py`` but the tp reshard, which
waits for tp).

- Protocols: the KV payload (f32, bf16, int8 rows), the layer-stream
  manifest and layer frames and the remote-prefill request encode to the
  JAX package's bytes, and each package decodes the other's (exact).
- The handoff legs of ``engine/block_copy.py``: the dispatched gather
  fetched whole or a layer at a time, and the per-layer scatter, give the
  JAX package's bytes (exact: block copies move bytes).
- Routing: the threshold, its live update through the KV store, and the
  prefill queue's ack / nack.
- End to end on a tiny llama (f32 weights of one seed, the JAX init's, in
  both packages): a port prefill engine and a port decode engine in one
  process, over the device plane, the wire with the whole payload (in
  chunks too) and the wire layer by layer, greedy and seeded, over f32
  and int8 pools, and across KV quantizations on the device plane: each
  stream equals the JAX engine's local stream token for token (greedy
  and seeded sampling are keyed alike in both packages, so the contract
  is exact), the decode engine prefills nothing and the pool is only ever
  written in place. The fallback without a prefill worker, a short prompt
  under the threshold, a prefix hit after a remote prefill, the layout
  refusals, a torn layer frame (the monolithic rung), a dead stream (the
  cold rung), and a recorded run's replay and the JAX checkers on its
  log.
- Across packages over one daemon on the wire plane: a JAX prefill worker
  feeds a port decode engine, and a port prefill worker a JAX decode
  engine, with the whole payload and layer by layer: equal streams.
- Across processes (the JAX suite's ``tests/test_disagg_cross_process.py``):
  a worker script serves the prefill queue from another OS process over
  the port's daemon, the KV crossing on the TCP wire (f32 and int8 pools,
  whole and layer by layer), with the JAX engine's local streams; and the
  launcher as a user starts it, ``in=none out=torch --is-prefill-worker``
  in its own process beside ``--remote-prefill``'s decode engine here.

The JAX engines' local runs are shared through a module-scoped cache, and
the tiny engines run on one intra-op thread.
"""

import asyncio
import functools
import json
import os
import signal
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import block_copy as jbc
from dynamo_tpu.engine import replay as jreplay
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.core import EngineCore as JEngineCore
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.llm import disagg as jdisagg
from dynamo_tpu.llm.engines.jax_engine import JaxEngine
from dynamo_tpu.llm.kv import stream as jstream
from dynamo_tpu.llm.protocols import common as jcommon
from dynamo_tpu.llm.protocols import disagg as jproto
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu.runtime.distributed import DistributedRuntime as JRuntime
from dynamo_tpu.runtime.engine import EngineContext as JEngineContext
from dynamo_tpu_torch.engine import block_copy as tbc
from dynamo_tpu_torch.engine import replay as treplay
from dynamo_tpu_torch.engine.attention import KV_SCALE_LANES
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.core import (FINISH_SENTINEL, EngineCore,
                                          EngineRequest)
from dynamo_tpu_torch.engine.sampling import SlotSampling
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.launch import run as launcher
from dynamo_tpu_torch.llm import disagg as tdisagg
from dynamo_tpu_torch.llm.disagg import (DisaggEngine, DisaggregatedRouter,
                                         PrefillQueue, PrefillWorker)
from dynamo_tpu_torch.llm.engines.torch_engine import TorchEngine
from dynamo_tpu_torch.llm.kv import stream as tstream
from dynamo_tpu_torch.llm.kv.stream import (LayerStreamManifest,
                                            LayerStreamPayload, TornFrame)
from dynamo_tpu_torch.llm.protocols import common
from dynamo_tpu_torch.llm.protocols import disagg as tproto
from dynamo_tpu_torch.llm.protocols.disagg import (KvPayload,
                                                   RemotePrefillRequest,
                                                   decode_kv_payload,
                                                   encode_kv_payload)
from dynamo_tpu_torch.runtime import Context
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import EngineContext
from dynamo_tpu_torch.runtime.server import DiscoveryServer
from tests.test_torch_kv_offload import (BS, LAYOUTS, _pool, np_bytes,
                                         np_to_torch, torch_bytes)

pytestmark = pytest.mark.anyio

GEOM = dict(model_type="llama", vocab_size=128, hidden_size=64,
            intermediate_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, max_position_embeddings=256,
            tie_word_embeddings=False)
ECFG = dict(max_model_len=128, kv_block_size=8, num_kv_blocks=48,
            max_num_seqs=2, prefill_buckets=[16, 32, 64, 128])
PROMPT = [int(t) for t in np.random.default_rng(42).integers(2, 120,
                                                            size=37)]
SEEDED = dict(temperature=0.8, top_k=20, seed=1234)
WAIT = 60.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny engines run on one intra-op thread: their ops are too
    small to split, and the suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def np_params() -> dict:
    """The JAX init's f32 weights of the tiny llama (seed 0), as numpy."""
    p = jllama.init_params(JModelConfig(**GEOM), jax.random.PRNGKey(0),
                           dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def port_core(**over) -> EngineCore:
    cfg = ModelConfig(**GEOM)
    return EngineCore(cfg, EngineConfig(dtype="float32", **{**ECFG, **over}),
                      params=params_from_numpy(np_params(), cfg, "cpu",
                                               torch.float32),
                      device="cpu")


def jax_core(**over) -> JEngineCore:
    return JEngineCore(JModelConfig(**GEOM),
                       JEngineConfig(**{**ECFG, **over}),
                       params={k: jnp.asarray(v)
                               for k, v in np_params().items()},
                       attn_impl="xla", param_dtype=jnp.float32)


def request(pkg_jax: bool, rid: str, seeded=False, prompt=PROMPT,
            max_tokens=8):
    """A greedy (or seeded) request of ``max_tokens``, ignoring EOS, for
    either package's engines."""
    pkg, ctx, ectx = ((jcommon, JContext, JEngineContext) if pkg_jax
                      else (common, Context, EngineContext))
    samp = (pkg.SamplingOptions(**SEEDED) if seeded
            else pkg.SamplingOptions(greedy=True))
    pre = pkg.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=pkg.StopConditions(max_tokens=max_tokens,
                                           ignore_eos=True),
        sampling_options=samp)
    return ctx(pre, ctx=ectx(rid))


async def collect(stream) -> list:
    toks = []
    async for a in stream:
        if a.data is not None and a.data.token_ids:
            toks.extend(a.data.token_ids)
    return toks


@pytest.fixture(scope="module")
def want():
    """The JAX engine's local streams of PROMPT (greedy and seeded, f32 and
    int8 pools), each pool's engine built and run once: the reference of
    every disaggregated stream here. No prefix reuse, so the seeded run
    prefills cold like the greedy one."""
    cache = {}

    async def get(kv_quantization="none", seeded=False):
        if kv_quantization not in cache:
            core = jax_core(kv_quantization=kv_quantization,
                            enable_prefix_reuse=False)
            try:
                eng = JaxEngine(core)
                cache[kv_quantization] = {
                    s: await collect(await eng.generate(
                        request(True, f"want-{s}", seeded=s)))
                    for s in (False, True)}
            finally:
                await core.stop()
            assert all(len(v) == 8 for v in cache[kv_quantization].values())
        return cache[kv_quantization][seeded]
    return get


async def until(cond, timeout: float = WAIT) -> None:
    """Wait for ``cond()`` (a counter another task bumps)."""
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, "timed out"
        await asyncio.sleep(0.01)


def pool_ptrs(core) -> dict:
    return {k: v.data_ptr() for k, v in core.kv.items()}


# ---------------------------------------------------------------- protocols

PAYLOAD_DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16,
                  "int8": np.int8}


def _values(dt, keys=("k", "v"), shape=(2, 2, 3, 8, 16)):
    r = np.random.default_rng(0)
    if dt == np.int8:
        return {k: r.integers(-128, 128, size=shape).astype(dt)
                for k in keys}
    return {k: r.standard_normal(shape).astype(dt) for k in keys}


@pytest.mark.parametrize("dtype", list(PAYLOAD_DTYPES))
def test_kv_payload_bytes_equal_jax_both_ways(dtype):
    """Exact: the header and the data bytes of the JAX package's encoding,
    and each package decodes the other's."""
    vals = _values(PAYLOAD_DTYPES[dtype])
    jp = jproto.KvPayload(request_id="x", first_token=7, first_logprob=-0.5,
                          seq_hashes=[11, 22, 33], values=vals)
    tp = KvPayload(request_id="x", first_token=7, first_logprob=-0.5,
                   seq_hashes=[11, 22, 33],
                   values={k: np_to_torch(v) for k, v in vals.items()})
    jh, jd = jproto.encode_kv_payload(jp)
    th, td = encode_kv_payload(tp)
    assert th == jh and td == jd
    q = decode_kv_payload(jh, jd)
    assert (q.request_id, q.first_token, q.first_logprob, q.seq_hashes) == \
        ("x", 7, -0.5, [11, 22, 33])
    for k in vals:
        assert q.values[k].dtype == tp.values[k].dtype
        assert torch_bytes(q.values[k]) == np_bytes(vals[k])
    jq = jproto.decode_kv_payload(th, td)
    for k in vals:
        assert jq.values[k].dtype == vals[k].dtype
        assert np_bytes(jq.values[k]) == np_bytes(vals[k])


def test_kv_payload_latent_key_set_and_short_data():
    """An MLA pool's single "kv" key rides the same format; a payload
    shorter than its header announces is refused."""
    vals = _values(np.float32, keys=("kv",), shape=(3, 1, 2, 8, 192))
    tp = KvPayload("m", 1, 0.0, [5],
                   {k: np_to_torch(v) for k, v in vals.items()})
    th, td = encode_kv_payload(tp)
    assert (th, td) == jproto.encode_kv_payload(
        jproto.KvPayload("m", 1, 0.0, [5], vals))
    assert list(decode_kv_payload(th, td).values) == ["kv"]
    with pytest.raises(ValueError):
        decode_kv_payload(th, td[:-4])


def test_remote_prefill_request_json_equals_jax():
    kw = dict(request_id="a", token_ids=[1, 2, 3],
              sampling={"temperature": 0.0},
              connection_info={"address": "1.2.3.4:5", "stream_id": "s"},
              engine_id="e", prefix_hit_tokens=8, device_bridge="tok",
              deadline_ms=250.0, layer_stream=True)
    r = RemotePrefillRequest(**kw)
    assert r.to_json() == jproto.RemotePrefillRequest(**kw).to_json()
    assert RemotePrefillRequest.from_json(r.to_json()) == r
    pub = tproto.PrefillPublishRequest("p", [1, 2])
    assert pub.to_json() == jproto.PrefillPublishRequest("p", [1, 2]).to_json()


@pytest.mark.parametrize("dtype", list(PAYLOAD_DTYPES))
def test_layer_stream_frames_equal_jax_both_ways(dtype):
    """The manifest header and each layer frame are the JAX package's bytes
    (exact); each package decodes the other's frames; a short frame is
    refused."""
    dt = PAYLOAD_DTYPES[dtype]
    vals = _values(dt)
    name = np.dtype(dt).name
    kw = dict(request_id="s", first_token=3, first_logprob=-1.25,
              seq_hashes=[1, 2], num_layers=2, shape=[2, 3, 8, 16],
              dtype=name, keys=["k", "v"])
    tm, jm = LayerStreamManifest(**kw), jstream.LayerStreamManifest(**kw)
    assert tm.to_header() == jm.to_header()
    assert LayerStreamManifest.from_header(json.loads(jm.to_header())) == tm
    for layer in range(2):
        lv = {k: v[layer] for k, v in vals.items()}
        jh, jd = jstream.encode_layer_frame(layer, lv, ["k", "v"])
        th, td = tstream.encode_layer_frame(
            layer, {k: np_to_torch(v) for k, v in lv.items()}, ["k", "v"])
        assert (th, td) == (jh, jd)
        got = tstream.decode_layer_frame(tm, jd)
        assert all(torch_bytes(got[k]) == np_bytes(lv[k]) for k in lv)
        jgot = jstream.decode_layer_frame(jm, td)
        assert all(np_bytes(jgot[k]) == np_bytes(lv[k]) for k in lv)
    with pytest.raises(ValueError, match="short layer frame"):
        tstream.decode_layer_frame(tm, td[:-1])
    assert tstream.exposed_transfer_s(1.0, 4, 0.5) == \
        jstream.exposed_transfer_s(1.0, 4, 0.5)


# --------------------------------------------------------- the handoff legs

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_handoff_legs_equal_jax_bytes(layout):
    """The dispatched gather fetched whole and a layer at a time, and the
    per-layer scatter into another pool, give the JAX package's bytes
    (exact; the trash block apart), the pool written in place."""
    heads = LAYOUTS[layout][3]
    src = _pool(layout, 0)
    jkv = {k: jnp.asarray(v) for k, v in src.items()}
    tkv = {k: np_to_torch(v) for k, v in src.items()}
    ids = [2, 5, 7]
    jst = jbc.gather_blocks_dispatch(jkv, ids, BS)
    tst = tbc.gather_blocks_dispatch(tkv, ids, BS)
    jw, tw = jbc.fetch_wire(jst, 3, heads), tbc.fetch_wire(tst, 3, heads)
    dst_np = _pool(layout, 1)
    jdst = {k: jnp.asarray(v) for k, v in dst_np.items()}
    tdst = {k: np_to_torch(v) for k, v in dst_np.items()}
    ptrs = {k: v.data_ptr() for k, v in tdst.items()}
    for k in src:
        assert torch_bytes(tw[k]) == np_bytes(jw[k])
    for layer in range(next(iter(src.values())).shape[0]):
        jl = jbc.fetch_wire_layer(jst, 3, heads, layer)
        tl = tbc.fetch_wire_layer(tst, 3, heads, layer)
        for k in src:
            assert torch_bytes(tl[k]) == np_bytes(jl[k])
            assert torch.equal(tl[k], tw[k][layer])
        jdst = jbc.scatter_layer_from_host(jdst, [9, 3, 12], layer, jl, BS)
        tbc.scatter_layer_from_host(tdst, [9, 3, 12], layer, tl, BS)
    # past the trash block 0, where JAX's power-of-two padding of the id
    # list writes zeros (the port pads nothing)
    for k in src:
        assert torch_bytes(tdst[k][:, BS:]) == np_bytes(
            np.asarray(jdst[k])[:, BS:])
    assert {k: v.data_ptr() for k, v in tdst.items()} == ptrs


# ------------------------------------------------------------------- router

def test_disagg_router_threshold():
    rt = DistributedRuntime.in_process()
    r = DisaggregatedRouter(rt, "m", max_local_prefill_length=100)
    assert not r.prefill_remote(100, 0)
    assert r.prefill_remote(101, 0)
    assert not r.prefill_remote(200, 100)   # a prefix hit discounts
    r2 = DisaggregatedRouter(rt, "m", max_local_prefill_length=100,
                             conditional=False)
    assert r2.prefill_remote(1, 0)          # unconditional
    r.prefill_draining = True
    assert not r.prefill_remote(10_000, 0)  # a draining fleet: local
    assert tdisagg.disagg_config_key("m") == jdisagg.disagg_config_key("m")


async def test_disagg_router_live_reconfig():
    """A threshold written through the KV store reaches a started router
    (the JAX router's key and value)."""
    rt = DistributedRuntime.in_process()
    r = await DisaggregatedRouter(rt, "m",
                                  max_local_prefill_length=100).start()
    try:
        await r.publish_threshold(7)
        for _ in range(250):
            if r.max_local_prefill_length == 7:
                break
            await asyncio.sleep(0.02)
        assert r.max_local_prefill_length == 7
        # a bad value is ignored
        await rt.store.kv_put(tdisagg.disagg_config_key("m"), b"{bad")
        await asyncio.sleep(0.05)
        assert r.max_local_prefill_length == 7
    finally:
        await r.stop()
        await rt.shutdown()


async def test_prefill_queue_ack_nack():
    rt = DistributedRuntime.in_process()
    q = PrefillQueue(rt)
    r = RemotePrefillRequest("a", [1], {}, {"address": "x:1",
                                            "stream_id": "s"})
    await q.enqueue(r)
    item = await q.dequeue(timeout=1)
    assert item is not None
    await q.nack(item.id)
    item2 = await q.dequeue(timeout=1)
    assert item2.deliveries == 2
    assert RemotePrefillRequest.from_json(item2.payload) == r
    await q.ack(item2.id)
    assert await q.depth() == 0
    await rt.shutdown()


# ------------------------------------------------------ end-to-end handoff

class Pair:
    """A port prefill worker and a port decode engine on one in-process
    runtime."""

    def __init__(self, prefill_kw=None, decode_kw=None, **engine_kw):
        self.rt = DistributedRuntime.in_process()
        self.prefill = port_core(**(prefill_kw or {}))
        self.decode = port_core(**(decode_kw or {}))
        engine_kw.setdefault("prefill_timeout", WAIT)
        self.router = DisaggregatedRouter(
            self.rt, "tiny", max_local_prefill_length=engine_kw.pop(
                "threshold", 0), conditional=engine_kw.pop(
                "conditional", False))
        self.engine = DisaggEngine(self.decode, self.rt, self.router,
                                   **engine_kw)
        self.worker = None
        self.ptrs = pool_ptrs(self.decode)

    async def start(self) -> "Pair":
        self.worker = await PrefillWorker(self.prefill, self.rt).start()
        return self

    async def generate(self, rid, seeded=False, **kw) -> list:
        return await collect(await self.engine.generate(
            request(False, rid, seeded=seeded, **kw)))

    async def close(self) -> None:
        # the decode pool was only ever written in place
        assert pool_ptrs(self.decode) == self.ptrs
        if self.worker is not None:
            await self.worker.stop()
        await self.prefill.stop()
        await self.decode.stop()
        await self.rt.shutdown()


def gate_layers(monkeypatch, until, module=tdisagg) -> list:
    """Senders of ``module``'s prefill worker (the port's, or the JAX
    package's) hold every layer frame until ``until()`` (the decode engine
    has admitted against the manifest), so a test sees layers land after
    the admission whatever the host's timing. Returns the headers sent."""
    real = module.open_stream_sender
    headers = []

    async def gated(conn, timeout):
        sender = await real(conn, timeout=timeout)
        send = sender.send

        async def held(data, header=b""):
            if header and json.loads(header).get("stream") == "kv_layer":
                while not until():
                    await asyncio.sleep(0.005)
            headers.append(header)
            await send(data, header=header)
        sender.send = held
        return sender
    monkeypatch.setattr(module, "open_stream_sender", gated)
    return headers


PLANES = {"device": dict(device_plane=True),
          "wire": dict(device_plane=False, layer_stream=False),
          "wire_layers": dict(device_plane=False, layer_stream=True)}


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("plane", list(PLANES))
async def test_remote_prefill_matches_jax_local(want, monkeypatch, plane,
                                               kv_quant):
    """A port prefill engine hands the prompt's KV to a port decode engine
    over each plane, over f32 and int8 pools: the greedy stream equals the
    JAX engine's local stream (exact); the decode engine prefilled
    nothing, and each plane's counters say which plane it took."""
    pair = Pair(prefill_kw=dict(kv_quantization=kv_quant),
                decode_kw=dict(kv_quantization=kv_quant), **PLANES[plane])
    gate_layers(monkeypatch, lambda: pair.decode.disagg_stream_admits == 1)
    await pair.start()
    try:
        got = await pair.generate(f"got-{plane}-{kv_quant}")
        assert got == await want(kv_quant)
        eng, wrk = pair.engine, pair.worker
        assert eng.remote_prefills == 1 and eng.remote_failures == 0
        # the worker counts once its send and ack are done
        await until(lambda: wrk.prefills_done == 1)
        assert pair.prefill.total_prefill_tokens == len(PROMPT)
        assert pair.decode.total_prefill_tokens == 0
        assert pair.decode.total_decode_tokens >= 7
        assert eng.device_transfers == wrk.device_handoffs == (
            plane == "device")
        assert eng.stream_transfers == wrk.stream_handoffs == (
            plane == "wire_layers")
        assert pair.decode.disagg_stream_admits == (plane == "wire_layers")
        rec = [r for r in pair.decode.flight.dump() if r["kind"] == "prefill"]
        assert [(r["precomputed"], r["hit_remote"]) for r in rec] == \
            [(True, 0)]
    finally:
        await pair.close()


async def test_remote_prefill_chunked_transfer(want, monkeypatch):
    """A KV payload larger than one chunk crosses in several frames."""
    monkeypatch.setattr(tstream, "KV_CHUNK_BYTES", 1024)
    sends = []
    real = tdisagg.open_stream_sender

    async def counting(conn, timeout):
        sender = await real(conn, timeout=timeout)
        send = sender.send

        async def counted(data, header=b""):
            sends.append(len(data))
            await send(data, header=header)
        sender.send = counted
        return sender
    monkeypatch.setattr(tdisagg, "open_stream_sender", counting)
    pair = await Pair(device_plane=False, layer_stream=False).start()
    try:
        assert await pair.generate("chunked") == await want()
        assert pair.engine.remote_prefills == 1
        assert len(sends) == -(-sum(sends) // 1024) > 1
    finally:
        await pair.close()


async def test_disagg_fallback_without_prefill_worker(want):
    """No prefill worker: the decode engine prefills locally after the
    timeout, with the JAX engine's local stream."""
    pair = Pair(prefill_timeout=0.5)
    try:
        assert await pair.generate("fallback") == await want()
        assert pair.engine.remote_failures == 1
        assert pair.engine.local_prefills == 1
        assert pair.decode.total_prefill_tokens == len(PROMPT)
    finally:
        await pair.close()


async def test_conditional_disagg_short_prompt_stays_local(want):
    """Under the threshold: no queue traffic, a local prefill."""
    pair = Pair(threshold=1000, conditional=True)
    try:
        toks = await pair.generate("short")
        assert toks == await want()
        assert pair.engine.local_prefills == 1
        assert pair.engine.remote_prefills == 0
        assert await PrefillQueue(pair.rt).depth() == 0
    finally:
        await pair.close()


async def test_decode_prefix_reuse_after_remote_prefill(want):
    """After one remote prefill the decode engine's pool holds the prompt's
    blocks: a repeat hits them and, 5 un-cached tokens being under the
    threshold of 16, prefills locally."""
    pair = await Pair(threshold=16, conditional=True).start()
    try:
        first = await pair.generate("one")
        assert pair.engine.remote_prefills == 1
        second = await pair.generate("two")
        assert first == second == await want()
        assert pair.engine.local_prefills == 1
        assert pair.decode.total_prefill_tokens == len(PROMPT) - 32
    finally:
        await pair.close()


async def test_disagg_kv_layout_mismatch_fails_loudly():
    """A decode engine refuses payloads it cannot serve: the wire plane
    never repacks, and a width or dtype that differs fails at submit (to
    the caller), after which the engine keeps serving."""
    core8, core_f = port_core(kv_quantization="int8"), port_core()
    try:
        lanes8 = core8.kv["k"].shape[-1]          # C + KV_SCALE_LANES
        lanes_f = core_f.kv["k"].shape[-1]        # C
        with pytest.raises(ValueError, match="layout mismatch"):
            core_f._check_kv_payload_layout(lanes8, np.int8, "wire")
        with pytest.raises(ValueError, match="layout mismatch"):
            core8._check_kv_payload_layout(lanes_f, np.float32, "wire")
        with pytest.raises(ValueError, match="layout mismatch"):
            core8._check_kv_payload_layout(lanes8, np.float32, "device")
        with pytest.raises(ValueError, match="layout mismatch"):
            core8._check_kv_payload_layout(lanes8 + KV_SCALE_LANES,
                                           torch.int8, "device")
        core8._check_kv_payload_layout(lanes8, np.int8, "wire")
        core_f._check_kv_payload_layout(lanes_f, torch.float32, "wire")
        bad = KvPayload(
            request_id="bad", first_token=3, first_logprob=0.0,
            seq_hashes=[1],
            values={k: torch.zeros((2, 1, 1, 8, lanes8), dtype=torch.int8)
                    for k in ("k", "v")})
        req = EngineRequest(rid="bad", prompt=list(range(2, 12)),
                            sampling=SlotSampling(temperature=0.0),
                            max_new_tokens=2, eos_ids=frozenset(),
                            precomputed=bad)
        with pytest.raises(ValueError, match="layout mismatch"):
            await core_f.submit(req)
        # a layer stream of another depth or block size is refused too
        man = dict(request_id="s", first_token=0, first_logprob=0.0,
                   seq_hashes=[], num_layers=3, shape=[2, 1, 8, 16],
                   dtype="float32", keys=["k", "v"])
        for over in (dict(), dict(num_layers=2, shape=[2, 1, 4, 16])):
            req.precomputed = LayerStreamPayload(
                LayerStreamManifest(**{**man, **over}))
            with pytest.raises(ValueError, match="layout mismatch"):
                await core_f.submit(req)
        ok = EngineRequest(rid="ok", prompt=list(range(2, 12)),
                           sampling=SlotSampling(temperature=0.0),
                           max_new_tokens=2, eos_ids=frozenset())
        await core_f.submit(ok)
        toks = []
        while True:
            item, _ = await asyncio.wait_for(ok.out_queue.get(), WAIT)
            if item is FINISH_SENTINEL:
                break
            toks.append(item)
        assert len(toks) == 2
    finally:
        await core8.stop()
        await core_f.stop()


@pytest.mark.parametrize("src_q,dst_q", [("none", "int8"),
                                         ("int8", "none")])
async def test_remote_prefill_cross_quant_repack(want, src_q, dst_q):
    """Device plane across KV quantizations: the decode engine repacks the
    payload's rows into its pool's format (dequantize, or quantize through
    bf16) off the loop. The greedy stream equals the JAX engine's local
    stream over the DECODE side's pool, token for token at this geometry
    (the JAX suite's own contract for the repack)."""
    pair = await Pair(prefill_kw=dict(kv_quantization=src_q),
                      decode_kw=dict(kv_quantization=dst_q),
                      device_plane=True).start()
    try:
        assert await pair.generate(f"xq-{src_q}-{dst_q}") == \
            await want(dst_q)
        assert pair.decode.total_prefill_tokens == 0
        assert pair.engine.device_transfers == 1
    finally:
        await pair.close()


# ------------------------------------------- layer-wise streaming handoff

@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
async def test_layer_stream_matches_monolithic(want, monkeypatch, seeded):
    """The layer-streamed wire handoff gives the monolithic handoff's
    tokens and the JAX engine's local stream (exact, greedy and seeded),
    one layer at a time while the request is admitted; the counters and
    ForwardPassMetrics fields say so."""
    mono = await Pair(device_plane=False, layer_stream=False).start()
    try:
        m = await mono.generate("ls", seeded=seeded)
        assert mono.decode.disagg_stream_admits == 0
        assert mono.engine.stream_transfers == 0
    finally:
        await mono.close()
    pair = Pair(device_plane=False, layer_stream=True)
    gate_layers(monkeypatch, lambda: pair.decode.disagg_stream_admits == 1)
    await pair.start()
    try:
        s = await pair.generate("ls", seeded=seeded)
        assert s == m == await want(seeded=seeded)
        core = pair.decode
        assert core.disagg_stream_admits == 1
        assert core.disagg_stream_fallbacks == 0
        assert core.disagg_stream_layers_scattered == GEOM["num_layers"]
        assert core.total_prefill_tokens == 0
        await until(lambda: pair.worker.stream_handoffs == 1)
        assert pair.worker.stream_fallbacks == 0
        assert pair.engine.stream_transfers == 1
        fm = core.metrics()
        assert fm.disagg_stream_layers_total == GEOM["num_layers"]
        assert fm.disagg_stream_layers == GEOM["num_layers"]
        assert fm.disagg_stream_fallbacks_total == 0
        assert 0.0 <= fm.disagg_stream_overlap_ratio <= 1.0
    finally:
        await pair.close()


async def test_layer_stream_landed_whole_admits_per_layer(want, monkeypatch):
    """A layer stream whose frames have all landed before the decode engine
    admits it still takes the per-layer onboard (one staged scatter a
    layer, none of the whole stack at once): the JAX engine's local
    stream (exact), every layer counted as streamed."""
    pair = Pair(device_plane=False, layer_stream=True)
    real = pair.decode.submit
    whole = []

    async def submit_when_landed(req):
        pc = req.precomputed
        if isinstance(pc, LayerStreamPayload):
            while not (pc.complete or pc.failed):
                await asyncio.sleep(0.005)
            whole.append(pc.complete)
        await real(req)
    monkeypatch.setattr(pair.decode, "submit", submit_when_landed)
    await pair.start()
    try:
        assert await pair.generate("landed") == await want()
        core = pair.decode
        assert whole == [True]
        assert core.disagg_stream_admits == 1
        assert core.disagg_stream_layers_scattered == GEOM["num_layers"]
        assert core.metrics().disagg_stream_layers_total == \
            GEOM["num_layers"]
        assert core.total_prefill_tokens == 0
        assert pair.engine.stream_transfers == 1
    finally:
        await pair.close()


async def test_layer_stream_torn_frame_degrades_to_monolithic(want,
                                                              monkeypatch):
    """A layer frame that tears (the sender raises TornFrame for layer 1)
    degrades to the monolithic payload on the same stream: the decode
    engine fills the rest from it, with the JAX engine's local stream."""
    pair = Pair(device_plane=False, layer_stream=True)
    real = tdisagg.open_stream_sender

    async def tearing(conn, timeout):
        sender = await real(conn, timeout=timeout)
        send = sender.send

        async def torn(data, header=b""):
            h = json.loads(header) if header else {}
            if h.get("stream") == "kv_layer":
                while pair.decode.disagg_stream_admits < 1:
                    await asyncio.sleep(0.005)
                if h["layer"] == 1:
                    raise TornFrame("layer 1")
            await send(data, header=header)
        sender.send = torn
        return sender
    monkeypatch.setattr(tdisagg, "open_stream_sender", tearing)
    await pair.start()
    try:
        assert await pair.generate("torn") == await want()
        await until(lambda: pair.worker.stream_fallbacks == 1)
        assert pair.decode.disagg_stream_fallbacks == 1
        assert pair.decode.disagg_stream_layers_scattered == \
            GEOM["num_layers"]
        assert pair.decode.total_prefill_tokens == 0
    finally:
        await pair.close()


async def test_layer_stream_peer_death_recovers_cold(want):
    """The producer dies mid-stream (one layer landed, the rest never
    will): the decode engine releases the half-onboarded slot and re-admits
    COLD, serving the JAX engine's local stream exactly, with no leaked
    blocks."""
    core = port_core()
    try:
        n_blocks = -(-len(PROMPT) // ECFG["kv_block_size"])
        manifest = LayerStreamManifest(
            request_id="dead", first_token=0, first_logprob=0.0,
            seq_hashes=[1, 2, 3, 4], num_layers=GEOM["num_layers"],
            shape=[GEOM["num_kv_heads"], n_blocks, ECFG["kv_block_size"],
                   GEOM["head_dim"]],
            dtype="float32", keys=["k", "v"])
        payload = LayerStreamPayload(manifest)
        req = EngineRequest(rid="dead", prompt=list(PROMPT),
                            sampling=SlotSampling(temperature=0.0),
                            max_new_tokens=8, eos_ids=frozenset(),
                            precomputed=payload)
        await core.submit(req)
        g = torch.Generator().manual_seed(7)
        payload.put_layer(0, {k: torch.randn(manifest.shape, generator=g)
                              for k in ("k", "v")})
        for _ in range(500):
            if core.disagg_stream_layers_scattered >= 1:
                break
            await asyncio.sleep(0.01)
        assert core.disagg_stream_admits == 1
        assert core.slots[req.slot] is req and not req.ready
        payload.fail("peer died mid-stream")
        toks = []
        while True:
            item, _ = await asyncio.wait_for(req.out_queue.get(), WAIT)
            if item is FINISH_SENTINEL:
                break
            toks.append(item)
        assert toks == await want()
        assert core.disagg_stream_fallbacks == 1
        assert core.total_prefill_tokens == len(PROMPT)
        for _ in range(100):
            if all(s is None for s in core.slots):
                break
            await asyncio.sleep(0.02)
        assert core.kv_manager.pool.used_blocks == 0
        assert all(s is None for s in core.slots)
    finally:
        await core.stop()


async def test_disagg_recorded_runs_replay(want, monkeypatch):
    """A recorded decode engine's log of a layer-streamed and of a
    whole-payload admission (``kv_layer_stream``, ``precomputed_admit``)
    passes the port's and the JAX package's checkers and replays to the
    live tokens; the prefill engine's log (``handoff_gather``) replays
    too; a device-plane admission (``precomputed_device_admit``) is
    refused by an offline replay, as in the JAX package."""
    logs = {}
    for plane in ("wire_layers", "wire", "device"):
        pair = Pair(**PLANES[plane])
        pair.decode.recorder = treplay.Recorder()
        pair.prefill.recorder = treplay.Recorder()
        if plane == "wire_layers":
            gate_layers(monkeypatch,
                        lambda p=pair: p.decode.disagg_stream_admits == 1)
        await pair.start()
        try:
            assert await pair.generate(f"rec-{plane}") == await want()
        finally:
            await pair.close()
        logs[plane] = pair
    bs = ECFG["kv_block_size"]
    ev = logs["wire_layers"].decode.recorder.events
    ls = [e for e in ev if e["ev"] == "kv_layer_stream"]
    assert sorted(e["layer"] for e in ls) == list(range(GEOM["num_layers"]))
    assert all(e["num_layers"] == GEOM["num_layers"] and e["targets"]
               for e in ls)
    assert sum(e["ev"] == "precomputed_admit"
               for e in logs["wire"].decode.recorder.events) == 1
    for plane in ("wire_layers", "wire"):
        p = logs[plane]
        for core in (p.decode, p.prefill):
            events = core.recorder.events
            assert treplay.check_log(events, block_size=bs) == []
            assert treplay.check_inputs(events) == []
            assert jreplay.check_log(events, block_size=bs) == []
            assert jreplay.check_inputs(events) == []
            assert treplay.compare_replay(
                events, treplay.replay(core, events)) == []
        assert [e["ev"] for e in p.prefill.recorder.events
                if e["ev"] == "handoff_gather"] == ["handoff_gather"]
    dev = logs["device"].decode.recorder.events
    assert [e for e in dev if e["ev"] == "precomputed_device_admit"]
    with pytest.raises(NotImplementedError, match="device-plane"):
        treplay.replay(logs["device"].decode, dev)


# ------------------------------------------------------- across packages

async def test_cross_package_pairs_over_one_daemon(want, monkeypatch):
    """One daemon (the port's), wire plane: a JAX prefill worker feeds a
    port decode engine, then a port prefill worker a JAX decode engine,
    each with the whole payload and layer by layer. Every stream equals
    the JAX engine's local stream, every handoff is remote (no fallback),
    and neither decode engine prefills."""
    srv = DiscoveryServer(host="127.0.0.1")
    await srv.start()
    j_rt = await JRuntime.connect(srv.address)
    t_rt = await DistributedRuntime.connect(srv.address)
    jcore = jax_core(enable_prefix_reuse=False)
    tcore = port_core(enable_prefix_reuse=False)
    ref = await want()
    try:
        # a JAX producer, a port consumer (its layer frames held until the
        # port engine has admitted against the manifest)
        gate_layers(monkeypatch, lambda: tcore.disagg_stream_admits == 1,
                    module=jdisagg)
        jw = await jdisagg.PrefillWorker(jcore, j_rt).start()
        try:
            for layered in (False, True):
                router = DisaggregatedRouter(t_rt, "tiny", conditional=False)
                eng = DisaggEngine(tcore, t_rt, router, prefill_timeout=WAIT,
                                   device_plane=False, layer_stream=layered)
                got = await collect(await eng.generate(
                    request(False, f"j2t-{layered}")))
                assert got == ref
                assert eng.remote_prefills == 1 and eng.remote_failures == 0
                assert eng.stream_transfers == layered
            # the worker counts a prefill once its ack is back
            await until(lambda: jw.prefills_done == 2)
            assert jw.stream_handoffs == 1
            assert tcore.total_prefill_tokens == 0
            assert tcore.disagg_stream_layers_scattered == GEOM["num_layers"]
        finally:
            await jw.stop()
        # a port producer, a JAX consumer, on a queue of their own (the
        # stopped JAX worker's last dequeue may still wait on the first)
        tw = await PrefillWorker(tcore, t_rt,
                                 queue=PrefillQueue(t_rt, "prefill_2")).start()
        try:
            for layered in (False, True):
                router = jdisagg.DisaggregatedRouter(j_rt, "tiny",
                                                     conditional=False)
                eng = jdisagg.DisaggEngine(jcore, j_rt, router,
                                           queue=jdisagg.PrefillQueue(
                                               j_rt, "prefill_2"),
                                           prefill_timeout=WAIT,
                                           device_plane=False,
                                           layer_stream=layered)
                got = await collect(await eng.generate(
                    request(True, f"t2j-{layered}")))
                assert got == ref
                assert eng.remote_prefills == 1 and eng.remote_failures == 0
                assert eng.stream_transfers == layered
            await until(lambda: tw.prefills_done == 2)
            assert tw.stream_handoffs == 1
            assert jcore.total_prefill_tokens == 2 * len(PROMPT)  # as worker
        finally:
            await tw.stop()
    finally:
        await jcore.stop()
        await tcore.stop()
        await t_rt.shutdown()
        await j_rt.shutdown()
        await srv.close()


# ----------------------------------------------------------------- launcher

def test_launcher_disagg_flags():
    """The launcher's disaggregation flags (the JAX launcher's, with their
    defaults), and the refusals: the roles need out=torch, and the
    prefill-publish role excludes the disaggregation roles."""
    p = launcher.build_parser()
    a = p.parse_args(["in=none", "out=torch", "--is-prefill-worker"])
    assert a.is_prefill_worker and not a.remote_prefill
    assert a.max_local_prefill_length == 512 and not a.unconditional_disagg
    a = p.parse_args(["in=http", "out=torch", "--remote-prefill",
                      "--max-local-prefill-length", "64",
                      "--unconditional-disagg"])
    assert a.remote_prefill and a.max_local_prefill_length == 64
    assert a.unconditional_disagg and a.role == "serve"
    with pytest.raises(SystemExit, match="excludes"):
        asyncio.run(launcher.amain(["in=none", "out=torch", "--role",
                                    "prefill-publish", "--remote-prefill"]))
    with pytest.raises(SystemExit, match="needs out=torch"):
        asyncio.run(launcher.amain(["in=none", "out=echo_core", "--role",
                                    "prefill-publish"]))
    with pytest.raises(SystemExit, match="out=torch"):
        asyncio.run(launcher.amain(["in=none", "out=echo_core",
                                    "--is-prefill-worker"]))
    with pytest.raises(SystemExit, match="exclude"):
        asyncio.run(launcher.amain(["in=none", "out=torch",
                                    "--is-prefill-worker",
                                    "--remote-prefill"]))


async def test_launcher_disagg_engine_watches_the_threshold():
    """``--remote-prefill``'s engine (``launch.run.disagg_engine``): the
    flags' threshold, then a value written to the KV store moves a long
    prompt local."""
    args = launcher.build_parser().parse_args(
        ["in=http", "out=torch", "--remote-prefill",
         "--max-local-prefill-length", "16", "--model-name", "tiny"])
    rt = DistributedRuntime.in_process()
    core = port_core()
    eng = await launcher.disagg_engine(args, core, rt)
    try:
        assert isinstance(eng, DisaggEngine)
        assert eng.disagg_router.max_local_prefill_length == 16
        assert eng.disagg_router.prefill_remote(len(PROMPT), 0)
        await eng.disagg_router.publish_threshold(1000)
        for _ in range(250):
            if eng.disagg_router.max_local_prefill_length == 1000:
                break
            await asyncio.sleep(0.02)
        toks = await collect(await eng.generate(request(False, "local")))
        assert len(toks) == 8
        assert eng.local_prefills == 1 and eng.remote_prefills == 0
    finally:
        await eng.disagg_router.stop()
        await core.stop()
        await rt.shutdown()


# ------------------------------------------------------- across processes

# a child started from a shell's background job inherits SIGINT ignored,
# and Python then installs no KeyboardInterrupt handler: the children
# restore it, so that SIGINT stops them the way a user's Ctrl-C does
WORKER_SCRIPT = textwrap.dedent("""
    import asyncio, signal, sys
    signal.signal(signal.SIGINT, signal.default_int_handler)
    sys.path.insert(0, {repo!r})
    import numpy as np, torch
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.core import EngineCore
    from dynamo_tpu_torch.engine.weights import params_from_numpy
    from dynamo_tpu_torch.llm.disagg import PrefillWorker
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    async def main():
        rt = await DistributedRuntime.connect(sys.argv[1])
        cfg = ModelConfig(**{geom!r})
        params = dict(np.load(sys.argv[2]))
        core = EngineCore(
            cfg, EngineConfig(dtype="float32", kv_quantization={kvq!r},
                              **{ecfg!r}),
            params=params_from_numpy(params, cfg, "cpu", torch.float32),
            device="cpu")
        worker = await PrefillWorker(core, rt).start()
        print("PREFILL-WORKER-READY", flush=True)
        await asyncio.Event().wait()

    asyncio.run(main())
""")


# ``python -m dynamo_tpu_torch.launch.run`` with SIGINT's handler restored
LAUNCH = ("import runpy, signal; "
          "signal.signal(signal.SIGINT, signal.default_int_handler); "
          "runpy.run_module('dynamo_tpu_torch.launch.run', "
          "run_name='__main__', alter_sys=True)")


class Proc:
    """A child process whose output is read as it comes (so that nothing
    is lost however it ends)."""

    def __init__(self, proc):
        self.proc = proc
        self.lines: list = []
        self._pump = asyncio.get_running_loop().create_task(self._read())

    async def _read(self) -> None:
        while True:
            line = await self.proc.stdout.readline()
            if not line:
                return
            self.lines.append(line.decode(errors="replace"))

    async def ready(self, marker: str) -> None:
        deadline = asyncio.get_running_loop().time() + WAIT
        while not any(marker in ln for ln in self.lines):
            if self.proc.returncode is not None or self._pump.done():
                raise AssertionError(f"the process exited before "
                                     f"{marker!r}:\n{self.text()[-2000:]}")
            if asyncio.get_running_loop().time() > deadline:
                raise AssertionError(f"no {marker!r} in {WAIT} s")
            await asyncio.sleep(0.05)

    def text(self) -> str:
        return "".join(self.lines)

    async def stop(self) -> str:
        """SIGINT, the exit (killed after a minute), all of its output."""
        if self.proc.returncode is None:
            self.proc.send_signal(signal.SIGINT)
        try:
            await asyncio.wait_for(self.proc.wait(), 60)
        except asyncio.TimeoutError:
            self.proc.kill()
            await self.proc.wait()
        await self._pump
        return self.text()


async def spawn(*args, **kw) -> Proc:
    """A child process on one intra-op thread, as this module's engines."""
    return Proc(await asyncio.create_subprocess_exec(
        *args, stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.STDOUT,
        env=dict(os.environ, OMP_NUM_THREADS="1"), **kw))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
async def test_cross_process_remote_prefill_matches_jax_local(want, tmp_path,
                                                              kv_quant):
    """Another process's prefill worker, the whole payload and then a
    layer stream: each stream equals the JAX engine's local stream (exact;
    int8 rows cross whole, with their in-row scales)."""
    ref = await want(kv_quant)
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **np_params())
    srv = DiscoveryServer(host="127.0.0.1")
    await srv.start()
    script = WORKER_SCRIPT.format(repo=REPO, geom=GEOM, ecfg=ECFG,
                                  kvq=kv_quant)
    proc = await spawn(sys.executable, "-c", script, srv.address, npz)
    decode_core = port_core(kv_quantization=kv_quant)
    rt = await DistributedRuntime.connect(srv.address)
    try:
        await proc.ready("PREFILL-WORKER-READY")
        for layered in (False, True):
            router = DisaggregatedRouter(rt, "tiny", conditional=False)
            engine = DisaggEngine(decode_core, rt, router,
                                  prefill_timeout=WAIT,
                                  layer_stream=layered)
            got = await collect(await engine.generate(
                request(False, f"got-{layered}")))
            assert got == ref
            assert engine.remote_prefills == 1
            assert engine.remote_failures == 0
            # another process: the device plane cannot have engaged
            assert engine.device_transfers == 0
            assert engine.stream_transfers == layered
        # (whether the engine admits before the last layer lands depends
        # on the two processes' timing: test_torch_disagg pins it)
        assert decode_core.total_prefill_tokens == 0
    finally:
        await proc.stop()
        await decode_core.stop()
        await rt.shutdown()
        await srv.close()


def _write_model_dir(d: str) -> None:
    import shutil
    os.makedirs(d, exist_ok=True)
    shutil.copy(os.path.join(REPO, "tests", "data", "sp", "tiny.model"),
                os.path.join(d, "tokenizer.model"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"vocab_size": 307, "hidden_size": 64,
                   "intermediate_size": 128, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "num_key_value_heads": 2,
                   "head_dim": 16, "max_position_embeddings": 512,
                   "eos_token_id": 2}, f)


async def test_launcher_prefill_worker_process(tmp_path):
    """``launch.run in=none out=torch --is-prefill-worker`` in its own
    process and the ``--remote-prefill`` decode side here: the stream
    equals a local engine's of the same flags, and the worker logs one
    prefill done at SIGINT."""
    mdir = str(tmp_path / "m")
    _write_model_dir(mdir)
    srv = DiscoveryServer(host="127.0.0.1")
    await srv.start()
    common = ["out=torch", "--model-path", mdir, "--model-name", "tiny",
              "--random-weights", "--device", "cpu", "--kv-block-size", "8",
              "--num-kv-blocks", "48", "--max-model-len", "128"]
    proc = await spawn(sys.executable, "-c", LAUNCH, "in=none", *common,
                       "--is-prefill-worker", "--runtime-server",
                       srv.address, cwd=REPO)
    args = launcher.build_parser().parse_args(
        ["in=http", *common, "--remote-prefill",
         "--max-local-prefill-length", "16"])
    prompt = list(range(10, 60))
    local = launcher.build_core(args)
    try:
        ref = await collect(await TorchEngine(local).generate(
            request(False, "want", prompt=prompt)))
    finally:
        await local.stop()
    core = launcher.build_core(args)
    rt = await DistributedRuntime.connect(srv.address)
    engine = await launcher.disagg_engine(args, core, rt)
    engine.prefill_timeout = WAIT
    out = ""
    try:
        await proc.ready("READY prefill worker")
        got = await collect(await engine.generate(
            request(False, "got", prompt=prompt)))
        assert got == ref and len(got) == 8
        assert engine.remote_prefills == 1 and engine.remote_failures == 0
        assert core.total_prefill_tokens == 0
    finally:
        out = await proc.stop()
        await engine.disagg_router.stop()
        await core.stop()
        await rt.shutdown()
        await srv.close()
    stats = [ln for ln in out.splitlines() if "prefill worker stats" in ln]
    assert stats, out[-2000:]
    assert json.loads(stats[-1].split("stats ", 1)[1])["prefills_done"] == 1
