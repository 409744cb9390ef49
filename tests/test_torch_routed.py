"""KV-aware routing end to end, the port's graph against the JAX package's,
on the CPU:

- one routed graph per package, in one process: the package's KV-routed
  engine (the processor's router and dispatch) in front of two workers of
  that package (tiny llama, f32 weights of one seed, int8 KV, the host
  tier on) served on ``dyn://routed/worker/generate`` of an in-process
  runtime, each publishing its tier-aware KV events. The same prefix-group
  traffic (seeds sent together, follow-ups one at a time, then a worker
  stopped and more requests) gives the same routing decisions (worker,
  prompt blocks, overlap), the same token streams and the same prefix hits
  in both graphs, and every follow-up lands on the worker holding its
  group's prefix;
- the tier-aware KV event stream of a port engine equals the JAX engine's
  over a scripted run whose evictions go to the host and the disk tier;
- the port's own processes: the daemon, two ``in=dyn://… --protocol
  tokens`` workers and the processor, driven over HTTP, route a follow-up
  to its prefix's worker, and after a worker is killed the survivor serves;
- the refusals: ``--protocol openai`` on a ``dyn://`` input, ``out=dyn://``,
  the processor's ``--registry`` and the daemon's ``--data-dir``.

Worker metrics reach the routers at fixed points (after each request the
test feeds the routers each worker's ``ForwardPassMetrics``), so the
decisions do not depend on when a periodic scrape lands.
"""

import asyncio
import json
import os
import signal
import sys
import urllib.request

import pytest

from dynamo_tpu.launch.run import _wire_kv_events as j_wire_kv_events
from dynamo_tpu.llm.engines.jax_engine import JaxEngine
from dynamo_tpu.llm.engines.kv_routed import KvRoutedEngine as JKvRouted
from dynamo_tpu.llm.kv_router.publisher import \
    KvEventPublisher as JKvEventPublisher
from dynamo_tpu.llm.protocols import annotated as jannotated
from dynamo_tpu.llm.protocols import common as jcommon
from dynamo_tpu.runtime.distributed import DistributedRuntime as JRuntime
from dynamo_tpu.runtime.distributed import Endpoint as JEndpoint
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.components import processor
from dynamo_tpu_torch.launch import run as launcher
from dynamo_tpu_torch.llm.engines.kv_routed import KvRoutedEngine
from dynamo_tpu_torch.llm.engines.torch_engine import TorchEngine
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher
from dynamo_tpu_torch.llm.protocols import annotated, common
from dynamo_tpu_torch.runtime import server as tserver
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime, Endpoint
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_kv_offload import engine_core, family_params, serve

pytestmark = pytest.mark.anyio

WAIT = 60.0
PATH = "dyn://routed/worker/generate"
BS = 8
GRAPH_ENGINE = dict(max_model_len=256, kv_block_size=BS, num_kv_blocks=64,
                    max_num_seqs=4, prefill_buckets=[32, 64, 128, 256],
                    host_kv_blocks=16)


def _tokens(seed, n):
    import numpy as np
    return np.random.default_rng(seed).integers(1, 256, size=n).tolist()


# two prefix groups of 4 full blocks each, and suffixes of 3-20 tokens
PREFIXES = [_tokens(100 + g, 4 * BS) for g in range(2)]


def _request(pkg, tokens, max_new=6):
    return pkg.PreprocessedRequest(
        token_ids=list(tokens),
        stop_conditions=pkg.StopConditions(max_tokens=max_new),
        sampling_options=pkg.SamplingOptions(temperature=0.0))


class Graph:
    """One package's routed graph: two workers and a KV-routed engine on
    one in-process runtime."""

    def __init__(self, jax_side: bool):
        self.jax_side = jax_side
        self.pkg = jcommon if jax_side else common
        self.decisions = []
        self.cores, self.servers, self.runtimes = [], [], []
        self.router = None

    async def start(self):
        rt_cls = JRuntime if self.jax_side else DistributedRuntime
        ep_cls = JEndpoint if self.jax_side else Endpoint
        base = rt_cls.in_process()
        self.runtimes.append(base)
        # a loop blocked by a first compile under a loaded machine must
        # not outlast the workers' leases: no expiry is under test here
        base.LEASE_TTL = 3600.0
        enc = (jannotated if self.jax_side else annotated).encode_annotated_json
        for _ in range(2):
            core = engine_core(family_params(), "int8", self.jax_side,
                               **GRAPH_ENGINE)
            rt = rt_cls(base.store, base.bus)
            rt.LEASE_TTL = base.LEASE_TTL
            self.runtimes.append(rt)
            ep = ep_cls.parse_path(rt, PATH)
            if self.jax_side:
                await j_wire_kv_events(core, rt, ep)
                engine = JaxEngine(core)
            else:
                await launcher.wire_kv_events(core, rt, ep)
                engine = TorchEngine(core)
            pkg = self.pkg
            self.servers.append(await ep.serve(
                engine, decode_req=lambda raw, pkg=pkg:
                pkg.PreprocessedRequest.from_dict(json.loads(raw)),
                encode_resp=enc,
                stats_handler=lambda core=core: core.metrics().to_dict()))
            self.cores.append(core)
        kv_cls = JKvRouted if self.jax_side else KvRoutedEngine
        self.router = await kv_cls.start(ep_cls.parse_path(base, PATH),
                                         block_size=BS)
        # metrics reach the router at fixed points only (``settle``)
        self.router._tasks[1].cancel()
        # a worker's dial-back may wait behind a first compile on a loaded
        # machine: no re-dispatch (at least once) may double a request
        self.router.client.DIAL_BACK_TIMEOUT = 600.0
        ids = [s.lease_id for s in self.servers]
        self.router.router.scheduler.on_hit_rate = (
            lambda e: self.decisions.append(
                (ids.index(e.worker_id), e.isl_blocks, e.overlap_blocks)))
        await self.router.client.wait_for_instances(timeout=WAIT)
        while len(self.router.client.instances) < 2:
            await asyncio.sleep(0.01)
        await self.settle()

    async def settle(self):
        """Let each worker go idle (its requests released, the host tier's
        write-back copies done, so no block stays held), let every KV
        event reach the router's index, then feed it each live worker's
        metrics."""
        for core in self.cores:
            while any(slot is not None for slot in core.slots):
                await asyncio.sleep(0.001)
            await asyncio.wait_for(core.offload_engine.drain(), WAIT)
            await asyncio.wait_for(core.kv_event_publisher.drain(), WAIT)
        sub = self.router._sub
        while not sub._queue.empty():
            await asyncio.sleep(0)
        await asyncio.sleep(0)
        live = set(self.router.client.instances)
        self.router.router.on_metrics({
            s.lease_id: c.metrics().to_dict()
            for s, c in zip(self.servers, self.cores) if s.lease_id in live})

    async def ask(self, tokens):
        ctx_cls = JContext if self.jax_side else Context
        stream = await self.router.generate(ctx_cls(_request(self.pkg,
                                                             tokens)))
        out = []
        async for item in stream:
            assert not item.is_error, item.error_message()
            out.extend(item.data.token_ids)
        return out

    async def traffic(self):
        streams = []
        # seeds: one per group, sent together
        seeds = [p + _tokens(200 + g, 3 + 7 * g)
                 for g, p in enumerate(PREFIXES)]
        streams += await asyncio.gather(*(self.ask(t) for t in seeds))
        await self.settle()
        # follow-ups: two a group, one at a time
        for g, p in enumerate(PREFIXES):
            for k in range(2):
                streams.append(await self.ask(p + _tokens(300 + 10 * g + k,
                                                          5 + 6 * k)))
                await self.settle()
        hits = [c.kv_manager.pool.match_hits for c in self.cores]
        # worker 0 stops: its key goes, the router prunes it
        gone = self.servers[0].lease_id
        index = self.router.router.indexer
        held = None if self.jax_side else index.worker_blocks(gone)
        await self.servers[0].stop()
        while len(self.router.client.instances) > 1:
            await asyncio.sleep(0.01)
        await self.settle()
        self.pruned = (held, None if self.jax_side else
                       index.worker_blocks(gone))
        for g, p in enumerate(PREFIXES):
            streams.append(await self.ask(p + _tokens(400 + g, 9)))
            await self.settle()
        return streams, hits

    async def stop(self):
        if self.router is not None:
            await self.router.close()
        for s in self.servers[1:]:
            await s.stop()
        for core in self.cores:
            await core.stop()
        for rt in reversed(self.runtimes):
            await rt.shutdown()


async def test_routed_graph_matches_jax():
    out = {}
    for jax_side in (True, False):
        g = Graph(jax_side)
        try:
            await g.start()
            streams, hits = await g.traffic()
            out[jax_side] = (streams, hits, g.decisions)
            assert g.router.kv_routed == len(streams)
            if not jax_side:
                held, left = g.pruned
                assert held >= 4 and left == 0
        finally:
            await g.stop()
    (jst, jhits, jdec), (tst, thits, tdec) = out[True], out[False]
    assert tdec == jdec and tst == jst and thits == jhits
    assert all(len(s) == 6 for s in tst)
    seeds, follow, after = tdec[:2], tdec[2:6], tdec[6:]
    # both workers serve a group, each follow-up lands on its group's
    # seed worker with the whole prefix (4 blocks) matched
    assert {w for w, _, _ in seeds} == {0, 1}
    for i, (w, _, overlap) in enumerate(follow):
        assert w == seeds[i // 2][0] and overlap == 4
    assert sum(thits) >= 4 * 4
    # after worker 0 stopped: all on worker 1 (the index lost worker 0)
    assert [w for w, _, _ in after] == [1, 1]


# ------------------------------------------------ the tier-aware event stream

async def _announce_run(jax_side, tmp_path):
    """A scripted run whose device evictions go to the host tier and whose
    host evictions spill to disk; every announce the engine publishes."""
    events = []

    async def sink(ev):
        events.append(ev.to_dict())

    core = engine_core(family_params(), "int8", jax_side,
                       max_model_len=128, kv_block_size=4, num_kv_blocks=14,
                       max_num_seqs=2, prefill_buckets=[32, 64, 128],
                       host_kv_blocks=6, kv_disk_dir=str(tmp_path / (
                           "jax" if jax_side else "port")),
                       kv_disk_blocks=10)
    pub_cls = JKvEventPublisher if jax_side else KvEventPublisher
    core.kv_event_publisher = pub_cls(worker_id=1, sink=sink)
    out = []
    try:
        for i in range(8):
            prompt = _tokens(500 + i % 5, 17 + 2 * i)
            out.append(await serve(core, prompt, f"r{i}", max_new=4))
            await core.offload_engine.drain()
            await core.spill_engine.drain()
            await core.kv_event_publisher.drain()
    finally:
        await core.stop()
    return events, out


async def test_tier_aware_announce_stream_matches_jax(tmp_path):
    jev, jout = await _announce_run(True, tmp_path)
    tev, tout = await _announce_run(False, tmp_path)
    assert tout == jout
    assert tev == jev
    tiers = {e["stored"]["tier"] for e in tev if e.get("stored")}
    assert {"device", "host", "disk"} <= tiers
    assert any(e.get("removed") for e in tev)


# ------------------------------------------- the port's processes over HTTP

def _write_model_dir(d):
    import shutil
    os.makedirs(d, exist_ok=True)
    shutil.copy(os.path.join(os.path.dirname(__file__), "data", "sp",
                             "tiny.model"), os.path.join(d, "tokenizer.model"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"vocab_size": 307, "hidden_size": 64,
                   "intermediate_size": 128, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "num_key_value_heads": 2,
                   "head_dim": 16, "max_position_embeddings": 512,
                   "eos_token_id": 2}, f)


async def _spawn(*args, env=None):
    return await asyncio.create_subprocess_exec(
        sys.executable, "-m", *args, stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.STDOUT, env=env)


async def _ready_line(proc, what):
    while True:
        line = await asyncio.wait_for(proc.stdout.readline(), WAIT)
        if not line:
            raise AssertionError(f"{what} exited before it was ready")
        if line.startswith(b"READY") or b"listening on" in line:
            return line.decode().strip()


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return json.loads(r.read())


async def test_port_processes_route_and_survive_a_lost_worker(tmp_path):
    """The daemon, two workers and the processor as the user starts them.
    A seed goes through the processor over HTTP; a router of this test,
    fed the workers' published stats once they are idle, sends the
    follow-up to the seed's worker, whose prefix hits grow by the prefix's
    4 blocks; the seed's worker is killed, its key expires, the router
    prunes its blocks, and the processor serves the next request from the
    survivor."""
    mdir = str(tmp_path / "m")
    _write_model_dir(mdir)
    # a short lease, so that the killed worker leaves discovery soon, and
    # long enough that a loaded machine does not expire a live one
    env = dict(os.environ, DYN_LEASE_TTL="3.0")
    procs = []
    try:
        daemon = await _spawn("dynamo_tpu_torch.runtime.server", "--host",
                              "127.0.0.1", "--port", "0")
        procs.append(daemon)
        addr = (await _ready_line(daemon, "daemon")).rsplit(" ", 1)[-1]
        workers = []
        for _ in range(2):
            w = await _spawn(
                "dynamo_tpu_torch.launch.run", f"in={PATH}", "out=torch",
                "--protocol", "tokens", "--model-path", mdir,
                "--random-weights", "--device", "cpu", "--runtime-server",
                addr, "--kv-block-size", "16", "--num-kv-blocks", "64",
                env=env)
            procs.append(w)
            workers.append(w)
        proc = await _spawn("dynamo_tpu_torch.components.processor",
                            "--runtime-server", addr, "--model-path", mdir,
                            "--model-name", "tiny", "--endpoint", PATH,
                            "--host", "127.0.0.1", "--port", "0",
                            "--kv-block-size", "16")
        procs.append(proc)
        wids = [int((await _ready_line(w, "worker")).rsplit(" ", 1)[-1], 16)
                for w in workers]
        port = int((await _ready_line(proc, "processor"))
                   .rsplit(":", 1)[-1].split("/")[0])
        rt = await DistributedRuntime.connect(addr)
        router = None
        try:
            router = await KvRoutedEngine.start(Endpoint.parse_path(rt, PATH),
                                                block_size=16)
            router._tasks[1].cancel()          # stats are fed below
            while len(router.client.instances) < 2:
                await asyncio.sleep(0.01)
            prefix = list(range(10, 74))               # 4 blocks of 16
            seed = await asyncio.to_thread(_post, port, {
                "model": "tiny", "prompt": prefix + [5, 5, 5],
                "max_tokens": 4, "temperature": 0})
            assert seed["usage"]["completion_tokens"] == 4
            index = router.router.indexer

            def holder():
                s = index.find_matches_for_request(prefix).scores
                return next((w for w, n in s.items() if n == 4), None)
            while holder() is None:                    # the seed's events
                await asyncio.sleep(0.01)
            owner = holder()

            async def idle_stats():
                st = await router.client.collect_stats()
                if (len(st) == 2 and all(
                        v["request_active_slots"] == 0 and
                        v["kv_active_blocks"] == 0 for v in st.values())
                        and st[owner]["prefill_tokens_total"] > 0):
                    return st
            st = None
            while st is None:
                st = await asyncio.wait_for(idle_stats(), WAIT)
            router.router.on_metrics(st)
            hits0 = st[owner]["prefix_hit_blocks_total"]
            decisions = []
            router.router.scheduler.on_hit_rate = decisions.append
            stream = await router.generate(Context(_request(
                common, prefix + [6, 6, 6, 6], max_new=4)))
            assert len([i async for i in stream]) == 5
            assert [(d.worker_id, d.overlap_blocks) for d in decisions] == \
                [(owner, 4)]
            while (await router.client.collect_stats())[owner][
                    "prefix_hit_blocks_total"] != hits0 + 4:
                await asyncio.sleep(0.01)
            # kill the owner: its key expires and the router prunes it
            victim = workers[wids.index(owner)]
            victim.send_signal(signal.SIGKILL)
            await asyncio.wait_for(victim.wait(), WAIT)
            while owner in router.client.instances:
                await asyncio.sleep(0.01)
            assert index.worker_blocks(owner) == 0
            out = await asyncio.to_thread(_post, port, {
                "model": "tiny", "prompt": prefix + [9], "max_tokens": 4,
                "temperature": 0})
            assert out["choices"][0]["finish_reason"] == "length"
        finally:
            if router is not None:
                await router.close()
            await rt.shutdown()
    finally:
        # the clients first (they deregister through the daemon), then it
        await _stop(procs[1:])
        await _stop(procs[:1])


async def _stop(procs):
    for p in procs:
        if p.returncode is None:
            p.send_signal(signal.SIGINT)
    for p in procs:
        try:
            await asyncio.wait_for(p.wait(), 20)
        except asyncio.TimeoutError:
            p.kill()
            await p.wait()


async def test_stream_failing_midway_ends_in_an_error_event():
    """A stream whose source fails after two chunks (a worker lost
    mid-stream, to a processor): the client gets both chunks, then an SSE
    error event with the message, and no [DONE]."""
    from dynamo_tpu_torch.llm.http import HttpService
    from dynamo_tpu_torch.llm.protocols.sse import SseParser
    from dynamo_tpu_torch.runtime.engine import ResponseStream

    class Failing:
        async def generate(self, request):
            async def gen():
                for i in range(2):
                    yield annotated.Annotated.from_data({
                        "id": "c", "object": "text_completion", "created": 0,
                        "model": "m", "choices": [{"index": 0, "text": str(i),
                                                   "finish_reason": None}]})
                raise RuntimeError("remote stream error: connection lost")
            return ResponseStream(gen(), request.ctx)

    svc = HttpService(port=0, host="127.0.0.1")
    svc.manager.add_completion_model("m", Failing())
    await svc.start()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", svc.port)
        body = json.dumps({"model": "m", "prompt": "x", "stream": True})
        writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                      f"Content-Type: application/json\r\nContent-Length: "
                      f"{len(body)}\r\n\r\n{body}").encode())
        await writer.drain()
        raw = (await asyncio.wait_for(reader.read(), WAIT)).decode()
        writer.close()
    finally:
        await svc.stop()
    events = list(SseParser().push(raw.split("\r\n\r\n", 1)[1]))
    assert [e.event for e in events] == [None, None, "error"]
    assert "connection lost" in "".join(events[-1].comments)
    assert not any(e.is_done for e in events)


# ----------------------------------------------------------------- refusals

@pytest.mark.parametrize("argv,match", [
    (["in=dyn://ns/comp/ep", "out=echo_core", "--protocol", "openai"],
     "ROADMAP A7, A10"),
    (["in=http", "out=dyn://ns/comp/ep"], "ROADMAP A7, A10"),
])
async def test_unported_routed_modes_raise(argv, match):
    with pytest.raises(SystemExit, match=match):
        await launcher.amain(argv)


async def test_processor_registry_raises():
    with pytest.raises(SystemExit, match="ROADMAP A10"):
        await processor.amain(["--runtime-server", "127.0.0.1:1",
                               "--registry"])


def test_daemon_data_dir_raises():
    with pytest.raises(SystemExit, match="ROADMAP A7"):
        tserver.main(["--data-dir", "/nonexistent"])

