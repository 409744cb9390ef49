"""The port's schedule recorder, replay and flight recorder, on the CPU.

- A recorded contended run replays bit for bit (``compare_replay`` empty):
  the split path at K = 8 pipelined with lane prefill and 24-token chunks,
  ``--ragged`` pipelined, and speculation on the split path (K = 4) and
  under ``--ragged`` pipelined, each with two prompts in a pool small
  enough to preempt. The log holds the event kinds of its path.
- The port's ``check_log`` / ``check_inputs`` and the JAX package's accept
  the same port log, and both flag a planted stale read: one request's
  table entry pointed at another request's block.
- The replay's pool: a fingerprint of every step, and the same pool bytes
  as the live engine's at the end of a run with no preemption.
- ``GET /debug``: the service lists each engine's flight recorder in the
  JAX layout, and the records' kinds and fields are the JAX engine's on
  the same workload (but the fields of KV tiers and the wave prefetch,
  which the port does not have).
"""

import asyncio
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import replay as jreplay
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.core import EngineCore as JEngineCore
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu_torch.engine import replay as treplay
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.core import (FINISH_SENTINEL, EngineCore,
                                          EngineRequest)
from dynamo_tpu_torch.engine.sampling import SlotSampling
from dynamo_tpu_torch.engine.weights import params_from_numpy
from tests.test_torch_dispatch import TokenTap, submit_now
from tests.test_torch_spec import GEOM, repetitive, run_reqs

BASE = dict(max_model_len=256, kv_block_size=8, max_num_seqs=2,
            prefill_buckets=[32, 64, 128])
# (dispatch fields, pool blocks, event kinds the log must hold)
RUNS = {
    "split_k8_lanes": (dict(decode_steps_per_dispatch=8,
                            decode_dispatch_pipeline=True,
                            lane_prefill_max_tokens=32, prefill_chunk=24),
                       24, {"prefill", "admit", "dispatch", "harvest"}),
    "ragged_pipelined": (dict(ragged_dispatch=True,
                              decode_dispatch_pipeline=True,
                              ragged_max_seq_rows=16),
                         16, {"ragged", "ragged_harvest", "admit"}),
    "spec_split": (dict(decode_steps_per_dispatch=4, spec_k=3), 12,
                   {"verify", "spec_harvest", "dispatch", "preempt"}),
    "spec_ragged_pipelined": (dict(ragged_dispatch=True,
                                   decode_dispatch_pipeline=True, spec_k=3,
                                   ragged_max_seq_rows=16),
                              12, {"ragged", "ragged_harvest", "preempt"}),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny models gain nothing from intra-op threads, and the suite
    runs several workers over the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    p = jllama.init_params(JModelConfig(**GEOM), jax.random.PRNGKey(0),
                           dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def port_core(np_params, blocks, **kw):
    cfg = ModelConfig(**GEOM)
    return EngineCore(cfg, EngineConfig(dtype="float32", num_kv_blocks=blocks,
                                        **BASE, **kw),
                      params=params_from_numpy(np_params, cfg, "cpu",
                                               torch.float32),
                      device="cpu")


async def recorded_run(np_params, name, max_new=32):
    """Two repetitive prompts, the second posted as the engine emits the
    first's first token (the engine is decoding it, so the second
    lane-admits where lanes are on; the point is pinned in emitted tokens,
    not left to the host's timing)."""
    fields, blocks, _ = RUNS[name]
    core = port_core(np_params, blocks, **fields)
    core.recorder = treplay.Recorder()
    rng = np.random.default_rng(5)
    prompts = [repetitive(rng), repetitive(rng, period=5, reps=6)]
    reqs = [EngineRequest(rid=f"r{i}", prompt=p, sampling=SlotSampling(),
                          max_new_tokens=max_new, eos_ids=frozenset())
            for i, p in enumerate(prompts)]

    async def drain(req):
        toks = []
        while True:
            item, _ = await asyncio.wait_for(req.out_queue.get(), 120)
            if item is FINISH_SENTINEL:
                return toks
            toks.append(item)
    reqs[0].out_queue = TokenTap(1, lambda: submit_now(core, reqs[1]))
    try:
        await core.submit(reqs[0])
        a, b = await asyncio.gather(drain(reqs[0]), drain(reqs[1]))
    finally:
        await core.stop()
    assert len(a) == len(b) == max_new
    return core, core.recorder.events


@pytest.fixture(scope="module")
def runs(np_params):
    return {name: asyncio.run(recorded_run(np_params, name))
            for name in RUNS}


@pytest.mark.parametrize("name", list(RUNS))
def test_recorded_run_replays_bit_exact(runs, name):
    core, events = runs[name]
    kinds = {e["ev"] for e in events}
    assert RUNS[name][2] <= kinds, kinds
    if name == "ragged_pipelined":
        # (with drafts due a pipelined dispatch drains instead of chaining)
        assert any(e["ev"] == "ragged" and e["chained_from"] is not None
                   for e in events)
    if "spec_ragged" in name:
        assert any(e["ev"] == "ragged"
                   and any(m == "spec" for *_, m in e["seqs"])
                   for e in events)
    if name == "split_k8_lanes":
        assert any(e["ev"] == "admit" and e.get("lane") for e in events)
        assert any(e["ev"] == "dispatch" and e["chained_from"] is not None
                   for e in events)
    rep = treplay.replay(core, events)
    assert treplay.compare_replay(events, rep) == []
    n_harvests = sum(1 for e in events if e["ev"].endswith("harvest"))
    assert (len(rep["dispatch"]) + len(rep["ragged"])
            + len(rep["verify"])) == n_harvests > 0


@pytest.mark.parametrize("name", list(RUNS))
@pytest.mark.parametrize("checker", ["port", "jax"])
def test_checkers_accept_the_port_log(runs, name, checker):
    mod = treplay if checker == "port" else jreplay
    _, events = runs[name]
    assert mod.check_log(events, block_size=8) == []
    assert mod.check_inputs(events) == []


def _plant_stale_read(events, block_size=8):
    """A copy of ``events`` in which the first dispatch of the second
    request past its first block reads that block through a table entry
    pointed at the first request's first block: the signature of a stale
    read."""
    events = copy.deepcopy(events)
    owner = {}
    for e in events:
        if e["ev"] == "admit":
            owner.setdefault(e["rid"], e["blocks"][0])
    a, b = list(owner)[:2]
    for e in events:
        if e["ev"] not in ("dispatch", "verify", "ragged") \
                or b not in e["reqs"]:
            continue
        i = e["reqs"].index(b)
        row = e["starts"][i] if e["ev"] == "ragged" else i
        if e["ev"] == "ragged" and e["counts"][i] == 0:
            continue
        if int(e["positions"][row]) >= block_size:
            e["tables"] = np.array(e["tables"])
            e["tables"][i, 0] = owner[a]
            return events, b, a
    raise AssertionError("no dispatch of the second request")


@pytest.mark.parametrize("name", list(RUNS))
@pytest.mark.parametrize("checker", ["port", "jax"])
def test_checkers_flag_a_planted_stale_read(runs, name, checker):
    mod = treplay if checker == "port" else jreplay
    events, reader, writer = _plant_stale_read(runs[name][1])
    stale = mod.check_log(events, block_size=8)
    assert stale, "the planted cross-request read was not flagged"
    assert any(s.rid == reader and s.writer == writer for s in stale)


async def test_replay_pool_equals_the_live_pool(np_params):
    """Without preemption every slot the live engine wrote is rewritten by
    the replay in the same order: the two pools hold the same bytes, and
    the fingerprints change as dispatches write."""
    fields = dict(decode_steps_per_dispatch=4, spec_k=2)
    core = port_core(np_params, 64, **fields)
    core.recorder = treplay.Recorder()
    rng = np.random.default_rng(9)
    await run_reqs(core, [repetitive(rng), repetitive(rng)], max_new=20)
    assert core.preemptions == 0
    rep = treplay.replay(core, core.recorder.events, fingerprint=True)
    prints = [d for _, d in rep["fingerprints"]]
    assert len(prints) > 3 and len(set(prints)) == len(prints)
    # the replay's pool is gone with the replay; run it again keeping it
    kv = core.model_mod.init_kv_cache(core.model_cfg, core.cfg.num_kv_blocks,
                                      8, "cpu", core.dtype)
    progs = treplay.ReplayPrograms(core, kv)
    for ev in core.recorder.events:
        if ev["ev"] == "prefill":
            treplay.exec_prefill_event(progs, ev)
        elif ev["ev"] == "dispatch":
            treplay.exec_dispatch_event(progs, ev, None).fetch()
        elif ev["ev"] == "verify":
            treplay.exec_verify_event(progs, ev).fetch()
    for key in core.kv:
        assert torch.equal(kv[key], core.kv[key]), key


def test_replay_refuses_another_config(runs, np_params):
    core, events = runs["spec_split"]
    other = port_core(np_params, 16, decode_steps_per_dispatch=4, spec_k=2)
    with pytest.raises(NotImplementedError, match="spec_k"):
        treplay.replay(other, events)
    core, events = runs["spec_ragged_pipelined"]
    other = port_core(np_params, 16, ragged_dispatch=True,
                      ragged_max_seq_rows=16)
    with pytest.raises(NotImplementedError, match="sampled"):
        treplay.replay(other, events)


# ------------------------------------------------------------------ /debug

# the JAX record fields the port does not have: the remote KV tier and
# disaggregation (ROADMAP A7) and K4's wave prefetch (B1)
NOT_PORTED = {"hit_remote", "precomputed", "prefetch_first_waves",
              "prefetch_hits"}


async def _http_get(port: int, target: str) -> dict:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200"), head[:80]
    return json.loads(body)


@pytest.mark.parametrize("fields", [
    dict(decode_steps_per_dispatch=4, spec_k=3),
    dict(ragged_dispatch=True, spec_k=3, ragged_max_seq_rows=16)])
async def test_debug_serves_the_flight_records(np_params, fields):
    from dynamo_tpu_torch.llm.http.service import HttpService

    rng = np.random.default_rng(17)
    prompts = [repetitive(rng), repetitive(rng)]
    core = port_core(np_params, 64, **fields)
    jcore = JEngineCore(JModelConfig(**GEOM),
                        JEngineConfig(num_kv_blocks=64, **BASE, **fields),
                        params={k: jnp.asarray(v)
                                for k, v in np_params.items()},
                        attn_impl="xla", param_dtype=jnp.float32)
    await run_reqs(core, prompts)
    await run_reqs(jcore, prompts)
    svc = HttpService(port=0, host="127.0.0.1")
    await svc.start()
    try:
        got = await _http_get(svc.port, "/debug?last=500")
        few = await _http_get(svc.port, "/debug?last=3")
    finally:
        await svc.stop()
    mine = [fr for fr in got["flight_recorders"].values()
            if fr["stats"]["records_total"] == core.flight.records_total
            and fr["records"] == json.loads(json.dumps(core.flight.dump()))]
    assert len(mine) == 1
    assert all(len(fr["records"]) <= 3
               for fr in few["flight_recorders"].values())
    stats = mine[0]["stats"]
    assert set(stats) == set(jcore.flight.stats())
    kinds = {r["kind"] for r in mine[0]["records"]}
    want = {"prefill", "verify", "decode"} if "spec_k" in fields and \
        "ragged_dispatch" not in fields else {"ragged"}
    assert want <= kinds
    jfields = {}
    for r in jcore.flight.dump():
        jfields.setdefault(r["kind"], set(r))
    for r in core.flight.dump():
        assert set(r) == jfields[r["kind"]] - NOT_PORTED, r["kind"]
    if "ragged_dispatch" in fields:
        assert any(r["kind"] == "ragged" and r["n_spec"] > 0
                   for r in core.flight.dump())
    # the same dispatch kinds, counts and emissions as JAX's records
    strip = ("t", "device_ms", "host_gap_ms", "host_ms", "queue_wait_ms")
    assert ([{k: v for k, v in r.items() if k not in strip}
             for r in core.flight.dump()]
            == [{k: v for k, v in r.items()
                 if k not in strip and k not in NOT_PORTED}
                for r in jcore.flight.dump()])
