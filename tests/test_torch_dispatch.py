"""The port's dispatch modes against the JAX package's, on the CPU.

Both engines run the same tiny model (the JAX init, converted with
``params_from_numpy``) in f32 and serve the same requests with the same
``EngineConfig`` dispatch fields; each request's token stream must be
equal across the two engines. The cases are the JAX suite's own
(``tests/test_multistep_decode.py``, ``tests/test_chunked_prefill.py``,
``tests/test_lane_prefill.py``):

- K = 4 and 5 decode steps per dispatch, with and without the pipelined
  harvest; an EOS in the middle of a dispatch (the overrun is discarded);
  two concurrent sequences with a staggered admission;
- chunked prefill at 50, 64 and 17 prompt tokens with chunk 16, and
  chunked prefill continuing a prefix hit;
- lane admission into a busy decode batch, greedy and seeded (temperature
  0.7, top_p 0.9), after a prefix hit, and under recompute preemption
  with and without the pipeline; the second request is submitted inside
  the engine's own put of the first's n-th token (``TokenTap``), so both
  engines admit it at the same point of the first's stream, whatever the
  host's load;
- two prompts posted back to back, with the first token's fetch deferred
  (``overlap_admission_fetch``, the default: the second admission finds no
  ready slot and prefills) and fetched at once (it lane-admits): lane
  admissions and host round trips equal JAX's too. Under preemption the streams are held
  equal up to the first recompute point of either engine (a re-admission
  prefill's sums differ from the decode program's, so a greedy argmax at a
  near-tie may flip there; the JAX package's own contract).

The port's plain K-step program (``programs.decode_k_forward``) is also
held against JAX's compiled ``decode_k`` program at K = 3 with one lane's
planned tokens: equal tokens, logprobs within 1e-4 and pool rows within
1e-5 (``tests/test_torch_llama.py``'s tolerances: XLA's and PyTorch's CPU
matmuls sum in another order); and ``sampling.make_slot_keys`` against
``make_slot_key`` and JAX's keys, bit for bit, at negative, zero and large
steps. Every JAX engine compiles its own K-step program on the CPU, so the
file keeps their number small.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.core import FINISH_SENTINEL as J_FINISH
from dynamo_tpu.engine.core import EngineCore as JEngineCore
from dynamo_tpu.engine.core import EngineRequest as JEngineRequest
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.sampling import SlotSampling as JSlotSampling
from dynamo_tpu.engine.sampling import make_slot_keys as j_make_slot_keys
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.core import FINISH_SENTINEL, EngineCore, EngineRequest
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.programs import (DecodeProgram, decode_k_forward,
                                              sampling_variant)
from dynamo_tpu_torch.engine.sampling import (SlotSampling, make_slot_key,
                                              make_slot_keys)
from dynamo_tpu_torch.engine.weights import params_from_numpy

GEOM = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position_embeddings=512)
LOGPROB_ATOL, KV_ATOL = 1e-4, 1e-5
GREEDY = dict(temperature=0.0)
SEEDED = dict(temperature=0.7, top_p=0.9, seed=99)


@pytest.fixture(scope="module")
def np_params():
    p = jllama.init_params(JModelConfig(**GEOM), jax.random.PRNGKey(0),
                           dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def make_cores(np_params, **cfg):
    kw = dict(max_model_len=256, kv_block_size=8, num_kv_blocks=64,
              max_num_seqs=4, prefill_buckets=[16, 32, 64, 128])
    kw.update(cfg)
    jcore = JEngineCore(JModelConfig(**GEOM), JEngineConfig(**kw),
                        params={k: jnp.asarray(v)
                                for k, v in np_params.items()},
                        attn_impl="xla", param_dtype=jnp.float32)
    mcfg = ModelConfig(**GEOM)
    tcore = EngineCore(mcfg, EngineConfig(dtype="float32", **kw),
                       params=params_from_numpy(np_params, mcfg, "cpu",
                                                torch.float32),
                       device="cpu")
    return jcore, tcore


def _requests(jax_side: bool, prompt, rid, max_new, sampling=None,
              eos=()):
    sampling = sampling or GREEDY
    if jax_side:
        return JEngineRequest(rid=rid, prompt=list(prompt),
                              sampling=JSlotSampling(**sampling),
                              max_new_tokens=max_new, eos_ids=frozenset(eos))
    return EngineRequest(rid=rid, prompt=list(prompt),
                         sampling=SlotSampling(**sampling),
                         max_new_tokens=max_new, eos_ids=frozenset(eos))


class TokenTap(asyncio.Queue):
    """A request's ``out_queue`` that calls ``hook()`` inside the engine's
    own put of the request's ``at``-th token. A scenario's next step then
    lands at a fixed point of the stream, counted in emitted tokens, and
    not wherever the host's timing lets a test coroutine run (both cores
    emit through ``out_queue.put_nowait``)."""

    def __init__(self, at: int, hook):
        super().__init__()
        self.at, self.hook, self.tokens = at, hook, 0

    def put_nowait(self, item):
        super().put_nowait(item)
        if item[0] is J_FINISH or item[0] is FINISH_SENTINEL:
            return
        self.tokens += 1
        if self.tokens == self.at:
            self.hook()


def submit_now(core, req) -> None:
    """Run ``core.submit(req)`` to its end without yielding to the loop:
    for a request without a precomputed payload neither core's submit
    suspends (it puts on an unbounded queue), so the engine sees the
    request at its very next admission pass."""
    coro = core.submit(req)
    try:
        coro.send(None)
    except StopIteration:
        return
    coro.close()
    raise AssertionError("submit suspended")


class Side:
    """One engine and the calls the JAX suite's scenarios make on it."""

    def __init__(self, core, jax_side: bool):
        self.core = core
        self.jax_side = jax_side
        self.sentinel = J_FINISH if jax_side else FINISH_SENTINEL

    async def submit(self, prompt, rid, max_new=24, sampling=None, eos=()):
        req = _requests(self.jax_side, prompt, rid, max_new, sampling, eos)
        await self.core.submit(req)
        return req

    async def drain(self, req, head=()):
        toks = list(head)
        while True:
            item, payload = await asyncio.wait_for(req.out_queue.get(), 120)
            if item is self.sentinel:
                return toks, payload, req
            toks.append(item)

    async def run(self, prompt, rid, max_new=24, sampling=None, eos=()):
        return await self.drain(await self.submit(prompt, rid, max_new,
                                                  sampling, eos))

    async def busy_pair(self, pa, pb, max_new_a=32, samp_b=None,
                        max_new_b=24, lead=1):
        """Submit A, and submit B as the engine emits A's ``lead``-th
        token (the engine is decoding A then; with lanes on, B
        lane-admits). Both engines see B at the same point of A's
        stream."""
        rb = _requests(self.jax_side, pb, "b", max_new_b, samp_b)
        ra = _requests(self.jax_side, pa, "a", max_new_a)
        ra.out_queue = TokenTap(lead, lambda: submit_now(self.core, rb))
        await self.core.submit(ra)
        return await asyncio.gather(self.drain(ra), self.drain(rb))


async def on_both(np_params, scenario, **cfg):
    """Run ``scenario(side)`` on a JAX and a port engine built with the
    same dispatch fields; returns (jax result, port result, jcore,
    tcore)."""
    jcore, tcore = make_cores(np_params, **cfg)
    out = []
    for core, jax_side in ((jcore, True), (tcore, False)):
        try:
            out.append(await scenario(Side(core, jax_side)))
        finally:
            await core.stop()
    return out[0], out[1], jcore, tcore


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(
        1, GEOM["vocab_size"], size=n).tolist()


# --------------------------------------------------------------- multi-step


@pytest.mark.parametrize("k,pipeline", [(4, False), (5, False), (4, True)])
async def test_multistep_streams_match_jax(np_params, k, pipeline):
    prompt = _prompt(3, 21)

    async def scenario(side):
        return await side.run(prompt, "r", max_new=13)

    (jt, jr, _), (tt, tr, _), _, tcore = await on_both(
        np_params, scenario, decode_steps_per_dispatch=k,
        decode_dispatch_pipeline=pipeline)
    assert tt == jt and len(tt) == 13      # max_tokens lands mid-dispatch
    assert tr.value == jr.value == "length"
    # one host fetch per dispatch: the first token comes from the prefill,
    # the other 12 from ceil(12 / k) dispatches, and the pipeline drains
    # one more dispatch, launched before the finish was harvested
    assert tcore.host_roundtrips == 1 + -(-12 // k) + pipeline


async def test_multistep_eos_mid_dispatch_discards_overrun(np_params):
    prompt = _prompt(5, 9)

    async def reference(side):
        return await side.run(prompt, "r", max_new=40)

    (ref, _, _), (tref, _, _), _, _ = await on_both(
        np_params, reference, decode_steps_per_dispatch=4)
    assert tref == ref
    eos_tok = ref[2]             # the 3rd generated token lands mid-dispatch
    cut = ref[:ref.index(eos_tok) + 1]

    async def scenario(side):
        return await side.run(prompt, "r", max_new=40, eos=(eos_tok,))

    (jt, jr, _), (tt, tr, _), _, _ = await on_both(
        np_params, scenario, decode_steps_per_dispatch=4)
    assert tt == jt == cut               # nothing after EOS leaks out
    assert tr.value == jr.value == "eos"


async def test_pipelined_staggered_admission_streams_match_jax(np_params):
    p1, p2 = _prompt(41, 12), _prompt(42, 18)

    async def scenario(side):          # b arrives as a's 5th token is out
        return await side.busy_pair(p1, p2, max_new_a=17, max_new_b=9,
                                    lead=5)

    (ja, jb), (ta, tb), _, _ = await on_both(
        np_params, scenario, decode_steps_per_dispatch=4,
        decode_dispatch_pipeline=True)
    assert ta[0] == ja[0] and len(ta[0]) == 17
    assert tb[0] == jb[0] and len(tb[0]) == 9


# ----------------------------------------------------------- chunked prefill


@pytest.mark.parametrize("n_prompt", [50, 64, 17])
async def test_chunked_prefill_streams_match_jax(np_params, n_prompt):
    prompt = _prompt(11, n_prompt)

    async def scenario(side):
        return await side.run(prompt, "r", max_new=8)

    (jt, _, _), (tt, _, _), jcore, tcore = await on_both(
        np_params, scenario, max_num_seqs=2, prefill_chunk=16)
    assert tt == jt and len(tt) == 8
    assert tcore.total_prefill_tokens == jcore.total_prefill_tokens


async def test_chunked_prefill_with_prefix_reuse_matches_jax(np_params):
    prefix = _prompt(13, 32)
    p1, p2 = prefix + [3, 5], prefix + [9, 11]

    async def scenario(side):
        await side.run(p1, "a", max_new=8)
        return await side.run(p2, "b", max_new=8)

    (jt, _, jq), (tt, _, tq), _, _ = await on_both(
        np_params, scenario, max_num_seqs=2, prefill_chunk=16)
    assert tq.prefix_hit_tokens == jq.prefix_hit_tokens >= 24
    assert tt == jt and len(tt) == 8


# -------------------------------------------------------------- lane prefill

LANES = dict(max_num_seqs=2, prefill_buckets=[32, 64, 128],
             decode_steps_per_dispatch=4, lane_prefill_max_tokens=512)


@pytest.mark.parametrize("samp_b", [None, SEEDED], ids=["greedy", "seeded"])
async def test_lane_admission_streams_match_jax(np_params, samp_b):
    pa, pb = _prompt(41, 25), _prompt(43, 21)

    async def scenario(side):
        return await side.busy_pair(pa, pb, samp_b=samp_b)

    ((ja, _, _), (jb, _, _)), ((ta, _, _), (tb, _, _)), jcore, tcore = \
        await on_both(np_params, scenario, **LANES)
    assert jcore.lane_admissions >= 1 and tcore.lane_admissions >= 1
    assert ta == ja and len(ta) == 32
    assert tb == jb and len(tb) == 24


async def test_lane_admission_after_prefix_hit_matches_jax(np_params):
    shared = _prompt(47, 16)
    pa = shared + _prompt(48, 8)
    pb = shared + _prompt(49, 9)

    async def scenario(side):
        await side.run(pa, "a0", max_new=8)
        return await side.busy_pair(pa, pb)

    (_, (jb, _, jq)), (_, (tb, _, tq)), jcore, tcore = await on_both(
        np_params, scenario, **LANES)
    assert jcore.lane_admissions >= 1 and tcore.lane_admissions >= 1
    assert tq.prefix_hit_tokens == jq.prefix_hit_tokens >= 8
    assert tb == jb and len(tb) == 24


@pytest.mark.parametrize("overlap", [True, False],
                         ids=["deferred_fetch", "fetch_at_once"])
async def test_back_to_back_admissions_match_jax(np_params, overlap):
    """Two prompts posted back to back into an idle engine. With the
    deferred first-token fetch (the default) the first admission is not
    ready when the second is admitted, so the second takes a prefill of its
    own, not a lane; fetched at once, the first is ready and the second
    rides its batch. Lane admissions, host round trips and streams equal
    the JAX engine's either way."""
    pa, pb = _prompt(61, 25), _prompt(62, 21)

    async def scenario(side):
        ra = await side.submit(pa, "a", max_new=20)
        rb = await side.submit(pb, "b", max_new=16, sampling=SEEDED)
        return await asyncio.gather(side.drain(ra), side.drain(rb))

    ((ja, _, _), (jb, _, _)), ((ta, _, _), (tb, _, _)), jcore, tcore = \
        await on_both(np_params, scenario, overlap_admission_fetch=overlap,
                      **LANES)
    assert tcore.lane_admissions == jcore.lane_admissions == (0 if overlap
                                                              else 1)
    assert tcore.host_roundtrips == jcore.host_roundtrips
    assert ta == ja and len(ta) == 20
    assert tb == jb and len(tb) == 16


def _first_recompute(*reqs):
    """The first client-stream index that a recompute prefill re-derived
    in either engine (a lane admission's own boundary at 0 is not one:
    both engines derive that token through the decode program)."""
    bounds = [b for r in reqs for b in r.numeric_boundaries if b > 0]
    return min(bounds) if bounds else None   # None: the whole stream


@pytest.mark.parametrize("pipeline", [False, True])
async def test_lane_under_preemption_matches_jax(np_params, pipeline):
    p1, p2 = _prompt(53, 30), _prompt(54, 30)
    max_new = 40

    async def scenario(side):
        return await side.busy_pair(p1, p2, max_new_a=max_new,
                                    max_new_b=max_new)

    # 11 usable blocks of 8 tokens, 9 per sequence at full length: one
    # must be preempted (recompute) while the other runs
    jout, tout, jcore, tcore = await on_both(
        np_params, scenario, **dict(LANES, num_kv_blocks=12,
                                    decode_dispatch_pipeline=pipeline))
    assert jcore.lane_admissions >= 1 and tcore.lane_admissions >= 1
    assert jcore.preemptions > 0 and tcore.preemptions > 0
    for (jt, jr, jq), (tt, tr, tq) in zip(jout, tout):
        assert tr.value == jr.value == "length"
        assert len(tt) == len(jt) == max_new
        boundary = _first_recompute(jq, tq)
        assert tt[:boundary] == jt[:boundary]


# ------------------------------------------------------- the program itself

K3 = 3
BS, M = 8, 8


def _program_inputs():
    """Four slots for one K = 3 dispatch: a lane mid-prompt for all three
    steps (keys below zero), a lane whose last prompt token is step 0's
    input (then it chains its samples; seeded top-p sampling), a decoding
    slot at position 21, and an inactive slot on the trash block."""
    rng = np.random.default_rng(9)
    tokens = np.array([0, 0, 17, 0], np.int64)
    positions = np.array([4, 9, 21, 0], np.int32)
    tables = np.zeros((4, M), np.int32)
    tables[0, :1], tables[1, :2], tables[2, :3] = [1], [2, 3], [4, 5, 6]
    planned = np.zeros((K3, 4), np.int64)
    pmask = np.zeros((K3, 4), bool)
    planned[:, 0] = rng.integers(1, 256, size=K3)
    pmask[:, 0] = True
    planned[0, 1], pmask[0, 1] = 33, True
    return dict(tokens=tokens, positions=positions, tables=tables,
                seeds=np.array([5, 99, 7, 0], np.int64),
                steps0=np.array([-3, 4, 11, 0], np.int64),
                temperature=np.array([0.0, 0.7, 0.0, 0.0], np.float32),
                top_k=np.array([0, 0, 0, 0], np.int64),
                top_p=np.array([1.0, 0.9, 1.0, 1.0], np.float32),
                planned=planned, planned_mask=pmask)


def _prefill_pools(np_params, tcfg, jcore):
    """Write the same random-token prefills into both pools: slot 0's 4,
    slot 1's 9 and slot 2's 21 tokens."""
    rng = np.random.default_rng(10)
    kv = tllama.init_kv_cache(tcfg, 16, BS, "cpu", torch.float32)
    params = params_from_numpy(np_params, tcfg, "cpu", torch.float32)
    inp = _program_inputs()
    for i in range(3):
        n = int(inp["positions"][i])
        toks = np.zeros((32,), np.int32)
        toks[:n] = rng.integers(1, 256, size=n)
        table = inp["tables"][i]
        with torch.inference_mode():
            tllama.prefill_forward(params, kv, torch.from_numpy(
                toks.astype(np.int64)), torch.from_numpy(table), 0, n, tcfg,
                BS)
        _, jcore.kv = jllama.prefill_forward(
            jcore.params, jcore.kv, jnp.asarray(toks), jnp.asarray(table),
            jnp.int32(0), jnp.int32(n), jcore.statics)
    return params, kv


def test_decode_program_matches_jax_decode_k(np_params):
    jcfg = JEngineConfig(max_model_len=64, kv_block_size=BS,
                         num_kv_blocks=16, max_num_seqs=4,
                         prefill_buckets=[32, 64],
                         decode_steps_per_dispatch=K3)
    jcore = JEngineCore(JModelConfig(**GEOM), jcfg,
                        params={k: jnp.asarray(v)
                                for k, v in np_params.items()},
                        attn_impl="xla", param_dtype=jnp.float32)
    tcfg = ModelConfig(**GEOM)
    params, kv = _prefill_pools(np_params, tcfg, jcore)
    inp = _program_inputs()
    jt, jl, jkv = jcore._decode_k_jit(
        jcore.params, jcore.kv, jnp.asarray(inp["tokens"], jnp.int32),
        jnp.asarray(inp["positions"]), jnp.asarray(inp["tables"]),
        jnp.asarray(inp["seeds"]), jnp.asarray(inp["steps0"]),
        jnp.asarray(inp["temperature"]),
        jnp.asarray(inp["top_k"], jnp.int32), jnp.asarray(inp["top_p"]),
        jnp.asarray(inp["planned"], jnp.int32),
        jnp.asarray(inp["planned_mask"]))
    variant = sampling_variant(inp["temperature"], inp["top_k"],
                               inp["top_p"], np.array([1, 1, 1, 0], bool))
    assert variant == "filtered"
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    with torch.inference_mode():
        tt, tl = decode_k_forward(
            params, kv, t["tokens"], t["positions"], t["tables"], t["seeds"],
            t["steps0"], t["temperature"], t["top_k"], t["top_p"],
            t["planned"], t["planned_mask"], cfg=tcfg, block_size=BS,
            base_seed=jcfg.seed, K=K3, variant=variant)
    live = slice(0, 3)           # slot 3 is inactive: its sample is noise
    assert (tt.numpy()[:, live] == np.asarray(jt)[:, live]).all()
    np.testing.assert_allclose(tl.numpy()[:, live], np.asarray(jl)[:, live],
                               atol=LOGPROB_ATOL, rtol=0)
    for name in ("k", "v"):      # outside the trash block 0
        np.testing.assert_allclose(kv[name].numpy()[:, BS:],
                                   np.asarray(jkv[name])[:, BS:],
                                   atol=KV_ATOL, rtol=0)
    # the program object runs the same function eagerly on the CPU
    prog = DecodeProgram(params, tllama.init_kv_cache(tcfg, 16, BS, "cpu",
                                                      torch.float32),
                         tcfg, BS, 4, M, K3, jcfg.seed, "cpu")
    assert prog.dispatch(K3, variant, inp).fetch()[0].shape == (K3, 4)
    assert prog.graphs == {}


def test_sampling_variant_rule():
    t = np.array([0.0, 0.7, 0.0], np.float32)
    k = np.array([0, 0, 0], np.int64)
    p = np.array([1.0, 1.0, 0.9], np.float32)
    live = np.array([True, False, True])
    # the only sampling row is not live: greedy
    assert sampling_variant(t, k, p, live) == "greedy"
    # a live sampling row; a top-p row anywhere picks the filtered branch
    assert sampling_variant(t, k, p, np.ones(3, bool)) == "filtered"
    assert sampling_variant(t, k, np.ones(3, np.float32),
                            np.ones(3, bool)) == "temperature"


def test_make_slot_keys_bit_equal_to_scalar_and_jax():
    seeds = np.array([0, 7, 99, 12345, 3, 2**31 - 1], np.int64)
    steps = np.array([-3, 0, -1, 2**31 - 1, 1 << 20, -(2**31)], np.int64)
    keys = make_slot_keys(42, torch.from_numpy(seeds),
                          torch.from_numpy(steps)).numpy()
    scalar = np.array([make_slot_key(42, int(a), int(b))
                       for a, b in zip(seeds, steps)], np.int64)
    assert (keys == scalar).all()
    jkeys = np.asarray(j_make_slot_keys(42, jnp.asarray(seeds, jnp.int32),
                                        jnp.asarray(steps, jnp.int32)))
    assert (keys == jkeys.astype(np.int64)).all()


def test_dispatch_fields_follow_jax_config():
    j, t = JEngineConfig(), EngineConfig()
    for f in ("prefill_chunk", "decode_steps_per_dispatch",
              "decode_dispatch_pipeline", "lane_prefill_max_tokens",
              "overlap_admission_fetch"):
        assert getattr(t, f) == getattr(j, f)
    with pytest.raises(ValueError, match="decode_steps_per_dispatch"):
        EngineConfig(decode_dispatch_pipeline=True)
    with pytest.raises(ValueError, match="decode_steps_per_dispatch"):
        EngineConfig(lane_prefill_max_tokens=16)
    # the pipelined ragged dispatch at K = 1: the JAX package's outcome
    kw = dict(ragged_dispatch=True, decode_dispatch_pipeline=True)
    t, j = EngineConfig(**kw), JEngineConfig(**kw)
    for f in ("decode_steps_per_dispatch", "decode_dispatch_pipeline",
              "ragged_dispatch", "ragged_max_tokens"):
        assert getattr(t, f) == getattr(j, f)
    # under ragged dispatch K is accepted and ignored, as in JAX
    EngineConfig(ragged_dispatch=True, decode_steps_per_dispatch=4)


def test_launcher_flags_reach_engine_config(tmp_path):
    import json
    from dynamo_tpu_torch.launch import run
    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 64, "hidden_size": 32, "intermediate_size": 64,
        "num_hidden_layers": 1, "num_attention_heads": 2,
        "num_key_value_heads": 1, "head_dim": 16,
        "max_position_embeddings": 128}))
    args = run.build_parser().parse_args(
        ["--model-path", str(tmp_path), "--random-weights", "--device",
         "cpu", "--max-model-len", "128", "--num-kv-blocks", "32",
         "--prefill-chunk", "32", "--decode-steps-per-dispatch", "8",
         "--decode-dispatch-pipeline", "--lane-prefill-max-tokens", "128"])
    core = run.build_core(args)
    assert (core.cfg.prefill_chunk, core.cfg.decode_steps_per_dispatch,
            core.cfg.decode_dispatch_pipeline,
            core.cfg.lane_prefill_max_tokens) == (32, 8, True, 128)
    assert core.program.max_k == 8
