"""The port's speculative decoding against the JAX package's, on the CPU.

- The prompt-lookup drafter and ``accept_lockstep``: the port's copies give
  the JAX package's results on seeded random and repetitive histories over
  a grid of k, n-gram ranges and windows, and the same ``ValueError`` for a
  bad n-gram range.
- Engine streams: both engines run the same tiny model (the JAX init,
  converted with ``params_from_numpy``) in f32 with ``spec_k`` of 1-4,
  greedy and seeded (temperature 0.8, and 0.05, where drafts are accepted
  too), on the split path (K = 1, and K = 4 pipelined) and ``--ragged``
  (pipelined and not). The port's spec streams equal JAX's spec streams
  and the port's own plain (``spec_k`` 0) streams, bit for bit, and the
  ``spec_*`` counters, ``ragged_spec_rows``, ``ForwardPassMetrics``'
  ``spec_*`` fields and the host round trips equal JAX's (but on the K =
  1 split path, whose single-step fetch the JAX engine does not count).
- The JAX suite's degeneracy and retune cases (``tests/test_spec_decode.py``):
  a request with ``speculation`` 0 pays no verify dispatch, ``spec_k_live``
  0 turns the default off and 99 clamps to the built maximum; a preemption
  mid-speculation keeps each stream equal to the uncontended plain one up
  to its first recompute boundary, and to JAX's contended spec streams.
- ``nvext.speculation`` through the preprocessor to
  ``EngineRequest.spec_k``.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import spec as jspec
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.core import FINISH_SENTINEL as J_FINISH
from dynamo_tpu.engine.core import EngineCore as JEngineCore
from dynamo_tpu.engine.core import EngineRequest as JEngineRequest
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.sampling import SlotSampling as JSlotSampling
from dynamo_tpu_torch.engine import spec as tspec
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.core import (FINISH_SENTINEL, EngineCore,
                                          EngineRequest)
from dynamo_tpu_torch.engine.sampling import SlotSampling
from dynamo_tpu_torch.engine.weights import params_from_numpy

GEOM = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position_embeddings=512)
BASE = dict(max_model_len=256, kv_block_size=8, num_kv_blocks=64,
            max_num_seqs=2, prefill_buckets=[32, 64, 128])
GREEDY = dict(temperature=0.0)
SEEDED = dict(temperature=0.8, seed=77)
# near-greedy: drafts are accepted under sampling too
LOW = dict(temperature=0.05, seed=13)
COUNTERS = ("spec_dispatches", "spec_drafted_tokens", "spec_accepted_tokens",
            "spec_emitted_tokens", "ragged_spec_rows", "host_roundtrips",
            "total_decode_tokens", "total_prefill_tokens")


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


def jax_core(np_params, **kw):
    return JEngineCore(JModelConfig(**GEOM), JEngineConfig(**{**BASE, **kw}),
                       params={k: jnp.asarray(v)
                               for k, v in np_params.items()},
                       attn_impl="xla", param_dtype=jnp.float32)


def port_core(np_params, **kw):
    cfg = ModelConfig(**GEOM)
    return EngineCore(cfg, EngineConfig(dtype="float32", **{**BASE, **kw}),
                      params=params_from_numpy(np_params, cfg, "cpu",
                                               torch.float32),
                      device="cpu")


def repetitive(rng, period=6, reps=5):
    return rng.integers(1, GEOM["vocab_size"], size=period).tolist() * reps


async def run_reqs(core, prompts, max_new=32, sampling=GREEDY, spec_k=-1,
                   stop=True, rid0=0):
    """Serve ``prompts`` together as requests r{rid0}, r{rid0 + 1}, ...;
    returns [(tokens, finish, request)]. ``stop``: stop the engine after
    (else the caller does)."""
    jax_side = isinstance(core, JEngineCore)
    sentinel = J_FINISH if jax_side else FINISH_SENTINEL
    reqs = []
    for i, p in enumerate(prompts):
        cls, samp = ((JEngineRequest, JSlotSampling) if jax_side
                     else (EngineRequest, SlotSampling))
        req = cls(rid=f"r{rid0 + i}", prompt=list(p),
                  sampling=samp(**sampling),
                  max_new_tokens=max_new, eos_ids=frozenset(),
                  spec_k=spec_k)
        await core.submit(req)
        reqs.append(req)

    async def drain(req):
        toks = []
        while True:
            item, payload = await asyncio.wait_for(req.out_queue.get(), 120)
            if item is sentinel:
                return toks, payload, req
            toks.append(item)
    try:
        return await asyncio.gather(*(drain(r) for r in reqs))
    finally:
        if stop:
            await core.stop()


# ------------------------------------------------------------ the drafter


def _histories(seed):
    rng = np.random.default_rng(seed)
    hs = [rng.integers(0, 50, size=int(rng.integers(0, 80))).tolist()
          for _ in range(6)]
    hs += [rng.integers(1, 9, size=int(rng.integers(1, 6))).tolist()
           * int(rng.integers(1, 12)) for _ in range(6)]
    hs.append([int(rng.integers(0, 5))] * int(rng.integers(1, 20)))
    return hs


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_ngram,min_ngram,window",
                         [(4, 1, 1024), (3, 2, 40), (1, 1, 16)])
def test_prompt_lookup_drafts_match_jax(seed, max_ngram, min_ngram, window):
    t = tspec.PromptLookupDrafter(max_ngram, min_ngram, window)
    j = jspec.PromptLookupDrafter(max_ngram, min_ngram, window)
    for h in _histories(seed):
        for k in range(0, 6):
            assert t.draft(h, k) == j.draft(h, k), (h, k)


@pytest.mark.parametrize("max_ngram,min_ngram", [(1, 2), (3, 0), (0, 0),
                                                 (2, -1)])
def test_prompt_lookup_bad_ngram_range_matches_jax(max_ngram, min_ngram):
    with pytest.raises(ValueError) as te:
        tspec.PromptLookupDrafter(max_ngram=max_ngram, min_ngram=min_ngram)
    with pytest.raises(ValueError) as je:
        jspec.PromptLookupDrafter(max_ngram=max_ngram, min_ngram=min_ngram)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("seed", range(4))
def test_accept_lockstep_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        k = int(rng.integers(0, 6))
        sampled = rng.integers(0, 4, size=k + 1).tolist()
        # drafts that agree with the samples for a while, then may not
        drafts = [s if rng.random() < 0.7 else int(rng.integers(0, 4))
                  for s in sampled[:k]]
        assert (tspec.accept_lockstep(drafts, sampled)
                == jspec.accept_lockstep(drafts, sampled))


def test_spec_config_matches_jax():
    assert tspec.spec_config_key("ns") == jspec.spec_config_key("ns")
    raw = jspec.SpecConfig(k=3).to_json()
    assert tspec.SpecConfig(k=3).to_json() == raw
    assert tspec.SpecConfig.from_json(raw).k == 3


# -------------------------------------------------------- engine streams

# (spec_k, dispatch fields, sampling): each case holds the port's spec
# streams against JAX's and the port's plain ones
STREAM_CASES = [
    (1, dict(), GREEDY),
    (3, dict(), SEEDED),
    (2, dict(decode_steps_per_dispatch=4, decode_dispatch_pipeline=True),
     LOW),
    (4, dict(ragged_dispatch=True), GREEDY),
    (2, dict(ragged_dispatch=True), SEEDED),
    (3, dict(ragged_dispatch=True, decode_dispatch_pipeline=True), LOW),
]


@pytest.mark.parametrize("spec_k,fields,sampling", STREAM_CASES)
async def test_spec_streams_match_jax_and_plain(np_params, spec_k, fields,
                                                sampling):
    rng = np.random.default_rng(101 + spec_k)
    prompts = [repetitive(rng), repetitive(rng, period=4, reps=8)]
    jcore = jax_core(np_params, spec_k=spec_k, **fields)
    jout = await run_reqs(jcore, prompts, sampling=sampling)
    tcore = port_core(np_params, spec_k=spec_k, **fields)
    tout = await run_reqs(tcore, prompts, sampling=sampling)
    pout = await run_reqs(port_core(np_params, **fields), prompts,
                          sampling=sampling)
    for (jt, jr, _), (tt, tr, _), (pt, _, _) in zip(jout, tout, pout):
        assert len(tt) == 32 and tr.value == jr.value
        assert tt == jt, "spec stream differs from JAX's"
        assert tt == pt, "spec stream differs from plain decode"
    assert tcore.spec_dispatches > 0
    if sampling is not SEEDED:
        assert tcore.spec_accepted_tokens > 0
    for name in COUNTERS:
        if name == "host_roundtrips" and not fields:
            continue     # JAX's single-step decode does not count its fetch
        assert getattr(tcore, name) == getattr(jcore, name), name
    jm, tm = jcore.metrics(), tcore.metrics()
    for f in ("spec_drafted_total", "spec_accepted_total",
              "spec_acceptance_rate", "spec_accepted_per_step"):
        assert getattr(tm, f) == getattr(jm, f), f
    if fields.get("ragged_dispatch"):
        assert tm.ragged_spec_rows_total == jm.ragged_spec_rows_total > 0
    assert tcore.spec_emitted_tokens >= tcore.spec_dispatches
    assert tcore._pending is None and tcore._ragged_pending is None


@pytest.mark.parametrize("fields", [
    dict(decode_steps_per_dispatch=4),
    dict(ragged_dispatch=True, decode_dispatch_pipeline=True)])
async def test_preemption_mid_speculation(np_params, fields):
    """Two repetitive prompts in a 16-block pool: recompute preemptions
    land between verify dispatches. Each stream equals the uncontended
    plain stream up to its first recompute boundary and JAX's contended
    spec stream up to either engine's first boundary (the JAX suite's
    contract: a re-admission's sums differ from the decode program's)."""
    rng = np.random.default_rng(61)
    prompts = [repetitive(rng), repetitive(rng)]
    # the uncontended plain streams: both fit the 64-block pool at once
    refs = [t for t, _, _ in await run_reqs(port_core(np_params, **fields),
                                            prompts, max_new=40)]
    small = dict(fields, spec_k=3, num_kv_blocks=16)
    jout = await run_reqs(jax_core(np_params, **small), prompts, max_new=40)
    tcore = port_core(np_params, **small)
    tout = await run_reqs(tcore, prompts, max_new=40)
    assert tcore.preemptions > 0 and tcore.spec_dispatches > 0
    for ref, (jt, _, jq), (tt, tr, tq) in zip(refs, jout, tout):
        assert len(tt) == 40 and tr.value == "length"
        own = [b for b in tq.numeric_boundaries if b > 0]
        first = min(own) if own else None
        assert tt[:first] == ref[:first]
        both = own + [b for b in jq.numeric_boundaries if b > 0]
        first = min(both) if both else None
        assert tt[:first] == jt[:first]


async def test_request_speculation_zero_is_plain_decode(np_params):
    rng = np.random.default_rng(109)
    prompt = repetitive(rng)
    core = port_core(np_params, spec_k=3)
    (got, _, _), = await run_reqs(core, [prompt], spec_k=0)
    (ref, _, _), = await run_reqs(port_core(np_params), [prompt])
    assert core.spec_dispatches == 0 and got == ref


@pytest.mark.parametrize("fields", [dict(), dict(ragged_dispatch=True)])
async def test_live_retune_clamps_and_disables(np_params, fields):
    rng = np.random.default_rng(113)
    prompt = repetitive(rng)
    core = port_core(np_params, spec_k=2, **fields)
    core.spec_k_live = 0                      # the default turned off
    await run_reqs(core, [prompt])
    assert core.spec_dispatches == 0
    core.spec_k_live = 99                     # clamps to the built 2
    req = EngineRequest(rid="c", prompt=list(prompt),
                        sampling=SlotSampling(), max_new_tokens=4,
                        eos_ids=frozenset())
    assert core._req_spec_k(req) == 2
    req.spec_k = 1
    assert core._req_spec_k(req) == 1


def test_nvext_speculation_reaches_the_engine_request(np_params, tmp_path):
    from dynamo_tpu_torch.llm.engines.torch_engine import TorchEngine
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols.openai import CompletionRequest
    from tests.fixtures import build_tiny_model_dir

    mdc = ModelDeploymentCard.from_local_path(
        build_tiny_model_dir(str(tmp_path / "m")), display_name="m")
    pre = OpenAIPreprocessor(mdc)
    core = port_core(np_params, spec_k=3)
    eng = TorchEngine(core)

    @dataclasses.dataclass
    class _Req:
        data: object
        id: str = "r1"
        ctx: object = None

    for nvext, want, clamped in ((None, -1, 3), ({"speculation": 2}, 2, 2),
                                 ({"speculation": 0}, 0, 0),
                                 ({"speculation": 9}, 9, 3)):
        body = {"model": "m", "prompt": [5, 6, 7], "max_tokens": 4}
        if nvext is not None:
            body["nvext"] = nvext
        req = CompletionRequest.from_dict(body)
        got = eng.build_request(_Req(pre.preprocess_completion(req)))
        assert got.spec_k == want and core._req_spec_k(got) == clamped
    with pytest.raises(ValueError, match="speculation"):
        CompletionRequest.from_dict({"model": "m", "prompt": "x",
                                     "nvext": {"speculation": "2"}})


def test_spec_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults do not raise")
    for fields in (dict(), dict(ragged_dispatch=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EngineCore(ModelConfig(**GEOM),
                       EngineConfig(spec_k=2, **BASE, **fields))
