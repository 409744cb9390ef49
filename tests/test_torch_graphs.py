"""The decode program's CUDA graphs against the same program run eagerly.

These tests need an NVIDIA GPU (marker ``cuda``): a captured graph has no
CPU form. Without a card each test skips inside the test, with a reason.
A small llama (hidden 256, so every layer matmul passes the grouped-int4
kernel's shape rule) runs one dispatch of K = 1 and K = 4 steps in bf16
and with int4 weights over an int8 KV pool, through a graph replay and
eagerly from the same pool: the live slots' tokens, logprobs and logits
and the pool rows outside the trash block must have the same bits (the
same kernels on the same inputs). Each replay adds the launches its graph
holds to the kernels' counts; a replay whose static inputs were left
stale must differ from the eager run on the new inputs. A Gemma-2 program
(head dim 256, soft-caps, a window that binds) replays equal to eager too,
and so does an MLA program (DeepSeek-V2's latent widths over a bf16 and a
sectioned int8 pool, with the MoE block's top-k routing in the graph). A
Phi-3 program (head dim 96 over 4 KV heads, g = 1, a window on every layer
that binds) replays equal to eager too. The ragged program replays
equal to eager at its two row buckets (a pure-decode batch and a mixed one
with dead rows) in each sampling variant, in llama bf16 and int4 + int8
KV, Gemma-2 with its window and MLA over a bf16 and an int8 latent pool;
a stale static input is caught there too, and two chained pure-decode
dispatches give the tokens of two host-fed ones. An admission's deferred
first-token copy (``overlap_admission_fetch``) refuses to run inside a
capture, and an engine on the card with it serves the same greedy tokens
as with the fetch at once, its second back-to-back prompt prefilled rather
than lane-admitted.
"""

from typing import Optional

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import kernels
from dynamo_tpu_torch.engine.attention import quantize_kv_rows
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.models import llama
from dynamo_tpu_torch.engine.programs import DecodeProgram
from dynamo_tpu_torch.engine.quant import init_params_quantized
from dynamo_tpu_torch.engine.weights import init_params

pytestmark = pytest.mark.cuda

CFG = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                  num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                  max_position_embeddings=512)
BS, M, B = 16, 8, 4
LIVE = [0, 1, 2]                # slot 3 is inactive (the trash block)


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    tables = np.zeros((B, M), np.int32)
    for i in LIVE:
        tables[i, :4] = 1 + 4 * i + np.arange(4)
    return dict(tokens=rng.integers(3, CFG.vocab_size, size=B),
                positions=np.array([5, 20, 33, 0], np.int32),
                tables=tables, seeds=np.array([0, 7, 9, 0], np.int64),
                steps0=np.array([3, 11, -2, 0], np.int64),
                temperature=np.array([0.0, 0.7, 0.9, 0.0], np.float32),
                top_k=np.array([0, 0, 20, 0], np.int64),
                top_p=np.array([1.0, 0.9, 1.0, 1.0], np.float32))


def _program(mode: str, dev, cfg=CFG):
    torch.manual_seed(0)
    if mode == "bf16":
        params = init_params(cfg, 0, dev, torch.bfloat16)
    else:
        params = init_params_quantized(cfg, 0, dev, torch.bfloat16, bits=4)
    kv = llama.init_kv_cache(cfg, 16, BS, dev, torch.bfloat16,
                             quantization="none" if mode == "bf16"
                             else "int8")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    C = cfg.num_kv_heads * cfg.head_dim
    for name in ("k", "v"):       # a prefix in every live block
        rows = torch.randn((cfg.num_layers * kv[name].shape[1], C),
                           generator=g, device=dev)
        if kv[name].dtype == torch.int8:
            rows = quantize_kv_rows(rows)
        kv[name].copy_(rows.view(kv[name].shape))
    return DecodeProgram(params, kv, cfg, BS, B, M, 4, 0, dev), kv


@pytest.mark.parametrize("mode", ["bf16", "int4_kv8"])
@pytest.mark.parametrize("K", [1, 4])
def test_graph_replay_equals_eager(mode, K):
    dev = _device()
    prog, kv = _program(mode, dev)
    pool0 = {n: t.clone() for n, t in kv.items()}
    inp = _inputs(K)
    with torch.inference_mode():
        before = {k: v.launches for k, v in kernels.KERNELS.items()}
        d = prog.dispatch(K, "filtered", inp, with_logits=True)
        toks, lps = d.fetch()
        logits = d.logits.clone()
        counted = {k: v.launches - before[k]
                   for k, v in kernels.KERNELS.items()}
        pool_g = {n: t.clone() for n, t in kv.items()}
        for n, t in kv.items():
            t.copy_(pool0[n])
        e = prog.run_eager(K, "filtered", inp, with_logits=True)
        torch.cuda.synchronize()
    assert prog.captures == 1 and prog.replays == 1
    g = prog.graphs[(K, "filtered", True)]
    # the warm-up call launched each kernel once per step and layer, and
    # the replay added the graph's own launches
    attn = "paged_attention" if mode == "bf16" else "paged_attention_int8"
    assert g.launches[attn] == K * CFG.num_layers
    assert counted[attn] == 2 * K * CFG.num_layers
    if mode != "bf16":
        assert g.launches["grouped_int4_matmul"] == 7 * K * CFG.num_layers
        assert g.launches["lm_head_int8"] == K
    assert (toks[:, LIVE] == e.toks.cpu().numpy()[:, LIVE]).all()
    assert (lps[:, LIVE] == e.logprobs.cpu().numpy()[:, LIVE]).all()
    assert torch.equal(logits[:, LIVE], e.logits[:, LIVE])
    for n in kv:
        assert torch.equal(pool_g[n][:, BS:], kv[n][:, BS:])


def test_stale_static_inputs_are_caught():
    dev = _device()
    prog, kv = _program("bf16", dev)
    with torch.inference_mode():
        prog.dispatch(1, "greedy", _inputs(1), with_logits=True).fetch()
        upload = prog._upload
        prog._upload = lambda inputs: None      # the planted fault
        try:
            stale = prog.dispatch(1, "greedy", _inputs(2),
                                  with_logits=True).logits.clone()
        finally:
            prog._upload = upload
        right = prog.run_eager(1, "greedy", _inputs(2), with_logits=True)
        fresh = prog.dispatch(1, "greedy", _inputs(2),
                              with_logits=True).logits.clone()
    assert not torch.equal(stale[:, LIVE], right.logits[:, LIVE])
    assert torch.equal(fresh[:, LIVE], right.logits[:, LIVE])


# Gemma-2's decode program: head dim 256, soft-caps, a 16-token window on
# the even layer that binds at every live slot's position (the floors come
# from the positions on the device, so the graph replays them)
GEMMA_CFG = ModelConfig(
    model_type="gemma2", vocab_size=512, hidden_size=256,
    intermediate_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=256, max_position_embeddings=512, rms_norm_eps=1e-6,
    rope_theta=10000.0, tie_word_embeddings=True,
    hidden_act="gelu_pytorch_tanh", embed_scale=True, norm_plus_one=True,
    post_norms=True, attn_logit_softcap=50.0, final_logit_softcap=30.0,
    query_pre_attn_scalar=256.0, sliding_window=16)


@pytest.mark.parametrize("mode", ["bf16", "int4_kv8"])
@pytest.mark.parametrize("K", [1, 4])
def test_gemma2_graph_replay_equals_eager(mode, K):
    dev = _device()
    prog, kv = _program(mode, dev, GEMMA_CFG)
    pool0 = {n: t.clone() for n, t in kv.items()}
    inp = _inputs(K)
    with torch.inference_mode():
        d = prog.dispatch(K, "filtered", inp, with_logits=True)
        toks, lps = d.fetch()
        logits = d.logits.clone()
        pool_g = {n: t.clone() for n, t in kv.items()}
        for n, t in kv.items():
            t.copy_(pool0[n])
        e = prog.run_eager(K, "filtered", inp, with_logits=True)
        torch.cuda.synchronize()
    g = prog.graphs[(K, "filtered", True)]
    attn = "paged_attention" if mode == "bf16" else "paged_attention_int8"
    assert g.launches[attn] == K * GEMMA_CFG.num_layers
    assert (toks[:, LIVE] == e.toks.cpu().numpy()[:, LIVE]).all()
    assert (lps[:, LIVE] == e.logprobs.cpu().numpy()[:, LIVE]).all()
    assert torch.equal(logits[:, LIVE], e.logits[:, LIVE])
    assert torch.isfinite(logits[:, LIVE]).all()
    for n in kv:
        assert torch.equal(pool_g[n][:, BS:], kv[n][:, BS:])


# an MLA decode program at DeepSeek-V2's attention widths (16 heads, latent
# rank 512, rope 64: K3-MLA's compiled shape), 2 layers (the first dense,
# then 4 experts top-2 with shared experts), over a bf16 and an int8 pool
MLA_CFG = ModelConfig(
    model_type="deepseek_v2", vocab_size=512, hidden_size=256,
    intermediate_size=128, num_layers=2, num_heads=16, num_kv_heads=16,
    head_dim=192, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, num_experts=4,
    num_experts_per_tok=2, moe_norm_topk=False, first_k_dense=1,
    dense_intermediate_size=256, shared_expert_size=128,
    max_position_embeddings=512)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("K", [1, 4])
def test_mla_graph_replay_equals_eager(kv_quant, K):
    from dynamo_tpu_torch.engine.attention import quantize_kv_rows_sections
    from dynamo_tpu_torch.engine.models import mla
    dev = _device()
    params = init_params(MLA_CFG, 0, dev, torch.bfloat16)
    kv = mla.init_kv_cache(MLA_CFG, 16, BS, dev, torch.bfloat16,
                           quantization=kv_quant)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    rows = torch.randn((MLA_CFG.num_layers * kv["kv"].shape[1], 576),
                       generator=g, device=dev)     # a prefix in every block
    if kv_quant == "int8":
        rows = quantize_kv_rows_sections(rows, (512, 64))
    kv["kv"][..., :rows.shape[1]] = rows.view(kv["kv"].shape[:2] + (-1,))
    prog = DecodeProgram(params, kv, MLA_CFG, BS, B, M, 4, 0, dev)
    pool0 = kv["kv"].clone()
    inp = _inputs(K)
    with torch.inference_mode():
        d = prog.dispatch(K, "filtered", inp, with_logits=True)
        toks, lps = d.fetch()
        logits = d.logits.clone()
        pool_g = kv["kv"].clone()
        kv["kv"].copy_(pool0)
        e = prog.run_eager(K, "filtered", inp, with_logits=True)
        torch.cuda.synchronize()
    g = prog.graphs[(K, "filtered", True)]
    attn = ("latent_paged_attention_int8" if kv_quant == "int8"
            else "latent_paged_attention")
    assert g.launches[attn] == K * MLA_CFG.num_layers
    assert (toks[:, LIVE] == e.toks.cpu().numpy()[:, LIVE]).all()
    assert (lps[:, LIVE] == e.logprobs.cpu().numpy()[:, LIVE]).all()
    assert torch.equal(logits[:, LIVE], e.logits[:, LIVE])
    assert torch.isfinite(logits[:, LIVE]).all()
    assert torch.equal(pool_g[:, BS:], kv["kv"][:, BS:])


# Phi-3's decode program: head dim 96, g = 1, a 16-token window on every
# layer that binds at the live slots' positions 20 and 33
PHI3_CFG = ModelConfig(
    model_type="phi3", vocab_size=512, hidden_size=256,
    intermediate_size=512, num_layers=2, num_heads=4, num_kv_heads=4,
    head_dim=96, max_position_embeddings=512, sliding_window=16,
    layer_types=["sliding_attention"] * 2)


@pytest.mark.parametrize("mode", ["bf16", "int4_kv8"])
@pytest.mark.parametrize("K", [1, 4])
def test_phi3_graph_replay_equals_eager(mode, K):
    dev = _device()
    prog, kv = _program(mode, dev, PHI3_CFG)
    pool0 = {n: t.clone() for n, t in kv.items()}
    inp = _inputs(K)
    with torch.inference_mode():
        d = prog.dispatch(K, "filtered", inp, with_logits=True)
        toks, lps = d.fetch()
        logits = d.logits.clone()
        pool_g = {n: t.clone() for n, t in kv.items()}
        for n, t in kv.items():
            t.copy_(pool0[n])
        e = prog.run_eager(K, "filtered", inp, with_logits=True)
        torch.cuda.synchronize()
    g = prog.graphs[(K, "filtered", True)]
    attn = "paged_attention" if mode == "bf16" else "paged_attention_int8"
    assert g.launches[attn] == K * PHI3_CFG.num_layers
    assert (toks[:, LIVE] == e.toks.cpu().numpy()[:, LIVE]).all()
    assert (lps[:, LIVE] == e.logprobs.cpu().numpy()[:, LIVE]).all()
    assert torch.equal(logits[:, LIVE], e.logits[:, LIVE])
    assert torch.isfinite(logits[:, LIVE]).all()
    for n in kv:
        assert torch.equal(pool_g[n][:, BS:], kv[n][:, BS:])


def test_deferred_first_token_copy_stays_out_of_graphs():
    """The deferred fetch copies into pinned memory behind an event on the
    engine's stream; inside a graph capture it refuses to run."""
    from dynamo_tpu_torch.engine.core import _FirstToken
    dev = _device()
    tok = torch.tensor([5], dtype=torch.int64, device=dev)
    lp = torch.tensor([-1.5], dtype=torch.float32, device=dev)
    assert _FirstToken(tok, lp).wait() == (5, -1.5)
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(dev)
    with pytest.raises(RuntimeError, match="captured decode graph"):
        with torch.cuda.graph(graph, stream=stream):
            _FirstToken(tok, lp)


async def _serve_back_to_back(overlap: bool, prompts) -> tuple:
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import (FINISH_SENTINEL, EngineCore,
                                              EngineRequest)
    from dynamo_tpu_torch.engine.sampling import SlotSampling
    core = EngineCore(PHI3_CFG, EngineConfig(
        max_model_len=256, kv_block_size=16, num_kv_blocks=64,
        max_num_seqs=4, prefill_buckets=[32, 64], decode_steps_per_dispatch=4,
        lane_prefill_max_tokens=64, overlap_admission_fetch=overlap),
        device="cuda")
    reqs = [EngineRequest(rid=str(i), prompt=p,
                          sampling=SlotSampling(temperature=0.0),
                          max_new_tokens=12, eos_ids=frozenset())
            for i, p in enumerate(prompts)]
    try:
        for r in reqs:                       # posted back to back
            await core.submit(r)
        out = []
        for r in reqs:
            toks = []
            while True:
                item, _ = await r.out_queue.get()
                if item is FINISH_SENTINEL:
                    break
                toks.append(item)
            out.append(toks)
    finally:
        await core.stop()
    return out, core


def test_deferred_admission_fetch_on_the_card():
    # a plain test around asyncio.run: the card's machine may lack the
    # async test plugins
    import asyncio
    _device()
    rng = np.random.default_rng(4)
    pa, pb = (rng.integers(3, 512, size=n).tolist() for n in (25, 21))

    def serve(overlap, prompts):
        return asyncio.run(_serve_back_to_back(overlap, prompts))
    # one request: the same greedy tokens with the fetch deferred or not
    (a_def,), c_def = serve(True, [pa])
    (a_now,), _ = serve(False, [pa])
    assert a_def == a_now and len(a_def) == 12
    assert c_def.program.captures > 0 and not c_def._admissions
    # two back to back: deferred, the second admission finds no ready slot
    # and prefills; fetched at once, it lane-admits
    out, c_def = serve(True, [pa, pb])
    assert c_def.lane_admissions == 0 and all(len(t) == 12 for t in out)
    out, c_now = serve(False, [pa, pb])
    assert c_now.lane_admissions == 1 and all(len(t) == 12 for t in out)


# ---------------------------------------------------------------------------
# the ragged program: a graph per row bucket and sampling variant
# ---------------------------------------------------------------------------

R_MAX_ROWS = 16
R_CAPACITY = B + 2 * R_MAX_ROWS
# the decode bucket: slots 0-2 decode (slot 3 free); the capacity bucket:
# slot 0 decodes, slot 1 continues a 12-row chunk at 33 (a window of 16
# binds), slot 2 starts a 10-row prompt
R_BATCHES = {"decode": ([(0, 5, 20), (1, 6, 33), (2, 7, 5)], []),
             "mixed": ([(0, 5, 20)], [(1, list(range(40, 52)), 33),
                                      (2, list(range(60, 70)), 0)])}
R_BUCKETS = {"decode": B, "mixed": R_CAPACITY}
R_SAMPLING = {"greedy": ([0.0, 0.0, 0.0], [0, 0, 0], [1.0, 0.9, 1.0]),
              "temperature": ([0.0, 0.7, 0.9], [0, 0, 0], [1.0, 1.0, 1.0]),
              "filtered": ([0.0, 0.7, 0.9], [0, 0, 20], [1.0, 0.9, 1.0])}


def _ragged_inputs(kind: str, variant: str = "filtered",
                   tokens_shift: int = 0) -> dict:
    from dynamo_tpu_torch.engine.ragged import build_ragged_batch
    decode_rows, lanes = R_BATCHES[kind]
    batch = build_ragged_batch(R_CAPACITY, B, decode_rows, lanes, R_MAX_ROWS)
    tables = np.zeros((B + 1, M), np.int32)
    for i in LIVE:
        tables[i, :4] = 1 + 4 * i + np.arange(4)
    temp, top_k, top_p = (np.array(v + [0] * (B + 1 - 3), dt)
                          for v, dt in zip(R_SAMPLING[variant],
                                           (np.float32, np.int64,
                                            np.float32)))
    top_p[3:] = 1.0
    return {"tokens": batch.tokens.astype(np.int64) + tokens_shift,
            "positions": batch.positions, "row_slot": batch.row_slot,
            "tables": tables, "seq_starts": batch.seq_starts,
            "seq_counts": batch.seq_counts, "sample_rows": batch.sample_rows,
            "seeds": np.array([0, 7, 9, 0, 0], np.int64),
            "steps": np.array([3, 11, 2, 0, 0], np.int64),
            "temperature": temp, "top_k": top_k, "top_p": top_p}


def _ragged_program(cfg, mode: str, dev):
    """A RaggedProgram over a pool with a prefix in every block: llama
    families in bf16 or int4 over an int8 pool, MLA over a bf16 or an int8
    latent pool."""
    from dynamo_tpu_torch.engine.programs import RaggedProgram
    if cfg.kv_lora_rank:
        from dynamo_tpu_torch.engine.attention import (
            quantize_kv_rows_sections)
        from dynamo_tpu_torch.engine.models import mla
        params = init_params(cfg, 0, dev, torch.bfloat16)
        kv = mla.init_kv_cache(cfg, 16, BS, dev, torch.bfloat16,
                               quantization="int8" if mode == "kv8"
                               else "none")
        g = torch.Generator(device=dev)
        g.manual_seed(1)
        rows = torch.randn((cfg.num_layers * kv["kv"].shape[1], 576),
                           generator=g, device=dev)
        if mode == "kv8":
            rows = quantize_kv_rows_sections(rows, (512, 64))
        kv["kv"][..., :rows.shape[1]] = rows.view(kv["kv"].shape[:2]
                                                  + (-1,))
    else:
        prog, kv = _program(mode, dev, cfg)
        params = prog.params
    return RaggedProgram(params, kv, cfg, BS, B, M, R_CAPACITY, R_MAX_ROWS,
                         0, dev), kv


def _ragged_attention_kernel(cfg, mode: str) -> Optional[str]:
    if cfg.kv_lora_rank:
        return None if mode == "kv8" else "latent_ragged_attention"
    return ("ragged_paged_attention" if mode == "bf16"
            else "ragged_paged_attention_int8")


def _replay_equals_eager(cfg, mode: str, kind: str, variant: str) -> None:
    dev = _device()
    prog, kv = _ragged_program(cfg, mode, dev)
    pool0 = {n: t.clone() for n, t in kv.items()}
    inp = _ragged_inputs(kind, variant)
    live = [0, 1, 2]
    with torch.inference_mode():
        d = prog.dispatch(variant, inp, with_logits=True)
        toks, lps = d.fetch()
        logits = d.logits.clone()
        pool_g = {n: t.clone() for n, t in kv.items()}
        for n, t in kv.items():
            t.copy_(pool0[n])
        e = prog.run_eager(variant, inp, with_logits=True)
        torch.cuda.synchronize()
    rows = R_BUCKETS[kind]
    g = prog.graphs[(rows, variant, True)]
    assert prog.captures == 1 and prog.replays == 1
    assert g.toks.shape == (B + 1,) and logits.shape[0] == B + 1
    attn = _ragged_attention_kernel(cfg, mode)
    if attn is not None:
        assert g.launches[attn] == cfg.num_layers
    if mode == "int4_kv8":
        assert g.launches["lm_head_int8"] == 1
    assert (toks[live] == e.toks.cpu().numpy()[live]).all()
    assert (lps[live] == e.logprobs.cpu().numpy()[live]).all()
    assert torch.equal(logits[live], e.logits[live])
    assert torch.isfinite(logits[live]).all()
    for n in kv:
        assert torch.equal(pool_g[n][:, BS:], kv[n][:, BS:])


@pytest.mark.parametrize("variant", ["greedy", "temperature", "filtered"])
@pytest.mark.parametrize("kind", ["decode", "mixed"])
@pytest.mark.parametrize("mode", ["bf16", "int4_kv8"])
def test_ragged_graph_replay_equals_eager(mode, kind, variant):
    _replay_equals_eager(CFG, mode, kind, variant)


@pytest.mark.parametrize("variant", ["greedy", "temperature", "filtered"])
@pytest.mark.parametrize("kind", ["decode", "mixed"])
@pytest.mark.parametrize("mode", ["bf16", "int4_kv8"])
def test_gemma2_ragged_graph_replay_equals_eager(mode, kind, variant):
    _replay_equals_eager(GEMMA_CFG, mode, kind, variant)


@pytest.mark.parametrize("variant", ["greedy", "temperature", "filtered"])
@pytest.mark.parametrize("kind", ["decode", "mixed"])
@pytest.mark.parametrize("mode", ["bf16", "kv8"])
def test_mla_ragged_graph_replay_equals_eager(mode, kind, variant):
    _replay_equals_eager(MLA_CFG, mode, kind, variant)


def test_ragged_stale_static_inputs_are_caught():
    dev = _device()
    prog, _ = _ragged_program(CFG, "bf16", dev)
    live = [0, 1, 2]
    with torch.inference_mode():
        prog.dispatch("greedy", _ragged_inputs("decode", "greedy"),
                      with_logits=True).fetch()
        other = _ragged_inputs("decode", "greedy", tokens_shift=100)
        upload = prog._upload
        prog._upload = lambda inputs: None      # the planted fault
        try:
            stale = prog.dispatch("greedy", other,
                                  with_logits=True).logits.clone()
        finally:
            prog._upload = upload
        right = prog.run_eager("greedy", other, with_logits=True)
        fresh = prog.dispatch("greedy", other,
                              with_logits=True).logits.clone()
    assert not torch.equal(stale[live], right.logits[live])
    assert torch.equal(fresh[live], right.logits[live])


def test_ragged_chained_dispatches_equal_host_fed():
    """Two pure-decode dispatches, the second chained off the first's
    device tokens (the merge on the stream before the replay), give the
    tokens of the same two dispatches fed from the host."""
    dev = _device()
    prog, kv = _ragged_program(CFG, "bf16", dev)
    pool0 = {n: t.clone() for n, t in kv.items()}
    first = _ragged_inputs("decode", "filtered")
    live = [0, 1, 2]
    starts = first["seq_starts"][live]

    def second(tokens=None):
        nxt = {k: v.copy() for k, v in first.items()}
        nxt["positions"][starts] += 1
        nxt["steps"][live] += 1
        if tokens is not None:
            nxt["tokens"][starts] = tokens
        return nxt

    with torch.inference_mode():
        d1 = prog.dispatch("filtered", first)
        mask = np.zeros(R_CAPACITY, bool)
        mask[starts] = True
        srows = np.zeros(R_CAPACITY, np.int64)
        srows[starts] = live
        chained = prog.dispatch("filtered", {**second(), "chain_mask": mask,
                                             "srows": srows},
                                chain=d1.toks)
        got = (d1.fetch()[0][live], chained.fetch()[0][live])
        for n, t in kv.items():
            t.copy_(pool0[n])
        h1 = prog.dispatch("filtered", first).fetch()[0]
        h2 = prog.dispatch("filtered", second(h1[live])).fetch()[0]
    assert (got[0] == h1[live]).all() and (got[1] == h2[live]).all()
    assert prog.captures == 1 and prog.replays == 4
