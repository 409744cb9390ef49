#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``dynamo_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on error:

1. card: name and power limit (nvidia-smi), torch's device name;
2. build: compile the CUDA kernels from ``dynamo_tpu_torch/csrc`` and print
   nvcc's register / shared-memory / spill lines;
3. kernels: hold each kernel against its plain PyTorch version on the card
   at the Llama-3-8B shapes, in bf16, and time kernel, plain version,
   ``scaled_dot_product_attention`` as the library yardstick, and the
   card's bound for the same work;
4. model: the 8B geometry (random weights from a seed, on the card) runs
   one prefill and 4 decode steps through the kernels and through the
   plain versions; the logits must agree;
5. serve: the port's HTTP server answers concurrent, streamed,
   prefix-cached and sampled ``/v1/completions`` at the 8B width, with the
   kernels' launch counts taken over this phase alone.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
L2_FLUSH_BYTES = 256 << 20     # 5x the H100's 50 MB L2

KV_BLOCK = 16
MAX_MODEL_LEN = 2048


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3, cold: bool = False) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events).

    ``cold``: overwrite a buffer larger than the 50 MB L2 cache before each
    call and time each call alone, for inputs the main path finds cold
    (decode reads a layer's KV after the other layers' weights have passed
    through L2)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not cold:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    pairs = []
    for _ in range(iters):
        flush.zero_()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        fn()
        ev[1].record()
        pairs.append(ev)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound(bytes_moved: float, flops: float) -> tuple:
    t_bytes = bytes_moved / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# Each output row (one query row of one head, Dh values) is a convex
# combination of N(0, 1) value rows, so its size falls as 1/sqrt(keys seen):
# O(1) for a row that sees a few keys, ~0.04 for one that sees 2048. A row's
# error is therefore measured against that row's own scale: max |kernel -
# plain| over the row divided by the RMS of the plain row. The plain
# versions round scores to bf16 before the softmax (the kernels keep them in
# f32), both round probabilities and outputs to bf16, so a right kernel
# stays within a few bf16 ulps (2^-8 relative) of the row's largest values.
# A kernel that leaves out the last 64 keys (one KV tile of K1) or reads a
# wrong block for the last table entry of the longest slot (K3) moves the
# rows that see those keys by a sizeable fraction of their RMS. Each case
# below plants such a fault and fails the run unless the limit rejects it.
# The readings on the card, right and faulty, are in PERF.md (Findings).
KERNEL_ROW_REL_TOL = 0.1
FAULT_KEYS = 64                 # K1's KV tile


def row_errors(out, ref, rows) -> tuple:
    """(max abs error, max over the selected rows of max |out - ref| / RMS
    of the plain row); the last axis is Dh."""
    d = (out.float() - ref.float())[rows]
    r = ref.float()[rows]
    rel = d.abs().amax(-1) / r.pow(2).mean(-1).sqrt()
    return d.abs().max().item(), rel.max().item()


def check_flash_prefill(cfg, dev) -> dict:
    import torch
    import torch.nn.functional as F
    from dynamo_tpu_torch.engine.attention import flash_prefill_ref
    from dynamo_tpu_torch.engine.kernels import flash_prefill_cuda
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S = MAX_MODEL_LEN                   # the whole block table, M * 16
    scale = Dh ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cases = []
    # (T, start_pos, true_len): fresh prompt, prefix hit, padded bucket
    for T, start, true_len in ((512, 0, 512), (256, 1024, 256),
                               (512, 0, 300)):
        seq_len = start + true_len
        q = torch.randn((T, H, Dh), generator=gen, device=dev).bfloat16()
        k = torch.randn((S, KVH, Dh), generator=gen, device=dev).bfloat16()
        v = torch.randn((S, KVH, Dh), generator=gen, device=dev).bfloat16()
        out = flash_prefill_cuda(q, k, v, scale=scale, start_pos=start,
                                 seq_len=seq_len)
        ref = flash_prefill_ref(q, k, v, scale=scale, start_pos=start,
                                seq_len=seq_len)
        # planted fault: the last KV tile left out
        fault = flash_prefill_cuda(q, k, v, scale=scale, start_pos=start,
                                   seq_len=seq_len - FAULT_KEYS)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise RuntimeError(f"flash_prefill T={T} start={start}: "
                               f"non-finite output")
        err, rel = row_errors(out, ref, slice(0, true_len))
        _, fault_rel = row_errors(fault, ref, slice(0, true_len))
        ms = time_ms(lambda: flash_prefill_cuda(
            q, k, v, scale=scale, start_pos=start, seq_len=seq_len))
        plain_ms = time_ms(lambda: flash_prefill_ref(
            q, k, v, scale=scale, start_pos=start, seq_len=seq_len), iters=5)
        qs = q.transpose(0, 1)[None].contiguous()             # [1, H, T, Dh]
        ks = k[:seq_len].transpose(0, 1)[None].contiguous()   # [1, KVH, s, Dh]
        vs = v[:seq_len].transpose(0, 1)[None].contiguous()
        pos = start + torch.arange(T, device=dev)
        mask = torch.arange(seq_len, device=dev)[None, :] <= pos[:, None]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=scale, enable_gqa=True))
        pairs = sum(min(start + t + 1, seq_len) for t in range(T))
        flops = 4.0 * H * Dh * pairs
        nbytes = 2.0 * (2 * T * H * Dh + 2 * seq_len * KVH * Dh)
        b_ms, b_by = bound(nbytes, flops)
        case = {"T": T, "start_pos": start, "true_len": true_len,
                "max_abs_err": err, "max_row_rel_err": rel,
                "fault_row_rel_err": fault_rel, "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                "bound_by": b_by}
        log(f"flash_prefill {json.dumps(case)}")
        check_limit(f"flash_prefill T={T} start={start}", rel, fault_rel)
        cases.append(case)
    return {"name": "flash_prefill", "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/flash_prefill.cu",
            "replaces": "dynamo_tpu/engine/attention.py:220",
            "row_rel_tolerance": KERNEL_ROW_REL_TOL, **cases[0],
            "cases": cases}


def check_limit(what: str, rel: float, fault_rel: float) -> None:
    if not rel <= KERNEL_ROW_REL_TOL:
        raise RuntimeError(f"{what}: row-relative error {rel} > "
                           f"{KERNEL_ROW_REL_TOL}")
    if not fault_rel > KERNEL_ROW_REL_TOL:
        raise RuntimeError(f"{what}: the planted fault ({fault_rel}) passes "
                           f"the limit {KERNEL_ROW_REL_TOL}")


def check_paged_attention(cfg, dev) -> dict:
    import torch
    import torch.nn.functional as F
    from dynamo_tpu_torch.engine.attention import (flat_token_indices,
                                                   paged_attention_ref)
    from dynamo_tpu_torch.engine.kernels import paged_attention_cuda
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bs, M = KV_BLOCK, MAX_MODEL_LEN // KV_BLOCK
    seq_lens_l = [1, 15, 16, 17, 255, 1000, 2048, 0]
    B = len(seq_lens_l)
    num_blocks = B * M + 1
    scale = Dh ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    k_cache = torch.randn((num_blocks * bs, KVH * Dh), generator=gen,
                          device=dev).bfloat16()
    v_cache = torch.randn((num_blocks * bs, KVH * Dh), generator=gen,
                          device=dev).bfloat16()
    perm = (torch.randperm(num_blocks - 1, generator=gen, device=dev)
            + 1).to(torch.int32)
    tables = torch.zeros((B, M), dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(seq_lens_l):
        nb = -(-n // bs)
        tables[b, :nb] = perm[used:used + nb]
        used += nb
    seq_lens = torch.tensor(seq_lens_l, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, Dh), generator=gen, device=dev).bfloat16()
    out = paged_attention_cuda(q, k_cache, v_cache, tables, seq_lens,
                               block_size=bs, scale=scale)
    ref = paged_attention_ref(q, k_cache, v_cache, tables, seq_lens,
                              block_size=bs, scale=scale)
    # planted fault: the longest slot's last table entry read as the trash
    # block (which holds other random rows here)
    longest = max(range(B), key=lambda b: seq_lens_l[b])
    bad_tables = tables.clone()
    bad_tables[longest, (seq_lens_l[longest] - 1) // bs] = 0
    fault = paged_attention_cuda(q, k_cache, v_cache, bad_tables, seq_lens,
                                 block_size=bs, scale=scale)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError("paged_attention: non-finite output")
    if out[seq_lens_l.index(0)].abs().max().item() != 0.0:
        raise RuntimeError("paged_attention: zero-length slot is not zero")
    live = seq_lens > 0
    err, rel = row_errors(out, ref, live)
    _, fault_rel = row_errors(fault, ref, live)
    # each slot's own reading, for the record
    slot_rel = [row_errors(out, ref, b)[1] if n else None
                for b, n in enumerate(seq_lens_l)]
    # timed with a cold L2: in a decode step the KV of a layer was last
    # touched a whole step earlier
    ms = time_ms(lambda: paged_attention_cuda(
        q, k_cache, v_cache, tables, seq_lens, block_size=bs, scale=scale),
        cold=True)
    plain_ms = time_ms(lambda: paged_attention_ref(
        q, k_cache, v_cache, tables, seq_lens, block_size=bs, scale=scale),
        cold=True)
    idx = flat_token_indices(tables, bs)
    kg = k_cache[idx].reshape(B, M * bs, KVH, Dh).transpose(1, 2).contiguous()
    vg = v_cache[idx].reshape(B, M * bs, KVH, Dh).transpose(1, 2).contiguous()
    mask = (torch.arange(M * bs, device=dev)[None, :]
            < seq_lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kg, vg, attn_mask=mask, scale=scale, enable_gqa=True), cold=True)
    total = sum(seq_lens_l)
    nbytes = (2.0 * total * KVH * Dh * 2 + 2 * 2.0 * B * H * Dh
              + 4.0 * B * M + 4.0 * B)
    flops = 4.0 * H * Dh * total
    b_ms, b_by = bound(nbytes, flops)
    case = {"B": B, "seq_lens": seq_lens_l, "max_abs_err": err,
            "max_row_rel_err": rel, "slot_row_rel_err": slot_rel,
            "fault_row_rel_err": fault_rel, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    log(f"paged_attention {json.dumps(case)}")
    check_limit("paged_attention", rel, fault_rel)
    return {"name": "paged_attention", "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
            "replaces": "dynamo_tpu/engine/attention.py:743",
            "row_rel_tolerance": KERNEL_ROW_REL_TOL, **case}


# ---------------------------------------------------------------------------
# phase 4: the 8B model through the kernels and through the plain versions
# ---------------------------------------------------------------------------

# bf16 logits of a 32-layer random-weight model, as max |kernel - plain|
# over max |plain|: the two paths round attention at different points in
# every layer (the kernels keep scores in f32), and the differences ride the
# residual stream through 32 bf16 layers. The same comparison is read with a
# planted fault in each kernel (the prefill's last KV tile left out; the
# decode step's last table entry read as the trash block); the limit sits
# between the right and the faulty readings (PERF.md, Findings).
MODEL_REL_TOL = 5e-2


class attention_impl:
    """Context manager: the llama module calls ``prefill`` and ``decode`` in
    place of its attention functions (which launch the kernels on CUDA
    tensors)."""

    def __init__(self, prefill, decode):
        self._impl = (prefill, decode)

    def __enter__(self):
        from dynamo_tpu_torch.engine.models import llama
        self._saved = (llama.flash_prefill, llama.paged_attention)
        llama.flash_prefill, llama.paged_attention = self._impl
        return self

    def __exit__(self, *exc):
        from dynamo_tpu_torch.engine.models import llama
        llama.flash_prefill, llama.paged_attention = self._saved


def prefill_without_last_tile(q, k, v, *, scale, start_pos, seq_len, **_):
    """K1 with a planted fault: the last KV tile left out."""
    from dynamo_tpu_torch.engine.kernels import flash_prefill_cuda
    return flash_prefill_cuda(q, k, v, scale=scale, start_pos=start_pos,
                              seq_len=max(seq_len - FAULT_KEYS, start_pos + 1))


def decode_without_last_block(q, k_cache, v_cache, block_tables, seq_lens, *,
                              block_size, scale, **_):
    """K3 with a planted fault: each slot's last table entry read as the
    trash block."""
    import torch
    from dynamo_tpu_torch.engine.kernels import paged_attention_cuda
    tables = block_tables.clone()
    last = (seq_lens.long() - 1).clamp(min=0) // block_size
    tables[torch.arange(tables.shape[0], device=tables.device), last] = 0
    return paged_attention_cuda(q, k_cache, v_cache, tables, seq_lens,
                                block_size=block_size, scale=scale)


def profile_decode_step(params, kv, cfg, table, B: int, M: int,
                        pos: int) -> dict:
    """Where one decode step's time goes (8B, one live slot of B): host
    wall time of ``decode_forward`` against the device time the profiler
    attributes to kernels, and the top kernels by device time."""
    import torch
    from dynamo_tpu_torch.engine.models import llama
    dev = kv["k"].device
    toks = torch.zeros((B,), dtype=torch.long, device=dev)
    pos_t = torch.zeros((B,), dtype=torch.int32, device=dev)
    pos_t[0] = pos
    tables = torch.zeros((B, M), dtype=torch.int32, device=dev)
    tables[0] = table

    def step():
        return llama.decode_forward(params, kv, toks, pos_t, tables, cfg,
                                    KV_BLOCK)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    n = 5
    t0 = time.monotonic()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.monotonic() - t0) / n
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    rows = []   # device kernels only: operator rows repeat their time
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((t / 1e3, e.key))
    rows.sort(reverse=True)
    device_ms = sum(t for t, _ in rows)
    return {"wall_ms": wall_ms,
            "device_ms": device_ms if rows else "not measured",
            "device_busy_share": device_ms / wall_ms if rows else None,
            "top_kernels_ms": [[k[:60], t] for t, k in rows[:6]]}


def check_model(cfg, dev, seed: int) -> dict:
    import torch
    from dynamo_tpu_torch.engine.models import llama
    from dynamo_tpu_torch.engine.weights import init_params
    t0 = time.monotonic()
    params = init_params(cfg, seed, dev, torch.bfloat16)
    torch.cuda.synchronize()
    log(f"model: 8B random weights on the card in "
        f"{time.monotonic() - t0:.1f} s")
    bs, M, B = KV_BLOCK, MAX_MODEL_LEN // KV_BLOCK, 8
    prompt_len, bucket, steps = 300, 512, 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    tokens = torch.randint(3, cfg.vocab_size, (bucket,), generator=gen,
                           device=dev)
    table = torch.zeros((M,), dtype=torch.int32, device=dev)
    n_blocks = -(-(prompt_len + steps + 1) // bs)   # + the profiled step
    table[:n_blocks] = torch.arange(1, 1 + n_blocks, device=dev)

    def run():
        kv = state["kv"] = llama.init_kv_cache(cfg, M + 1, bs, dev,
                                               torch.bfloat16)
        out = [llama.prefill_forward(params, kv, tokens, table, 0,
                                     prompt_len, cfg, bs)[None]]
        toks = torch.zeros((B,), dtype=torch.long, device=dev)
        pos = torch.zeros((B,), dtype=torch.int32, device=dev)
        tables = torch.zeros((B, M), dtype=torch.int32, device=dev)
        tables[0] = table
        for i in range(steps):
            toks[0] = forced[i]
            pos[0] = prompt_len + i
            out.append(llama.decode_forward(params, kv, toks, pos, tables,
                                            cfg, bs)[:1])
        return torch.cat(out)                      # [1 + steps, V]

    def compare(logits) -> dict:
        err = (logits - ref).abs().max().item()
        agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
        return {"max_abs_err": err, "rel_err": err / spread,
                "argmax_agreement": agree}

    from dynamo_tpu_torch.engine import attention
    state = {}
    with torch.inference_mode():
        forced = torch.randint(3, cfg.vocab_size, (steps,), generator=gen,
                               device=dev)
        with attention_impl(attention.flash_prefill_ref,
                            attention.paged_attention_ref):
            ref = run()
        faults = {}
        with attention_impl(prefill_without_last_tile,
                            attention.paged_attention):
            faults["prefill_last_tile"] = run()
        with attention_impl(attention.flash_prefill,
                            decode_without_last_block):
            faults["decode_last_block"] = run()
        got = run()
        profile = profile_decode_step(params, state["kv"], cfg, table, B, M,
                                      prompt_len + steps)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all() or not torch.isfinite(ref).all():
        raise RuntimeError("model: non-finite logits")
    spread = ref.abs().max().item()
    res = {"max_abs_ref": spread, **compare(got),
           "planted_faults": {k: compare(v) for k, v in faults.items()},
           "decode_step": profile}
    log(f"model {json.dumps(res)}")
    del params
    torch.cuda.empty_cache()
    if not res["rel_err"] <= MODEL_REL_TOL:
        raise RuntimeError(f"model: kernel and plain logits differ by "
                           f"{res['rel_err']} x {spread} > {MODEL_REL_TOL}")
    for k, v in res["planted_faults"].items():
        if not v["rel_err"] > MODEL_REL_TOL:
            raise RuntimeError(f"model: the planted fault {k} "
                               f"({v['rel_err']}) passes the limit "
                               f"{MODEL_REL_TOL}")
    return res


# ---------------------------------------------------------------------------
# phase 5: the HTTP server at the 8B width
# ---------------------------------------------------------------------------


def write_model_dir(path: str, cfg) -> None:
    """config.json of the 8B geometry + a SentencePiece tokenizer covering
    all of its vocab: control pieces, the 256 byte pieces, some letters and
    words, then synthetic pieces up to the vocab size."""
    from dynamo_tpu_torch.llm.sp_model import (BYTE, CONTROL, NORMAL,
                                               UNKNOWN, write_model_proto)
    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL),
              ("</s>", 0.0, CONTROL)]
    pieces += [(f"<0x{b:02X}>", 0.0, BYTE) for b in range(256)]
    words = ("the of and to in is that for it as with was on be by at this "
             "from are or an which one all would there their what so up "
             "out if about who get go me when make can like time no just "
             "him know take people into year your good some could them see "
             "other than then now look only come its over think also back "
             "after use two how our work first well way even new want "
             "because any these give day most us").split()
    pieces += [("▁" + w, -2.0, NORMAL) for w in words]
    pieces += [(c, -6.0, NORMAL) for c in
               "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
               "0123456789.,;:!?'\"-()▁"]
    i = 0
    while len(pieces) < cfg.vocab_size:
        pieces.append((f"▁t{i}", -12.0, NORMAL))
        i += 1
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.model"), "wb") as f:
        f.write(write_model_proto(pieces, unk_id=0, bos_id=1, eos_id=2))
    hf = {"model_type": "llama", "vocab_size": cfg.vocab_size,
          "hidden_size": cfg.hidden_size,
          "intermediate_size": cfg.intermediate_size,
          "num_hidden_layers": cfg.num_layers,
          "num_attention_heads": cfg.num_heads,
          "num_key_value_heads": cfg.num_kv_heads,
          "head_dim": cfg.head_dim,
          "max_position_embeddings": cfg.max_position_embeddings,
          "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
          "tie_word_embeddings": False, "bos_token_id": 1,
          "eos_token_id": 2}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)


def http_completion(port: int, body: dict, timeout: float = 600) -> dict:
    """POST /v1/completions; for ``stream`` bodies, parse the SSE events and
    time each one. Returns the parsed result plus client-side timings."""
    import http.client
    t0 = time.monotonic()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {resp.read()[:500]!r}")
        if not body.get("stream"):
            out = json.loads(resp.read())
            return {"response": out, "latency_s": time.monotonic() - t0}
        chunks, times, done = [], [], False
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                done = True
                break
            chunks.append(json.loads(line[6:]))
            times.append(time.monotonic() - t0)
        return {"chunks": chunks, "times": times, "done": done,
                "latency_s": time.monotonic() - t0}
    finally:
        conn.close()


def check_stream(name: str, res: dict, max_tokens: int,
                 want_usage: bool) -> dict:
    if not res["done"]:
        raise RuntimeError(f"{name}: SSE stream did not end in [DONE]")
    usage = [c["usage"] for c in res["chunks"] if c.get("usage")]
    finish = [c["choices"][0]["finish_reason"] for c in res["chunks"]
              if c.get("choices") and c["choices"][0].get("finish_reason")]
    if finish != ["length"]:
        raise RuntimeError(f"{name}: finish reasons {finish}")
    if want_usage and (not usage
                       or usage[-1]["completion_tokens"] != max_tokens):
        raise RuntimeError(f"{name}: usage {usage} != {max_tokens} tokens")
    if not want_usage and usage:
        raise RuntimeError(f"{name}: usage sent without include_usage")
    t = [tm for c, tm in zip(res["chunks"], res["times"])
         if c.get("choices") and c["choices"][0].get("text")]
    itl = [b - a for a, b in zip(t, t[1:])]
    return {"ttft_ms": 1e3 * t[0] if t else None,
            "itl_ms_mean": 1e3 * sum(itl) / len(itl) if itl else None,
            "itl_ms_max": 1e3 * max(itl) if itl else None,
            "text_chunks": len(t), "latency_s": res["latency_s"]}


def check_unary(name: str, res: dict, max_tokens: int) -> dict:
    out = res["response"]
    ch = out.get("choices") or []
    if (out.get("object") != "text_completion" or len(ch) != 1
            or not isinstance(ch[0].get("text"), str)
            or ch[0].get("finish_reason") != "length"
            or out.get("usage", {}).get("completion_tokens") != max_tokens):
        raise RuntimeError(f"{name}: malformed response {out}")
    return {"latency_s": res["latency_s"], "text": ch[0]["text"][:60]}


def serve_phase(cfg, seed: int, card: str) -> dict:
    """Serve from a temporary model directory (8B config + tokenizer)."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="dtt-8b-") as tmp:
        model_dir = os.path.join(tmp, "llama3-8b-random")
        write_model_dir(model_dir, cfg)
        return _serve(cfg, seed, card, model_dir)


def _serve(cfg, seed: int, card: str, model_dir: str) -> dict:
    import asyncio
    import threading
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from dynamo_tpu_torch.engine import kernels
    from dynamo_tpu_torch.launch import run as launcher
    args = launcher.build_parser().parse_args(
        ["in=http", "out=torch", "--model-path", model_dir,
         "--random-weights", "--http-host", "127.0.0.1",
         "--http-port", "0", "--max-model-len", str(MAX_MODEL_LEN),
         "--kv-block-size", str(KV_BLOCK), "--num-kv-blocks", "2048",
         "--max-num-seqs", "8", "--device", "cuda"])
    launcher.parse_io(args.io)
    t0 = time.monotonic()
    core = launcher.build_core(args)
    log(f"serve: engine core built in {time.monotonic() - t0:.1f} s")
    ready = threading.Event()
    loop = asyncio.new_event_loop()
    holder = {}

    def runner():
        asyncio.set_event_loop(loop)
        holder["task"] = loop.create_task(launcher.serve(args, core, ready))
        try:
            loop.run_until_complete(holder["task"])
        except asyncio.CancelledError:
            pass
        except BaseException as e:  # noqa: BLE001 — reported below
            holder["error"] = e
        finally:
            ready.set()          # never leave the main thread waiting

    th = threading.Thread(target=runner, name="http-server", daemon=True)
    th.start()
    if not ready.wait(300) or "error" in holder:
        raise RuntimeError(f"serve: server not ready: {holder.get('error')}")
    port = args.http_port
    name = launcher.model_name(args)
    rng = np.random.default_rng(seed)
    mk = lambda n: rng.integers(259, cfg.vocab_size, size=n).tolist()  # noqa: E731
    max_tokens = 32
    greedy = {"model": name, "max_tokens": max_tokens, "temperature": 0,
              "nvext": {"ignore_eos": True}}
    prompts = {"p100": mk(100), "p700": mk(700), "p1500": mk(1500),
               "p1900": mk(1900)}
    report = {}
    try:
        kernels.reset_launch_counts()
        pool = core.kv_manager.pool
        # four concurrent greedy streams of mixed prompt lengths
        with ThreadPoolExecutor(4) as ex:
            futs = {k: ex.submit(http_completion, port, {
                **greedy, "prompt": p, "stream": True,
                "stream_options": {"include_usage": True}})
                for k, p in prompts.items()}
            for k, f in futs.items():
                report[k] = check_stream(k, f.result(), max_tokens, True)
        # one more SSE stream, usage not requested
        report["sse"] = check_stream("sse", http_completion(port, {
            **greedy, "prompt": mk(200), "stream": True}), max_tokens, False)
        # a repeated prompt: its full blocks hit the prefix cache, so the
        # prefill runs only the tail, at start_pos > 0
        hits0 = pool.match_hits
        report["prefix_repeat"] = check_unary("prefix_repeat", http_completion(
            port, {**greedy, "prompt": prompts["p700"]}), max_tokens)
        hit_blocks = pool.match_hits - hits0
        if hit_blocks < 700 // KV_BLOCK:
            raise RuntimeError(f"prefix_repeat: {hit_blocks} prefix blocks "
                               f"hit, expected {700 // KV_BLOCK}")
        report["prefix_repeat"]["hit_blocks"] = hit_blocks
        # a sampled text prompt
        report["sampled_text"] = check_unary("sampled_text", http_completion(
            port, {"model": name, "prompt": "the time of the people who "
                   "work to make a good day", "max_tokens": max_tokens,
                   "temperature": 0.7, "top_p": 0.9, "seed": 1,
                   "nvext": {"ignore_eos": True}}), max_tokens)
        launches = {k: v.launches for k, v in kernels.KERNELS.items()}
    finally:
        if "task" in holder:
            loop.call_soon_threadsafe(holder["task"].cancel)
        th.join(120)
    if th.is_alive():
        raise RuntimeError("serve: server thread did not stop")
    loop.close()
    for k, v in report.items():
        log(f"request {k} {json.dumps(v)} [{card}]")
    log(f"serve: launches {json.dumps(launches)}")
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"serve: kernel {k} was never launched")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from dynamo_tpu_torch.engine import kernels
        from dynamo_tpu_torch.engine.config import bench_model_config
    except ImportError as e:
        print(f"chip_smoke: the dynamo_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2

    # 1. card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    dev = torch.device("cuda:0")

    # 2. build
    t0 = time.monotonic()
    kernels.LIBRARY.get()
    log(f"build: {time.monotonic() - t0:.1f} s")
    for block in kernels.LIBRARY.build_log:
        for line in block.splitlines():
            if (line.startswith("==") or "ptxas info" in line
                    or "spill" in line):
                log(line)

    # 3. kernels at the 8B shapes
    cfg = bench_model_config("8b")
    entries = [check_flash_prefill(cfg, dev), check_paged_attention(cfg, dev)]

    # 4. the model through the kernels vs the plain versions
    seed = 0
    check_model(cfg, dev, seed)

    # 5. serving; the launch counts cover this phase alone
    launches = serve_phase(cfg, seed, card)
    for e in entries:
        e["launches"] = launches[e["name"]]
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
