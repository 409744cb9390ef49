#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``dynamo_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on error:

1. card: name and power limit (nvidia-smi), torch's device name;
2. build: compile the CUDA kernels from ``dynamo_tpu_torch/csrc`` (five
   sources, one nvcc each, all started together) and print nvcc's
   register / shared-memory / spill lines;
3. kernels: hold each kernel against its plain PyTorch version on the card
   at the Llama-3-8B shapes, with planted faults that the limit must
   reject, and time kernel, plain version, one PyTorch call as the library
   yardstick, and the card's bound for the same work (K1 on a fresh
   prompt, a prefix hit, a padded bucket and the 1900-token prompt of
   phase 4, K2 on five ring hops with its m and l held to limits of their
   own, K3 bf16 and int8 on a mixed 8-slot batch with repeated bits and a
   planted fault in its split merge, on and around the split boundaries,
   and on a full batch of 8 x 2048 keys, K5 at 1, 2, 4 and 8 rows with
   repeated bits, K6 at the four 8B layer shapes for 1, 8, 16, 17 and 512
   rows with repeated bits and, where it splits the contraction, its own
   partials merged in plain PyTorch and a planted fault that leaves one
   split out of that merge, K4
   bf16 and int8 on a ragged mix of prefill chunks and decode rows with
   repeated bits and a planted fault in its split merge, on and around
   the split boundaries, and on a full ragged batch of 8 slots at 2048
   keys); then the ring over 2 and 4 shards on the one card against K1
   over the whole sequence, with a dropped hop planted;
4. model: the 8B geometry (random weights from a seed, on the card) runs
   one prefill and 4 decode steps through the kernels and through the
   plain versions, in three modes: bf16, int4 weights over an int8 KV
   pool, and int8 weights over a bf16 pool; the logits must agree, and a
   planted fault in each kernel of the mode must not; one decode step of
   each mode is profiled, and the sampler's noise is timed. In bf16 and
   int4 + int8 KV the same weights then run two ragged dispatches (the
   second mixes a decode row, a chunk continuing a prefix and a fresh
   chunk) through K4 and through the plain versions, with a planted K4
   fault, and one pure-decode ragged dispatch of 8 rows is profiled beside
   the split decode step over the same rows (device time and kernel count
   of the step, with K3's, K4's, K5's and K6's share). The bf16 weights
   also run the sequence-parallel prefill (sp = 2 on the one card, 1900 of
   2048 tokens) through K2 against the whole-prompt prefill through K1,
   over a bf16 and an int8 pool, with a dropped ring hop planted, and both
   prefills are timed and profiled (K1's and K2's device time among them).
   In each mode the decode program (``engine/programs.py``) replays its
   CUDA graph at K = 1 and K = 8 against the same program run eagerly
   (live slots' tokens, logprobs and logits and the pool, bit for bit),
   K = 8 against eight K = 1 dispatches (the same tokens), a planted
   fault (static inputs left stale) must be caught, and wall / device /
   launches per token are read for the eager step, the graphed K = 1
   step and the K = 8 dispatch;
5. serve: the port's HTTP server answers concurrent, streamed,
   prefix-cached and sampled ``/v1/completions`` at the 8B width in bf16,
   with the kernels' launch counts taken over this phase alone;
5b. serve quantized: the same server with ``--quantization int4
   --kv-quantization int8`` answers concurrent greedy, streamed and seeded
   sampled completions, with the launch counts taken over this phase
   alone;
5c. serve ragged: phase 5's requests with ``--ragged``: every admission
   and decode step goes through K4 (K1 and K3 launch 0 times), some
   dispatches mix prefill and decode rows, a seeded request gives the
   same text twice, and the ragged metrics are printed;
5d. serve ragged quantized: phase 5b's requests with ``--ragged
   --quantization int4 --kv-quantization int8``, checked as 5c;
5e. serve sp: phase 5's requests on a server whose mesh places sp = 2
   shards on the one card: the 700-, 1500- and 1900-token prompts prefill
   through the ring (K2), the others through K1; a seeded request gives
   the same text twice; each stream's TTFT/ITL is printed beside phase
   5's, with the share of greedy tokens the two servers agree on;
5f. serve dispatch modes: phase 5b's requests, a 1500-token prompt and a
   64-token stream posted while the others decode, on a server with
   ``--decode-steps-per-dispatch 8 --decode-dispatch-pipeline
   --lane-prefill-max-tokens 128 --prefill-chunk 512``: some admission
   rides the batch as a lane, the 700-, 1500- and 1900-token prompts
   prefill in 2, 3 and 4 chunks (32 K1 launches a chunk), the host fetches
   fewer times than a quarter of the decode tokens, a seeded request gives
   the same text twice, and each stream's TTFT/ITL is printed beside
   5b's, with the share of greedy tokens the two agree on.

Every split-path decode dispatch of phases 5-5f replays a captured graph;
its launches count through the program's replay accounting.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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
SP_TRUE_LEN = 1900             # the sequence-parallel prompt, in a 2048 bucket


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
    # (T, start_pos, true_len): fresh prompt, prefix hit, padded bucket,
    # and the whole-prompt prefill of phase 4 (1900 tokens in a 2048 bucket)
    for T, start, true_len in ((512, 0, 512), (256, 1024, 256),
                               (512, 0, 300), (MAX_MODEL_LEN, 0, SP_TRUE_LEN)):
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


# K2 returns m and l besides the unnormalized acc, and the ring merges them
# as numbers, so they get limits of their own over the rows that see a key:
# |dm| (natural units) and |dl| / l. Kernel and plain version take the same
# exact bf16 products summed in f32 and differ by summation order and the
# kernel's base-2 detour (~1e-5). The planted faults: m returned in the
# kernel's base-2 units (off by 0.44 m), and the last 64-key tile the rows
# can see left out (l off by that tile's share of the row).
PARTIAL_M_ATOL = 1e-3
PARTIAL_L_RTOL = 1e-3
LOG2E = 1.4426950408889634
# K2's ring hops at the 8B shapes, Tl = Sl = 1024 (a 2048-token bucket over
# sp = 2), as (hop, start_pos, seq_len): shard 0's and 1's own chunk, shard
# 1 on shard 0's chunk, shard 0 on shard 1's chunk (dead: every key after
# every query), a padded tail, and a chunk that some rows of one CTA see and
# others do not
PARTIAL_HOPS = [("diagonal", 0, 1024), ("past", 1024, 1024),
                ("dead", -1024, 1024), ("tail", 0, 700),
                ("straddle", -100, 1024)]


def partial_errors(got, ref, seen) -> tuple:
    """(row-relative error of acc / l, max |dm|, max |dl| / l) over the
    (row, head) pairs ``seen`` that see a key."""
    (acc, m, l), (racc, rm, rl) = got, ref
    _, rel = row_errors(acc / l[..., None], racc / rl[..., None], seen)
    return (rel, (m - rm)[seen].abs().max().item(),
            ((l - rl).abs() / rl)[seen].max().item())


def sdpa_with_lse(q, k, v, mask, scale):
    """The library yardstick of K2: one PyTorch call that yields the
    attention output and its log-sum-exp (m + log l),
    ``aten._scaled_dot_product_efficient_attention`` with an additive mask
    broadcast over the heads, over K/V expanded to every query head
    beforehand."""
    import torch
    H, KVH = q.shape[1], k.shape[1]
    q4 = q.transpose(0, 1)[None].contiguous()
    k4, v4 = (x.repeat_interleave(H // KVH, dim=1).transpose(0, 1)[None]
              .contiguous() for x in (k, v))
    bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device)
    bias.masked_fill_(~mask, float("-inf"))
    bias = bias[None, None].expand(1, H, *mask.shape)
    return lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
        q4, k4, v4, bias, True, 0.0, False, scale=scale)


def check_flash_prefill_partial(cfg, dev) -> dict:
    """K2 on PARTIAL_HOPS at the 8B shapes: acc / l row-relative, |dm| and
    |dl| / l against the plain version on the rows that see a key, exact
    zeros and NEG_INF on the rows that do not, two planted faults."""
    import torch
    from dynamo_tpu_torch.engine.attention import (NEG_INF,
                                                   flash_prefill_partial_ref)
    from dynamo_tpu_torch.engine.kernels import flash_prefill_partial_cuda
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Tl = MAX_MODEL_LEN // 2
    scale = Dh ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    q = torch.randn((Tl, H, Dh), generator=gen, device=dev).bfloat16()
    k = torch.randn((Tl, KVH, Dh), generator=gen, device=dev).bfloat16()
    v = torch.randn((Tl, KVH, Dh), generator=gen, device=dev).bfloat16()
    cases = []
    for hop, start, seq_len in PARTIAL_HOPS:
        kw = dict(scale=scale, start_pos=start, seq_len=seq_len)
        got = flash_prefill_partial_cuda(q, k, v, **kw)
        ref = flash_prefill_partial_ref(q, k, v, **kw)
        pos = start + torch.arange(Tl, device=dev)
        seen = (pos >= 0)[:, None].expand(Tl, H)
        keys = max(0, min(seq_len, start + Tl))     # the keys any row sees
        torch.cuda.synchronize()
        if not all(torch.isfinite(x).all() for x in got):
            raise RuntimeError(f"flash_prefill_partial {hop}: non-finite "
                               f"output")
        case = {"hop": hop, "start_pos": start, "seq_len": seq_len,
                "live_rows": int(seen[:, 0].sum())}
        dead = ~seen
        if dead.any():
            exact = bool((got[0][dead] == 0).all() and (got[2][dead] == 0).all()
                         and (got[1][dead] == NEG_INF).all())
            case["dead_rows_exact"] = exact
            if not exact:
                raise RuntimeError(f"flash_prefill_partial {hop}: a row that "
                                   f"sees no key is not (0, NEG_INF, 0)")
        if seen.any():
            fault = flash_prefill_partial_cuda(
                q, k, v, scale=scale, start_pos=start,
                seq_len=keys - FAULT_KEYS)
            rel, dm, dl = partial_errors(got, ref, seen)
            _, base2_dm, _ = partial_errors(
                (got[0], got[1] * LOG2E, got[2]), ref, seen)
            tile_rel, _, tile_dl = partial_errors(fault, ref, seen)
            del fault
            case.update({
                "max_abs_err": (got[0] - ref[0])[seen].abs().max().item(),
                "max_row_rel_err": rel, "max_m_abs_err": dm,
                "max_l_rel_err": dl, "fault_base2_m_abs_err": base2_dm,
                "fault_last_tile_row_rel_err": tile_rel,
                "fault_last_tile_l_rel_err": tile_dl})
            check_limit(f"flash_prefill_partial {hop} (last tile)", rel,
                        tile_rel)
            if not (dm <= PARTIAL_M_ATOL and dl <= PARTIAL_L_RTOL):
                raise RuntimeError(f"flash_prefill_partial {hop}: |dm| {dm} "
                                   f"or |dl|/l {dl} over its limit")
            if not (base2_dm > PARTIAL_M_ATOL and tile_dl > PARTIAL_L_RTOL):
                raise RuntimeError(f"flash_prefill_partial {hop}: a planted "
                                   f"fault passes the m/l limits ({base2_dm}, "
                                   f"{tile_dl})")
        else:
            case["max_abs_err"] = (got[0] - ref[0]).abs().max().item()
        del got, ref
        case["ms"] = time_ms(lambda: flash_prefill_partial_cuda(q, k, v, **kw))
        case["plain_ms"] = time_ms(lambda: flash_prefill_partial_ref(
            q, k, v, **kw), iters=5)
        mask = ((torch.arange(Tl, device=dev)[None, :] <= pos[:, None])
                & (torch.arange(Tl, device=dev)[None, :] < seq_len))
        case["library_ms"] = time_ms(sdpa_with_lse(q, k, v, mask, scale))
        case["library"] = ("aten._scaled_dot_product_efficient_attention "
                           "(compute_log_sumexp, additive mask)")
        pairs = sum(max(0, min(start + t + 1, seq_len)) for t in range(Tl))
        nbytes = (2.0 * case["live_rows"] * H * Dh + 2 * 2.0 * keys * KVH * Dh
                  + 4.0 * Tl * H * Dh + 2 * 4.0 * Tl * H)
        case["bound_ms"], case["bound_by"] = bound(nbytes,
                                                   4.0 * H * Dh * pairs)
        if hop == "diagonal":
            # as a ring hop finds it after the layer's projections
            case["cold_ms"] = time_ms(lambda: flash_prefill_partial_cuda(
                q, k, v, **kw), cold=True)
        log(f"flash_prefill_partial {json.dumps(case)}")
        cases.append(case)
    return {"name": "flash_prefill_partial", "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/flash_prefill.cu",
            "replaces": "dynamo_tpu/engine/attention.py:436",
            "row_rel_tolerance": KERNEL_ROW_REL_TOL,
            "m_abs_tolerance": PARTIAL_M_ATOL,
            "l_rel_tolerance": PARTIAL_L_RTOL, **cases[0], "cases": cases}


def ring_dropping_one_hop(n: int):
    """``flash_prefill_partial`` with a planted fault for rings of n
    shards: in every ring, shard 1's partial at hop 1 (shard 0's chunk,
    all in its past) comes back as a dead hop."""
    import torch
    from dynamo_tpu_torch.engine.attention import (NEG_INF,
                                                   flash_prefill_partial)
    calls = [0]

    def fn(q, k, v, **kw):
        i = calls[0] % (n * n)       # calls run hop-major: s * n + r
        calls[0] += 1
        acc, m, l = flash_prefill_partial(q, k, v, **kw)
        if i == n + 1:
            return (torch.zeros_like(acc), torch.full_like(m, NEG_INF),
                    torch.zeros_like(l))
        return acc, m, l
    return fn


def check_ring(cfg, dev) -> dict:
    """The ring over sp = 2 and 4 shards of a 2048-token sequence on the
    one card, kv_len 1900, against K1 over the whole sequence; a planted
    fault drops one hop's partial."""
    import torch
    from dynamo_tpu_torch.engine import kernels
    from dynamo_tpu_torch.engine.kernels import flash_prefill_cuda
    from dynamo_tpu_torch.parallel import ring_attention as ring_mod
    from dynamo_tpu_torch.parallel.sharding import make_mesh
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    T, kv_len = MAX_MODEL_LEN, SP_TRUE_LEN
    scale = Dh ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    q = torch.randn((T, H, Dh), generator=gen, device=dev).bfloat16()
    k = torch.randn((T, KVH, Dh), generator=gen, device=dev).bfloat16()
    v = torch.randn((T, KVH, Dh), generator=gen, device=dev).bfloat16()
    ref = flash_prefill_cuda(q, k, v, scale=scale, start_pos=0,
                             seq_len=kv_len)
    k1_ms = time_ms(lambda: flash_prefill_cuda(q, k, v, scale=scale,
                                               start_pos=0, seq_len=kv_len))
    res = {"T": T, "kv_len": kv_len, "k1_ms": k1_ms}
    for sp in (2, 4):
        mesh = make_mesh(sp=sp, devices=[dev] * sp)
        shards = [x.chunk(sp) for x in (q, k, v)]

        def ring():
            return torch.cat(ring_mod.ring_attention(
                *shards, mesh, scale=scale, kv_len=kv_len))
        n0 = kernels.FLASH_PREFILL_PARTIAL.launches
        out = ring()
        launches = kernels.FLASH_PREFILL_PARTIAL.launches - n0
        with swapped((ring_mod, "flash_prefill_partial",
                      ring_dropping_one_hop(sp))):
            fault = ring()
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise RuntimeError(f"ring sp={sp}: non-finite output")
        err, rel = row_errors(out, ref, slice(0, kv_len))
        _, fault_rel = row_errors(fault, ref, slice(0, kv_len))
        case = {"sp": sp, "distinct_cards": len(mesh.distinct_devices),
                "k2_launches": launches, "max_abs_err": err,
                "max_row_rel_err": rel, "fault_dropped_hop_row_rel_err":
                    fault_rel, "ms": time_ms(ring)}
        log(f"ring {json.dumps(case)} [vs K1 over the whole sequence, "
            f"{k1_ms} ms]")
        check_limit(f"ring sp={sp} (dropped hop)", rel, fault_rel)
        if launches != sp * sp:
            raise RuntimeError(f"ring sp={sp}: {launches} K2 launches, "
                               f"expected {sp * sp}")
        res[f"sp{sp}"] = case
    return res


def check_limit(what: str, rel: float, fault_rel: float) -> None:
    if not rel <= KERNEL_ROW_REL_TOL:
        raise RuntimeError(f"{what}: row-relative error {rel} > "
                           f"{KERNEL_ROW_REL_TOL}")
    if not fault_rel > KERNEL_ROW_REL_TOL:
        raise RuntimeError(f"{what}: the planted fault ({fault_rel}) passes "
                           f"the limit {KERNEL_ROW_REL_TOL}")


# K3's inputs: the mixed decode batch it has been read on since its first
# version; its split boundaries (128-key chunks) at the 8B table width;
# the full batch, where bytes and not latency decide
PAGED_MIX = [1, 15, 16, 17, 255, 1000, 2048, 0]
PAGED_FULL = [2048] * 8


def paged_inputs(cfg, dev, seed: int, lens, int8: bool = False):
    """A decode batch at the 8B shapes: slots of ``lens`` keys over a
    shuffled table of 16-token blocks, a random pool (row-quantized for
    the int8 mode). Returns q, pools, tables, seq_lens."""
    import torch
    from dynamo_tpu_torch.engine.attention import quantize_kv_rows
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bs, M = KV_BLOCK, MAX_MODEL_LEN // KV_BLOCK
    B = len(lens)
    num_blocks = B * M + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k_cache = torch.randn((num_blocks * bs, KVH * Dh), generator=gen,
                          device=dev).bfloat16()
    v_cache = torch.randn((num_blocks * bs, KVH * Dh), generator=gen,
                          device=dev).bfloat16()
    if int8:
        k_cache, v_cache = quantize_kv_rows(k_cache), quantize_kv_rows(v_cache)
    perm = (torch.randperm(num_blocks - 1, generator=gen, device=dev)
            + 1).to(torch.int32)
    tables = torch.zeros((B, M), dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(lens):
        nb = -(-n // bs)
        tables[b, :nb] = perm[used:used + nb]
        used += nb
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, Dh), generator=gen, device=dev).bfloat16()
    return q, k_cache, v_cache, tables, seq_lens


def paged_bound(cfg, lens, int8: bool) -> tuple:
    """K3's bound: each key read once for K and once for V (an int8 row's
    two scale bytes once per token), q and out, tables and lengths."""
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    C, B, M = KVH * Dh, len(lens), MAX_MODEL_LEN // KV_BLOCK
    total = sum(lens)
    row = C + 2 if int8 else 2 * C
    nbytes = 2.0 * total * row + 2 * 2.0 * B * H * Dh + 4.0 * B * M + 4.0 * B
    return bound(nbytes, 4.0 * H * Dh * total)


def paged_library_ms(cfg, q, k_cache, v_cache, tables, seq_lens) -> float:
    """The yardstick: SDPA over pages gathered (and, from an int8 pool,
    dequantized) before timing, every slot padded to the table's 2048
    keys under a mask; cold L2."""
    import torch
    import torch.nn.functional as F
    from dynamo_tpu_torch.engine.attention import (dequant_kv_rows,
                                                   flat_token_indices)
    KVH, Dh = cfg.num_kv_heads, cfg.head_dim
    C, bs, M = KVH * Dh, KV_BLOCK, MAX_MODEL_LEN // KV_BLOCK
    B = q.shape[0]
    idx = flat_token_indices(tables, bs)

    def gathered(cache):
        rows = cache[idx]
        if cache.dtype == torch.int8:
            rows = dequant_kv_rows(rows, C, torch.bfloat16)
        return rows.reshape(B, M * bs, KVH, Dh).transpose(1, 2).contiguous()
    kg, vg = gathered(k_cache), gathered(v_cache)
    mask = (torch.arange(M * bs, device=q.device)[None, :]
            < seq_lens[:, None])[:, None, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kg, vg, attn_mask=mask, scale=Dh ** -0.5,
        enable_gqa=True), cold=True)


def check_paged_attention(cfg, dev, int8: bool = False) -> dict:
    """K3 (bf16 pool, or int8 rows with in-row scales) on the slot mix
    of PAGED_MIX, the row's reading since K3's first version, with its
    planted faults (the longest
    slot's last table entry read as the trash block; in int8 that block's
    scale lanes zeroed); repeated bits; the kernel's own split partials
    (read from the scratch it was given) merged in plain PyTorch against
    its output, and that merge with one split's partial left out as the
    planted merge fault; the lengths on and around the split boundaries;
    and the full batch (8 slots x 2048 keys), timed with its bound and
    library yardstick."""
    import torch
    from dynamo_tpu_torch.engine import attention, kernels
    name = "paged_attention" + ("_int8" if int8 else "")
    fn = (kernels.paged_attention_int8_cuda if int8
          else kernels.paged_attention_cuda)
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    C, g = KVH * Dh, cfg.num_heads // cfg.num_kv_heads
    bs, M = KV_BLOCK, MAX_MODEL_LEN // KV_BLOCK
    chunk, S = attention.decode_split_plan(M, bs)
    kw = dict(block_size=bs, scale=Dh ** -0.5)
    lens = PAGED_MIX
    B = len(lens)
    q, k_cache, v_cache, tables, seq_lens = paged_inputs(
        cfg, dev, 3 if int8 else 2, lens, int8)
    scratch = kernels.paged_scratch(q, KVH, M, bs)
    out = fn(q, k_cache, v_cache, tables, seq_lens, scratch=scratch, **kw)
    again = fn(q, k_cache, v_cache, tables, seq_lens, **kw)
    ref = attention.paged_attention_ref(q, k_cache, v_cache, tables,
                                        seq_lens, **kw)
    longest = max(range(B), key=lambda b: lens[b])
    last = (lens[longest] - 1) // bs
    if int8:
        # planted fault: the 2048-token slot's last block read with its
        # scale lanes ignored (every scale 2^0 * (1 + 0/256) = 1)
        rows = tables[longest, last].long() * bs + torch.arange(bs,
                                                                device=dev)
        bad_k, bad_v = k_cache.clone(), v_cache.clone()
        for t in (bad_k, bad_v):
            t[rows, C:C + 2] = 0
        fault = fn(q, bad_k, bad_v, tables, seq_lens, **kw)
        del bad_k, bad_v
    else:
        # planted fault: the longest slot's last table entry read as the
        # trash block (which holds other random rows here)
        bad_tables = tables.clone()
        bad_tables[longest, last] = 0
        fault = fn(q, k_cache, v_cache, bad_tables, seq_lens, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: non-finite output")
    if out[lens.index(0)].abs().max().item() != 0.0:
        raise RuntimeError(f"{name}: zero-length slot is not zero")
    if not torch.equal(out, again):
        raise RuntimeError(f"{name}: two calls gave different bits")
    live = seq_lens > 0
    err, rel = row_errors(out, ref, live)
    _, fault_rel = row_errors(fault, ref, live)
    slot_rel = [row_errors(out, ref, b)[1] if n else None
                for b, n in enumerate(lens)]
    # the merge: the kernel's partials of every slot with two or more live
    # splits, merged in plain PyTorch, against the kernel's own merge; then
    # the planted merge fault, each such slot's first split left out
    multi = [b for b, n in enumerate(lens) if n > chunk]
    sel = torch.tensor(multi, device=dev)
    km, kl, kacc = (t[sel].clone() for t in attention.split_scratch_views(
        scratch, B, KVH, S, g, Dh))
    for i, b in enumerate(multi):
        n = -(-lens[b] // chunk)
        km[i, :, n:], kl[i, :, n:], kacc[i, :, n:] = float("-inf"), 0, 0
    _, merge_rel = row_errors(attention.merge_split_partials(km, kl, kacc),
                              out[sel], slice(None))
    km[:, :, 0], kl[:, :, 0], kacc[:, :, 0] = float("-inf"), 0, 0
    _, merge_fault_rel = row_errors(
        attention.merge_split_partials(km, kl, kacc), ref[sel], slice(None))
    del km, kl, kacc
    # timed with a cold L2: in a decode step the KV of a layer was last
    # touched a whole step earlier
    ms = time_ms(lambda: fn(q, k_cache, v_cache, tables, seq_lens, **kw),
                 cold=True)
    plain_ms = time_ms(lambda: attention.paged_attention_ref(
        q, k_cache, v_cache, tables, seq_lens, **kw), cold=True)
    lib_ms = paged_library_ms(cfg, q, k_cache, v_cache, tables, seq_lens)
    b_ms, b_by = paged_bound(cfg, lens, int8)
    case = {"B": B, "seq_lens": lens, "chunk_tokens": chunk, "splits": S,
            "max_abs_err": err, "max_row_rel_err": rel,
            "slot_row_rel_err": slot_rel, "fault_row_rel_err": fault_rel,
            "repeat_bits_equal": True,
            "kernel_partials_merged_row_rel_err": merge_rel,
            "merge_fault_row_rel_err": merge_fault_rel,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": ("scaled_dot_product_attention over pages gathered "
                        + ("and dequantized " if int8 else "")
                        + "before timing, each slot padded to 2048 keys"),
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}
    del q, k_cache, v_cache, out, again, ref, fault, scratch

    # the split boundaries (and the whole table) against the plain version
    blens = [chunk - 1, chunk, chunk + 1, 2 * chunk, M * bs, 0]
    q, k_cache, v_cache, tables, seq_lens = paged_inputs(cfg, dev, 5, blens,
                                                         int8)
    out = fn(q, k_cache, v_cache, tables, seq_lens, **kw)
    ref = attention.paged_attention_ref(q, k_cache, v_cache, tables,
                                        seq_lens, **kw)
    torch.cuda.synchronize()
    if out[blens.index(0)].abs().max().item() != 0.0:
        raise RuntimeError(f"{name}: zero-length slot is not zero")
    case["boundary"] = {"seq_lens": blens, "slot_row_rel_err": [
        row_errors(out, ref, b)[1] if n else None
        for b, n in enumerate(blens)]}
    _, case["boundary"]["max_row_rel_err"] = row_errors(out, ref,
                                                        seq_lens > 0)
    del q, k_cache, v_cache, out, ref

    # the full batch: 8 x 2048 keys, every CTA live
    q, k_cache, v_cache, tables, seq_lens = paged_inputs(cfg, dev, 6,
                                                         PAGED_FULL, int8)
    out = fn(q, k_cache, v_cache, tables, seq_lens, **kw)
    again = fn(q, k_cache, v_cache, tables, seq_lens, **kw)
    ref = attention.paged_attention_ref(q, k_cache, v_cache, tables,
                                        seq_lens, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise RuntimeError(f"{name}: two full-batch calls gave different "
                           f"bits")
    full = {"seq_lens": PAGED_FULL}
    full["max_abs_err"], full["max_row_rel_err"] = row_errors(
        out, ref, slice(None))
    full["ms"] = time_ms(lambda: fn(q, k_cache, v_cache, tables, seq_lens,
                                    **kw), cold=True)
    full["plain_ms"] = time_ms(lambda: attention.paged_attention_ref(
        q, k_cache, v_cache, tables, seq_lens, **kw), cold=True)
    full["library_ms"] = paged_library_ms(cfg, q, k_cache, v_cache, tables,
                                          seq_lens)
    full["bound_ms"], full["bound_by"] = paged_bound(cfg, PAGED_FULL, int8)
    full["bound_share"] = full["bound_ms"] / full["ms"]
    case["full_batch"] = full
    del q, k_cache, v_cache, out, again, ref
    torch.cuda.empty_cache()
    log(f"{name} {json.dumps(case)}")
    check_limit(name, rel, fault_rel)
    check_limit(f"{name} merge", merge_rel, merge_fault_rel)
    for what, r in (("boundary", case["boundary"]["max_row_rel_err"]),
                    ("full batch", full["max_row_rel_err"])):
        if not r <= KERNEL_ROW_REL_TOL:
            raise RuntimeError(f"{name} {what}: row-relative error {r} > "
                               f"{KERNEL_ROW_REL_TOL}")
    return {"name": name, "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
            "replaces": "dynamo_tpu/engine/attention.py:743",
            "row_rel_tolerance": KERNEL_ROW_REL_TOL, **case}


# the ragged mix of phase 3 at the 8B shapes, (rows, kv length) per slot:
# a fresh 64-row chunk, a 64-row chunk continuing to 1000, a 4-row tail
# ending at 1900, decode rows at 1, 17, 255 and 2048 keys, a slot with no
# rows; then the trash sequence. 136 rows = 8 + 2 * 64, the auto capacity
# of 8 slots at 64 rows per sequence
RAGGED_MIX = [(64, 64), (64, 1000), (4, 1900), (1, 1), (1, 17), (1, 255),
              (1, 2048), (0, 0), (0, 0)]
# K4's split boundaries (128-key chunks, 256 for a tile of 5 or more
# rows): decode rows that see 127, 128, 129 and 256 keys, a 20-row chunk
# whose rows straddle the first boundary, a 64-row chunk ending at 1100
# (four wide tiles over five 256-key splits), a slot with no rows, a first
# decode row; then the trash sequence
RAGGED_BOUNDARY = [(1, 127), (1, 128), (1, 129), (1, 256), (20, 140),
                   (64, 1100), (0, 0), (1, 1), (0, 0)]
# the full ragged batch: two 64-row chunks ending at 2048 and 6 decode rows
# at 2048 keys (8 slots at full context); then the trash sequence
RAGGED_FULL = [(64, 2048), (64, 2048)] + [(1, 2048)] * 6 + [(0, 0)]
# phase 4's pure-decode ragged step, one layer: 8 decode rows at position
# 300; then the trash sequence
RAGGED_DECODE = [(1, 301)] * 8 + [(0, 0)]
RAGGED_MAX_ROWS = 64


def ragged_inputs(cfg, dev, seed: int, int8: bool, mix=RAGGED_MIX):
    """``mix`` over a shuffled table of 16-token blocks and a random pool
    (row-quantized for the int8 mode); the trash block 0 holds random rows
    too. Returns q, pools, tables, starts, counts, kv lengths (tensors) and
    the mix's starts as a list."""
    import torch
    from dynamo_tpu_torch.engine.attention import quantize_kv_rows
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bs, M = KV_BLOCK, MAX_MODEL_LEN // KV_BLOCK
    S = len(mix)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    num_blocks = S * M + 1
    k_cache, v_cache = (torch.randn((num_blocks * bs, KVH * Dh), generator=gen,
                                    device=dev).bfloat16() for _ in range(2))
    if int8:
        k_cache, v_cache = quantize_kv_rows(k_cache), quantize_kv_rows(v_cache)
    perm = (torch.randperm(num_blocks - 1, generator=gen, device=dev)
            + 1).to(torch.int32)
    tables = torch.zeros((S, M), dtype=torch.int32, device=dev)
    starts, used, cursor = [], 0, 0
    for s, (n, ctx) in enumerate(mix):
        nb = -(-ctx // bs)
        tables[s, :nb] = perm[used:used + nb]
        used += nb
        starts.append(cursor)
        cursor += n
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    q = torch.randn((cursor, H, Dh), generator=gen, device=dev).bfloat16()
    return (q, k_cache, v_cache, tables, i32(starts),
            i32([n for n, _ in mix]), i32([c for _, c in mix]), starts)


def ragged_library_ms(cfg, q, k_cache, v_cache, tables, starts_l,
                      mix) -> float:
    """The yardstick: one SDPA call over the sequences padded to [S, H, 64,
    Dh] against pre-gathered (and, int8, dequantized) pages with a boolean
    causal-and-length mask; padded rows see key 0; cold L2."""
    import torch
    import torch.nn.functional as F
    from dynamo_tpu_torch.engine.attention import (dequant_kv_rows,
                                                   flat_token_indices)
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    C, bs, M = KVH * Dh, KV_BLOCK, MAX_MODEL_LEN // KV_BLOCK
    S, dev, Lp = len(mix), q.device, RAGGED_MAX_ROWS
    qp = torch.zeros((S, H, Lp, Dh), dtype=torch.bfloat16, device=dev)
    r = torch.arange(Lp, device=dev)
    kv_pos = torch.arange(M * bs, device=dev)
    mask = torch.zeros((S, 1, Lp, M * bs), dtype=torch.bool, device=dev)
    for s, (st, (n, c)) in enumerate(zip(starts_l, mix)):
        qp[s, :, :n] = q[st:st + n].transpose(0, 1)
        mask[s, 0] = (((kv_pos[None, :] <= (c - n + r)[:, None])
                       & (kv_pos[None, :] < c) & (r < n)[:, None])
                      | ((kv_pos[None, :] == 0) & (r >= n)[:, None]))
    idx = flat_token_indices(tables, bs)
    kg, vg = k_cache[idx], v_cache[idx]
    if k_cache.dtype == torch.int8:
        kg = dequant_kv_rows(kg, C, torch.bfloat16)
        vg = dequant_kv_rows(vg, C, torch.bfloat16)
    kg = kg.reshape(S, M * bs, KVH, Dh).transpose(1, 2).contiguous()
    vg = vg.reshape(S, M * bs, KVH, Dh).transpose(1, 2).contiguous()
    return time_ms(lambda: F.scaled_dot_product_attention(
        qp, kg, vg, attn_mask=mask, scale=Dh ** -0.5, enable_gqa=True),
        cold=True)


def ragged_bound(cfg, mix, int8: bool) -> tuple:
    """K4's bound: each sequence's keys read once for K and once for V (an
    int8 row's two scale bytes once per key), q and out, the tables and
    the per-sequence scalars; 4*H*Dh operations per visible (row, key)."""
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    C, S, M = KVH * Dh, len(mix), MAX_MODEL_LEN // KV_BLOCK
    TT = sum(n for n, _ in mix)
    row_bytes = (C + 2) if int8 else 2.0 * C    # one K or V row, read once
    nbytes = (2.0 * row_bytes * sum(c for _, c in mix)
              + 2 * 2.0 * TT * H * Dh + 4.0 * (S * M + 3 * S))
    pairs = sum(c - n + i + 1 for n, c in mix for i in range(n))
    return bound(nbytes, 4.0 * H * Dh * pairs)


def check_ragged_attention(cfg, dev, int8: bool = False) -> dict:
    """K4 (bf16 pool, or int8 rows with in-row scales) on RAGGED_MIX, with
    two planted faults: the 2048-token row's last block read as the trash
    block, and an off-by-one causal mask inside each chunk (its rows one
    position early, so each misses its own key); repeated bits; the
    kernel's own split partials (read from the scratch it was given, for
    the rows whose tile has two or more live splits) merged in plain
    PyTorch against its output, and that merge with each such row's first
    split left out as the planted merge fault; RAGGED_BOUNDARY against the
    plain version; and RAGGED_FULL and RAGGED_DECODE, timed with their
    bounds and library yardsticks."""
    import torch
    from dynamo_tpu_torch.engine import attention, kernels
    from dynamo_tpu_torch.engine.attention import ragged_paged_attention_ref
    name = "ragged_paged_attention" + ("_int8" if int8 else "")
    fn = (kernels.ragged_paged_attention_int8_cuda if int8
          else kernels.ragged_paged_attention_cuda)
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = H // KVH
    bs, M = KV_BLOCK, MAX_MODEL_LEN // KV_BLOCK
    chunk, splits = attention.decode_split_plan(M, bs)
    q, k_cache, v_cache, tables, starts, counts, ctx, starts_l = \
        ragged_inputs(cfg, dev, 6 if int8 else 7, int8)
    TT, S = q.shape[0], len(RAGGED_MIX)
    kw = dict(block_size=bs, scale=Dh ** -0.5, max_rows=RAGGED_MAX_ROWS)
    args = (q, k_cache, v_cache, tables, starts, counts, ctx)
    scratch = kernels.paged_scratch(q, KVH, M, bs)
    out = fn(*args, scratch=scratch, **kw)
    again = fn(*args, **kw)
    ref = ragged_paged_attention_ref(*args, **kw)
    longest = max(range(S), key=lambda s: RAGGED_MIX[s][1])
    bad_tables = tables.clone()
    bad_tables[longest, (RAGGED_MIX[longest][1] - 1) // bs] = 0
    fault_trash = fn(q, k_cache, v_cache, bad_tables, starts, counts, ctx,
                     **kw)
    fault_mask = fn(q, k_cache, v_cache, tables, starts, counts,
                    torch.where(counts > 1, ctx - 1, ctx), **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: non-finite output")
    if not torch.equal(out, again):
        raise RuntimeError(f"{name}: two calls gave different bits")
    err, rel = row_errors(out, ref, slice(0, TT))
    _, trash_rel = row_errors(fault_trash, ref, slice(0, TT))
    _, mask_rel = row_errors(fault_mask, ref, slice(0, TT))
    del fault_trash, fault_mask, again
    seq_rel = [row_errors(out, ref, slice(st, st + n))[1] if n else None
               for st, (n, _) in zip(starts_l, RAGGED_MIX)]
    # the merge: the kernel's partials of the rows whose tile has two or
    # more live splits, merged in plain PyTorch, against the kernel's own
    # merge; then the planted merge fault, each such row's first split
    # left out
    _, live = attention.ragged_row_plan(starts, counts, ctx, TT, g, M, bs)
    multi = [r for r in range(TT) if live[r] > 1]
    sel = torch.tensor(multi, device=dev)
    km, kl, kacc = (t[sel].clone() for t in attention.split_scratch_views(
        scratch, TT, KVH, splits, g, Dh))
    for i, r in enumerate(multi):
        n = int(live[r])
        km[i, :, n:], kl[i, :, n:], kacc[i, :, n:] = float("-inf"), 0, 0
    _, merge_rel = row_errors(attention.merge_split_partials(km, kl, kacc),
                              out[sel], slice(None))
    km[:, :, 0], kl[:, :, 0], kacc[:, :, 0] = float("-inf"), 0, 0
    _, merge_fault_rel = row_errors(
        attention.merge_split_partials(km, kl, kacc), ref[sel], slice(None))
    del km, kl, kacc, scratch
    # timed with a cold L2: in a forward pass a layer's KV was last touched
    # a whole dispatch earlier
    ms = time_ms(lambda: fn(*args, **kw), cold=True)
    plain_ms = time_ms(lambda: ragged_paged_attention_ref(*args, **kw),
                       iters=5, cold=True)
    lib_ms = ragged_library_ms(cfg, q, k_cache, v_cache, tables, starts_l,
                               RAGGED_MIX)
    b_ms, b_by = ragged_bound(cfg, RAGGED_MIX, int8)
    case = {"TT": TT, "mix": RAGGED_MIX, "chunk_tokens": chunk,
            "splits": splits, "max_abs_err": err,
            "max_row_rel_err": rel, "seq_row_rel_err": seq_rel,
            "fault_trash_row_rel_err": trash_rel,
            "fault_mask_row_rel_err": mask_rel, "repeat_bits_equal": True,
            "multi_split_rows": len(multi),
            "kernel_partials_merged_row_rel_err": merge_rel,
            "merge_fault_row_rel_err": merge_fault_rel, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": "scaled_dot_product_attention over padded sequences "
                       "and pre-gathered" + (" dequantized" if int8 else "")
                       + " pages",
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}
    del q, k_cache, v_cache, out, ref, args

    # the split boundaries against the plain version
    q, k_cache, v_cache, tables, starts, counts, ctx, starts_l = \
        ragged_inputs(cfg, dev, 8, int8, RAGGED_BOUNDARY)
    bargs = (q, k_cache, v_cache, tables, starts, counts, ctx)
    out = fn(*bargs, **kw)
    ref = ragged_paged_attention_ref(*bargs, **kw)
    torch.cuda.synchronize()
    case["boundary"] = {"mix": RAGGED_BOUNDARY, "seq_row_rel_err": [
        row_errors(out, ref, slice(st, st + n))[1] if n else None
        for st, (n, _) in zip(starts_l, RAGGED_BOUNDARY)]}
    _, case["boundary"]["max_row_rel_err"] = row_errors(
        out, ref, slice(0, q.shape[0]))
    del q, k_cache, v_cache, out, ref, bargs

    # the full ragged batch: 8 slots at 2048 keys, every split live
    q, k_cache, v_cache, tables, starts, counts, ctx, starts_l = \
        ragged_inputs(cfg, dev, 9, int8, RAGGED_FULL)
    fargs = (q, k_cache, v_cache, tables, starts, counts, ctx)
    out = fn(*fargs, **kw)
    again = fn(*fargs, **kw)
    ref = ragged_paged_attention_ref(*fargs, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise RuntimeError(f"{name}: two full-batch calls gave different "
                           f"bits")
    full = {"mix": RAGGED_FULL, "TT": q.shape[0]}
    full["max_abs_err"], full["max_row_rel_err"] = row_errors(
        out, ref, slice(0, q.shape[0]))
    del out, again, ref
    full["ms"] = time_ms(lambda: fn(*fargs, **kw), cold=True)
    full["plain_ms"] = time_ms(lambda: ragged_paged_attention_ref(
        *fargs, **kw), iters=3, cold=True)
    full["library_ms"] = ragged_library_ms(cfg, q, k_cache, v_cache, tables,
                                           starts_l, RAGGED_FULL)
    full["bound_ms"], full["bound_by"] = ragged_bound(cfg, RAGGED_FULL, int8)
    full["bound_share"] = full["bound_ms"] / full["ms"]
    case["full_batch"] = full
    del q, k_cache, v_cache, fargs

    # one layer of the pure-decode ragged step: latency, not bytes, decides
    q, k_cache, v_cache, tables, starts, counts, ctx, starts_l = \
        ragged_inputs(cfg, dev, 10, int8, RAGGED_DECODE)
    dargs = (q, k_cache, v_cache, tables, starts, counts, ctx)
    out = fn(*dargs, **kw)
    ref = ragged_paged_attention_ref(*dargs, **kw)
    torch.cuda.synchronize()
    dec = {"mix": RAGGED_DECODE}
    _, dec["max_row_rel_err"] = row_errors(out, ref, slice(0, q.shape[0]))
    dec["ms"] = time_ms(lambda: fn(*dargs, **kw), cold=True)
    dec["library_ms"] = ragged_library_ms(cfg, q, k_cache, v_cache, tables,
                                          starts_l, RAGGED_DECODE)
    dec["bound_ms"], dec["bound_by"] = ragged_bound(cfg, RAGGED_DECODE, int8)
    case["decode_step"] = dec
    del q, k_cache, v_cache, out, ref, dargs
    torch.cuda.empty_cache()
    log(f"{name} {json.dumps(case)}")
    check_limit(f"{name} (last block as trash)", rel, trash_rel)
    check_limit(f"{name} (off-by-one causal mask)", rel, mask_rel)
    check_limit(f"{name} merge", merge_rel, merge_fault_rel)
    for what, r in (("boundary", case["boundary"]["max_row_rel_err"]),
                    ("full batch", full["max_row_rel_err"]),
                    ("decode step", dec["max_row_rel_err"])):
        if not r <= KERNEL_ROW_REL_TOL:
            raise RuntimeError(f"{name} {what}: row-relative error {r} > "
                               f"{KERNEL_ROW_REL_TOL}")
    return {"name": name, "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": "dynamo_tpu/engine/attention.py:1255",
            "row_rel_tolerance": KERNEL_ROW_REL_TOL, **case}


def check_lm_head_int8(cfg, dev) -> dict:
    """K5 at the 8B head, [4096, 128256] int8, for one prefill row and
    decode batches of 2, 4 and 8 rows: repeated bits, and the first
    128-column strip left out as the planted fault."""
    import torch
    from dynamo_tpu_torch.engine.kernels import lm_head_int8_cuda
    from dynamo_tpu_torch.engine.lm_head import lm_head_int8_ref
    from dynamo_tpu_torch.engine.quant import quantize_array
    D, V = cfg.hidden_size, cfg.vocab_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    head = quantize_array(torch.randn((D, V), generator=gen, device=dev)
                          * D ** -0.5, keep_axes=(-1,))
    q, scale = head.q, head.scale.reshape(-1).contiguous()
    # the library yardstick reads a bf16 copy of the dequantized head
    w16 = head.dequantize(torch.bfloat16)
    cases = []
    for B in (1, 2, 4, 8):
        x = torch.randn((B, D), generator=gen, device=dev).bfloat16()
        out = lm_head_int8_cuda(x, q, scale)
        again = lm_head_int8_cuda(x, q, scale)
        ref = lm_head_int8_ref(x, q, scale)
        # planted fault: one 128-column strip (the first) left out
        fault = torch.zeros_like(out)
        fault[:, 128:] = lm_head_int8_cuda(x, q[:, 128:].contiguous(),
                                           scale[128:].contiguous())
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise RuntimeError(f"lm_head_int8 B={B}: non-finite output")
        if not torch.equal(out, again):
            raise RuntimeError(f"lm_head_int8 B={B}: two calls gave "
                               f"different bits")
        err, rel = row_errors(out, ref, slice(0, B))
        _, fault_rel = row_errors(fault, ref, slice(0, B))
        del fault, again
        ms = time_ms(lambda: lm_head_int8_cuda(x, q, scale), cold=True)
        plain_ms = time_ms(lambda: lm_head_int8_ref(x, q, scale), iters=5,
                           cold=True)
        lib_ms = time_ms(lambda: torch.matmul(x, w16), cold=True)
        nbytes = 1.0 * D * V + 4.0 * V + 2.0 * B * D + 4.0 * B * V
        b_ms, b_by = bound(nbytes, 2.0 * B * D * V)
        case = {"B": B, "D": D, "V": V, "max_abs_err": err,
                "max_row_rel_err": rel, "fault_row_rel_err": fault_rel,
                "repeat_bits_equal": True,
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "library": "torch.matmul on a bf16 copy of the dequantized "
                           "head",
                "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}
        log(f"lm_head_int8 {json.dumps(case)}")
        check_limit(f"lm_head_int8 B={B}", rel, fault_rel)
        cases.append(case)
    primary = next(c for c in cases if c["B"] == 8)
    return {"name": "lm_head_int8", "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/lm_head_int8.cu",
            "replaces": "dynamo_tpu/engine/lm_head.py:66",
            "row_rel_tolerance": KERNEL_ROW_REL_TOL, **primary,
            "cases": cases}


def int4pack_yardstick(x, w, ref):
    """One PyTorch call computing x @ dequant(w) for the grouped-int4 weight
    ``w``: ``torch._weight_int4pack_mm`` where this build has it for CUDA
    and it reproduces the plain result, else ``torch.matmul`` on
    pre-dequantized bf16 weights. Returns (fn, name)."""
    import torch
    from dynamo_tpu_torch.engine.quant import unpack_int4_rows
    # torch's layout: uint8 [F, D/2], the even contraction row in the high
    # nibble, values biased by 8, scale and zero point per (group, column)
    u = (unpack_int4_rows(w.q).t().to(torch.int32) + 8)        # [F, D] 0..15
    sz = torch.stack([w.scale, torch.zeros_like(w.scale)],
                     -1).to(torch.bfloat16).contiguous()
    try:
        wp = torch._convert_weight_to_int4pack(
            ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8).contiguous(), 8)

        def fn():
            return torch._weight_int4pack_mm(x, wp, 128, sz)
        got = fn().float()
        err = ((got - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        if err < 0.05:
            return fn, "torch._weight_int4pack_mm"
        log(f"grouped_int4_matmul: _weight_int4pack_mm differs by {err}")
    except (AttributeError, RuntimeError, TypeError) as e:
        log(f"grouped_int4_matmul: _weight_int4pack_mm failed: "
            f"{type(e).__name__}: {str(e)[:200]}")
    w16 = w.dequantize(torch.bfloat16)
    return (lambda: torch.matmul(x, w16),
            "torch.matmul on pre-dequantized bf16 weights")


# K6's cases: the four 8B layer shapes (wq/wo, gate/up, down, wk/wv) at a
# decode row, an 8-slot step, the two sides of the decode/prefill tiling
# edge (16 and 17 rows) and a 512-token prefill bucket
INT4_ROWS = (1, 8, 16, 17, 512)


def check_grouped_int4(cfg, dev) -> dict:
    """K6 at the 8B layer shapes for INT4_ROWS: repeated bits, the last
    group's scales read as the first's as a planted fault, and where the
    contraction is split, the kernel's own split partials merged in plain
    PyTorch (within the limit) and merged with one split left out (the
    second planted fault)."""
    import torch
    from dynamo_tpu_torch.engine.kernels import (grouped_int4_matmul_cuda,
                                                 grouped_int4_scratch)
    from dynamo_tpu_torch.engine.quant import quantize_array_grouped
    from dynamo_tpu_torch.engine.quant_matmul import (
        grouped_int4_matmul_ref, int4_split_plan, merge_int4_split_partials)
    D, Fi = cfg.hidden_size, cfg.intermediate_size
    KVD = cfg.num_kv_heads * cfg.head_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cases = []
    for d, f in ((D, Fi), (Fi, D), (D, KVD), (D, D)):
        w = quantize_array_grouped(torch.randn((d, f), generator=gen,
                                               device=dev) * d ** -0.5)
        bad = w.scale.clone()
        bad[-1] = bad[0]   # planted fault: last group's scales = first's
        for n in INT4_ROWS:
            x = torch.randn((n, d), generator=gen, device=dev).bfloat16()
            splits, per = int4_split_plan(n, d, f)
            scratch = grouped_int4_scratch(x, f)
            out = grouped_int4_matmul_cuda(x, w.q, w.scale, scratch=scratch)
            again = grouped_int4_matmul_cuda(x, w.q, w.scale)
            ref = grouped_int4_matmul_ref(x, w.q, w.scale)
            fault = grouped_int4_matmul_cuda(x, w.q, bad)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise RuntimeError(f"grouped_int4_matmul {d}x{f} N={n}: "
                                   f"non-finite output")
            if not torch.equal(out, again):
                raise RuntimeError(f"grouped_int4_matmul {d}x{f} N={n}: two "
                                   f"calls gave different bits")
            err, rel = row_errors(out, ref, slice(0, n))
            _, fault_rel = row_errors(fault, ref, slice(0, n))
            del fault, again
            case = {"N": n, "D": d, "F": f, "splits": splits,
                    "groups_per_split": per,
                    "ctas": (f // 128) * splits
                    * (1 if n <= 16 else -(-n // 128)),
                    "max_abs_err": err, "max_row_rel_err": rel,
                    "fault_row_rel_err": fault_rel, "repeat_bits_equal": True}
            check_limit(f"grouped_int4_matmul {d}x{f} N={n}", rel, fault_rel)
            if scratch is not None:
                # the kernel's own partials, merged in split order, and
                # merged with the last split left out
                _, merge_rel = row_errors(
                    merge_int4_split_partials(scratch, torch.bfloat16), out,
                    slice(0, n))
                _, drop_rel = row_errors(
                    merge_int4_split_partials(scratch[:-1], torch.bfloat16),
                    ref, slice(0, n))
                case.update({"own_partials_row_rel_err": merge_rel,
                             "fault_dropped_split_row_rel_err": drop_rel})
                check_limit(f"grouped_int4_matmul {d}x{f} N={n} (dropped "
                            f"split)", merge_rel, drop_rel)
                del scratch
            case["ms"] = time_ms(lambda: grouped_int4_matmul_cuda(
                x, w.q, w.scale), cold=True)
            case["plain_ms"] = time_ms(lambda: grouped_int4_matmul_ref(
                x, w.q, w.scale), iters=5, cold=True)
            lib_fn, case["library"] = int4pack_yardstick(x, w, ref)
            case["library_ms"] = time_ms(lib_fn, cold=True)
            nbytes = (0.5 * d * f + 4.0 * (d // 128) * f + 2.0 * n * d
                      + 2.0 * n * f)
            case["bound_ms"], case["bound_by"] = bound(nbytes,
                                                       2.0 * n * d * f)
            log(f"grouped_int4_matmul {json.dumps(case)}")
            cases.append(case)
        del w, bad
    primary = next(c for c in cases
                   if (c["D"], c["F"], c["N"]) == (D, Fi, 8))
    return {"name": "grouped_int4_matmul", "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/grouped_int4_matmul.cu",
            "replaces": "dynamo_tpu/engine/quant_matmul.py:46",
            "row_rel_tolerance": KERNEL_ROW_REL_TOL, **primary,
            "cases": cases}


# ---------------------------------------------------------------------------
# phase 4: the 8B model through the kernels and through the plain versions
# ---------------------------------------------------------------------------

# bf16 logits of a 32-layer random-weight model, as max |kernel - plain|
# over max |plain|: the two paths round attention at different points in
# every layer (the kernels keep scores in f32), and the differences ride the
# residual stream through 32 bf16 layers. The same comparison is read with a
# planted fault in each kernel of the mode (the prefill's last KV tile left
# out; the decode step's last table entry read as the trash block; the int8
# head's first 256-column strip left out; the grouped-int4 matmul reading
# its last group's scales as the first group's); the limit sits between the
# right and the faulty readings (PERF.md, Findings).
MODEL_REL_TOL = 5e-2

# the modes of phase 4: weight quantization and KV pool
MODEL_MODES = {"bf16": ("none", "none"), "int4_kv8": ("int4", "int8"),
               "int8": ("int8", "none")}


@contextlib.contextmanager
def swapped(*repl):
    """Set ``(module, attribute, value)`` triples for the duration; the
    llama module and ``quant.mm`` call the swapped-in functions in place
    of the kernels' wrappers."""
    saved = [(m, a, getattr(m, a)) for m, a, _ in repl]
    for m, a, v in repl:
        setattr(m, a, v)
    try:
        yield
    finally:
        for m, a, v in saved:
            setattr(m, a, v)


def prefill_without_last_tile(q, k, v, *, scale, start_pos, seq_len, **_):
    """K1 with a planted fault: the last KV tile left out."""
    from dynamo_tpu_torch.engine.kernels import flash_prefill_cuda
    return flash_prefill_cuda(q, k, v, scale=scale, start_pos=start_pos,
                              seq_len=max(seq_len - FAULT_KEYS, start_pos + 1))


def decode_without_last_block(q, k_cache, v_cache, block_tables, seq_lens, *,
                              block_size, scale, **_):
    """K3 (either pool) with a planted fault: each slot's last table entry
    read as the trash block."""
    import torch
    from dynamo_tpu_torch.engine import kernels
    tables = block_tables.clone()
    last = (seq_lens.long() - 1).clamp(min=0) // block_size
    tables[torch.arange(tables.shape[0], device=tables.device), last] = 0
    fn = (kernels.paged_attention_int8_cuda if k_cache.dtype == torch.int8
          else kernels.paged_attention_cuda)
    return fn(q, k_cache, v_cache, tables, seq_lens, block_size=block_size,
              scale=scale)


def head_without_first_strip(x, q, scale):
    """K5 with a planted fault: the first 256 vocab columns left out."""
    import torch
    from dynamo_tpu_torch.engine.kernels import lm_head_int8_cuda
    x2 = x[None] if x.dim() == 1 else x
    out = torch.zeros((x2.shape[0], q.shape[1]), dtype=torch.float32,
                      device=x.device)
    out[:, 256:] = lm_head_int8_cuda(x2, q[:, 256:].contiguous(),
                                     scale.reshape(-1)[256:].contiguous())
    return out[0] if x.dim() == 1 else out


def int4_last_group_as_first(x, packed, scale):
    """K6 with a planted fault: the last group's scales read as the first
    group's."""
    from dynamo_tpu_torch.engine.kernels import grouped_int4_matmul_cuda
    bad = scale.clone()
    bad[-1] = bad[0]
    return grouped_int4_matmul_cuda(x, packed, bad)


def ragged_without_last_block(q, k_cache, v_cache, block_tables, seq_starts,
                              seq_counts, seq_lens, *, block_size, scale,
                              max_rows, **_):
    """K4 (either pool) with a planted fault: each sequence's last table
    entry read as the trash block."""
    import torch
    from dynamo_tpu_torch.engine import kernels
    tables = block_tables.clone()
    last = (seq_lens.long() - 1).clamp(min=0) // block_size
    tables[torch.arange(tables.shape[0], device=tables.device), last] = 0
    fn = (kernels.ragged_paged_attention_int8_cuda
          if k_cache.dtype == torch.int8 else kernels.ragged_paged_attention_cuda)
    return fn(q, k_cache, v_cache, tables, seq_starts, seq_counts, seq_lens,
              block_size=block_size, scale=scale, max_rows=max_rows)


# phase 4's ragged dispatches over slots 0-2 of an 8-slot engine, as
# {slot: (row count, first position)}: two fresh 64-row chunks, then a
# mixed dispatch of a decode row, a 64-row chunk continuing a prefix and a
# fresh 8-row chunk
RAGGED_MODEL_DISPATCHES = [{0: (64, 0), 1: (64, 0)},
                           {0: (1, 64), 1: (64, 64), 2: (8, 0)}]
RAGGED_MODES = ("bf16", "int4_kv8")


def ragged_batch(spans, tokens, tables, B: int, dev) -> tuple:
    """The arrays of one ragged dispatch (rows packed in slot order, the
    trash sequence last, as engine/ragged.py packs them): tokens,
    positions, tables, row_slot, starts, counts, sample_rows."""
    import torch
    toks, pos, row_slot = [], [], []
    starts = [0] * (B + 1)
    counts = [0] * (B + 1)
    sample = [0] * (B + 1)
    for slot in sorted(spans):
        n, p0 = spans[slot]
        starts[slot] = len(toks)
        counts[slot] = n
        sample[slot] = len(toks) + n - 1
        toks += tokens[slot][p0:p0 + n]
        pos += list(range(p0, p0 + n))
        row_slot += [slot] * n
    starts[B] = len(toks)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    return (torch.tensor(toks, dtype=torch.long, device=dev), i32(pos),
            tables, i32(row_slot), i32(starts), i32(counts), i32(sample))


def check_ragged_model(params, cfg, dev, seed: int, mode: str,
                       plain_swaps) -> dict:
    """Phase 4 on the ragged path: RAGGED_MODEL_DISPATCHES through
    ``llama.ragged_forward`` with the kernels and with the plain versions
    (``plain_swaps``, K4's included), and with a planted K4 fault; then one
    pure-decode ragged dispatch of 8 rows profiled beside the split decode
    step over the same rows."""
    import torch
    from dynamo_tpu_torch.engine import kernels
    from dynamo_tpu_torch.engine.models import llama
    _, kv_quant = MODEL_MODES[mode]
    bs, M, B = KV_BLOCK, MAX_MODEL_LEN // KV_BLOCK, 8
    per_slot = 24                      # blocks per slot: 384 tokens
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    tokens = torch.randint(3, cfg.vocab_size, (B, 128), generator=gen,
                           device=dev).tolist()
    tables = torch.zeros((B + 1, M), dtype=torch.int32, device=dev)
    for i in range(B):
        tables[i, :per_slot] = torch.arange(1 + i * per_slot,
                                            1 + (i + 1) * per_slot,
                                            device=dev)
    batches = [ragged_batch(sp, tokens, tables, B, dev)
               for sp in RAGGED_MODEL_DISPATCHES]

    def run():
        kv = state["kv"] = llama.init_kv_cache(cfg, B * per_slot + 1, bs, dev,
                                               torch.bfloat16,
                                               quantization=kv_quant)
        return torch.cat([llama.ragged_forward(params, kv, *b, cfg, bs,
                                               RAGGED_MAX_ROWS)[:3]
                          for b in batches])     # [dispatches * 3, V]

    state = {}
    k4 = kernels.KERNELS["ragged_paged_attention"
                         + ("_int8" if kv_quant == "int8" else "")]
    with torch.inference_mode():
        with swapped(*plain_swaps):
            ref = run()
        with swapped((llama, "ragged_paged_attention",
                      ragged_without_last_block)):
            fault = run()
        kernels.reset_launch_counts()
        got = run()
        launches = {k: v.launches for k, v in kernels.KERNELS.items()
                    if v.launches}
        profile = profile_ragged_decode(params, state["kv"], cfg, tables, B,
                                        dev)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all() or not torch.isfinite(ref).all():
        raise RuntimeError(f"ragged model {mode}: non-finite logits")
    spread = ref.abs().max().item()

    def compare(logits) -> dict:
        err = (logits - ref).abs().max().item()
        agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
        return {"max_abs_err": err, "rel_err": err / spread,
                "argmax_agreement": agree}

    res = {"mode": mode, "dispatches": RAGGED_MODEL_DISPATCHES,
           "launches": launches, "max_abs_ref": spread, **compare(got),
           "planted_fault_k4": compare(fault), "decode_dispatch": profile}
    log(f"ragged_model {json.dumps(res)}")
    want = {k4.name: cfg.num_layers * len(batches)}
    if {k: launches.get(k, 0) for k in want} != want or any(
            launches.get(k, 0) for k in ("flash_prefill", "paged_attention",
                                         "paged_attention_int8")):
        raise RuntimeError(f"ragged model {mode}: launches {launches}, "
                           f"expected {want} and no split-path attention")
    if not res["rel_err"] <= MODEL_REL_TOL:
        raise RuntimeError(f"ragged model {mode}: kernel and plain logits "
                           f"differ by {res['rel_err']} > {MODEL_REL_TOL}")
    if not res["planted_fault_k4"]["rel_err"] > MODEL_REL_TOL:
        raise RuntimeError(f"ragged model {mode}: the planted K4 fault "
                           f"({res['planted_fault_k4']['rel_err']}) passes "
                           f"the limit {MODEL_REL_TOL}")
    return res


# phase 4's sequence-parallel prefill: the pool rows the prompt wrote, as
# max |sp - whole-prompt| over max |whole-prompt| per side (k, v), the
# int8 pool's rows dequantized first. The rows of layer 0 are equal (same
# projections of the same embeddings); later layers inherit the attention
# rounding differences of the layers before, as the logits do.
SP_POOL_REL_TOL = 5e-2
# the ring-hop fault (shard 1 loses shard 0's chunk in every layer) must
# move the logits by more than this
SP_FAULT_MIN_REL = 0.15


def pool_rows(kv, rows, C: int):
    """The pool's k and v rows ``rows`` of every layer in f32 (int8 rows
    dequantized)."""
    import torch
    from dynamo_tpu_torch.engine.attention import dequant_kv_rows
    out = []
    for name in ("k", "v"):
        r = kv[name][:, rows]
        out.append(dequant_kv_rows(r, C, torch.float32)
                   if r.dtype == torch.int8 else r.float())
    return out


def check_model_sp(params, cfg, dev, seed: int) -> dict:
    """``prefill_forward_sp`` (sp = 2 on the one card, bucket 2048,
    true_len 1900) through K2 against ``prefill_forward`` through K1, over
    a bf16 pool and an int8 pool: logits, the prompt's pool rows, the K2
    launch count (32 layers x sp^2 hops), a planted ring-hop fault; then
    wall and device time of each prefill (bf16 pool)."""
    import torch
    from dynamo_tpu_torch.engine import kernels
    from dynamo_tpu_torch.engine.models import llama
    from dynamo_tpu_torch.parallel import ring_attention as ring_mod
    from dynamo_tpu_torch.parallel.sharding import make_mesh
    sp, bs, M = 2, KV_BLOCK, MAX_MODEL_LEN // KV_BLOCK
    T, true_len = MAX_MODEL_LEN, SP_TRUE_LEN
    mesh = make_mesh(sp=sp, devices=[dev] * sp)
    log(f"sp mesh: {sp} shards over {len(mesh.distinct_devices)} distinct "
        f"card(s)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    tokens = torch.randint(3, cfg.vocab_size, (T,), generator=gen, device=dev)
    table = torch.arange(1, M + 1, dtype=torch.int32, device=dev)
    rows = torch.arange(bs, bs + true_len, device=dev)   # blocks 1.. hold it
    C = cfg.num_kv_heads * cfg.head_dim
    out = {}
    for kv_quant in ("none", "int8"):
        def run(use_sp: bool, kv=None):
            if kv is None:
                kv = llama.init_kv_cache(cfg, M + 1, bs, dev, torch.bfloat16,
                                         quantization=kv_quant)
            if use_sp:
                logits = llama.prefill_forward_sp(params, kv, tokens, table,
                                                  true_len, cfg, bs, mesh)
            else:
                logits = llama.prefill_forward(params, kv, tokens, table, 0,
                                               true_len, cfg, bs)
            return logits, kv

        with torch.inference_mode():
            ref, kv_ref = run(False)
            kernels.reset_launch_counts()
            got, kv_sp = run(True)
            launches = {k: v.launches for k, v in kernels.KERNELS.items()
                        if v.launches}
            with swapped((ring_mod, "flash_prefill_partial",
                          ring_dropping_one_hop(sp))):
                fault, _ = run(True)
            pool = [(a - b).abs().max().item() / b.abs().max().item()
                    for a, b in zip(pool_rows(kv_sp, rows, C),
                                    pool_rows(kv_ref, rows, C))]
            del kv_ref, kv_sp
            timing = {}
            if kv_quant == "none":
                # each prefill again over one pool (its writes repeat):
                # wall time (mean of 3) and one profiled call
                _, kv = run(False)
                for name, use_sp in (("whole_prompt_k1", False),
                                     ("sp_ring_k2", True)):
                    run(use_sp, kv)
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                    for _ in range(3):
                        run(use_sp, kv)
                    torch.cuda.synchronize()
                    wall_ms = 1e3 * (time.monotonic() - t0) / 3
                    prof = device_profile(lambda: run(use_sp, kv))
                    timing[name] = {"wall_ms": wall_ms, **prof}
                del kv
        torch.cuda.synchronize()
        if not torch.isfinite(got).all() or not torch.isfinite(ref).all():
            raise RuntimeError(f"model sp {kv_quant}: non-finite logits")
        spread = ref.abs().max().item()
        rel = (got - ref).abs().max().item() / spread
        fault_rel = (fault - ref).abs().max().item() / spread
        res = {"kv": kv_quant, "sp": sp, "bucket": T, "true_len": true_len,
               "launches": launches, "max_abs_ref": spread, "rel_err": rel,
               "argmax_equal": bool(got.argmax() == ref.argmax()),
               "pool_rel_err_k_v": pool,
               "planted_fault_dropped_hop_rel_err": fault_rel,
               "prefill": timing}
        log(f"model_sp {json.dumps(res)}")
        want = {"flash_prefill_partial": cfg.num_layers * sp * sp}
        if ({k: launches.get(k, 0) for k in want} != want
                or launches.get("flash_prefill", 0)):
            raise RuntimeError(f"model sp {kv_quant}: launches {launches}, "
                               f"expected {want} and no K1")
        if not rel <= MODEL_REL_TOL:
            raise RuntimeError(f"model sp {kv_quant}: sp and whole-prompt "
                               f"logits differ by {rel} > {MODEL_REL_TOL}")
        if not max(pool) <= SP_POOL_REL_TOL:
            raise RuntimeError(f"model sp {kv_quant}: pool rows differ by "
                               f"{pool} > {SP_POOL_REL_TOL}")
        if not fault_rel > SP_FAULT_MIN_REL:
            raise RuntimeError(f"model sp {kv_quant}: the dropped-hop fault "
                               f"({fault_rel}) does not move the logits by "
                               f"more than {SP_FAULT_MIN_REL}")
        out[kv_quant] = res
    return out


def profile_ragged_decode(params, kv, cfg, tables, B: int, dev) -> dict:
    """One pure-decode ragged dispatch of B rows (one per slot, each at
    position 300 of its own blocks) beside the split decode step over the
    same rows: wall time (mean of 5), device time, busy share, kernels."""
    import torch
    from dynamo_tpu_torch.engine.models import llama
    pos = 300
    toks = torch.arange(3, 3 + B, dtype=torch.long, device=dev)
    positions = torch.full((B,), pos, dtype=torch.int32, device=dev)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    row_slot = i32(list(range(B)))
    starts = i32(list(range(B)) + [B])
    counts = i32([1] * B + [0])
    sample = i32(list(range(B)) + [0])

    def ragged():
        return llama.ragged_forward(params, kv, toks, positions, tables,
                                    row_slot, starts, counts, sample, cfg,
                                    KV_BLOCK, RAGGED_MAX_ROWS)

    def split():
        return llama.decode_forward(params, kv, toks, positions,
                                    tables[:B].contiguous(), cfg, KV_BLOCK)

    out = {}
    for name, step in (("ragged", ragged), ("split", split)):
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0) / 5
        prof = device_profile(step)
        if prof["device_busy_share"] is not None:
            prof["device_busy_share"] = prof["device_ms"] / wall_ms
        out[name] = {"wall_ms": wall_ms, **prof}
    return out


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
    prof = device_profile(step)
    if prof["device_busy_share"] is not None:   # against the 5-step mean
        prof["device_busy_share"] = prof["device_ms"] / wall_ms
    return {"wall_ms": wall_ms, **prof}


def device_profile(fn) -> dict:
    """Device time of one call of ``fn`` by kernel (torch.profiler): total,
    the kernel count and the top kernels, with the call's wall time."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    rows, launches = [], 0   # device kernels only: operator rows repeat
    # [ms, kernels] of each hand-written kernel of a call, either pool: K1,
    # K2, K3's two kernels (the merge is launched early, by programmatic
    # dependent launch, so its time includes its wait for the split kernel
    # and the two overlap), K4, K5 and K6 (both tilings)
    names = {"k1": ("flash_prefill_kernel",),
             "k2": ("flash_prefill_partial_kernel",),
             "k3_split": ("paged_attention_split_kernel",),
             "k3_merge": ("paged_attention_merge_kernel",),
             "k4": ("ragged_attention_kernel",),
             "k5": ("lm_head_int8_kernel",),
             "k6": ("int4_decode_kernel", "int4_prefill_kernel")}
    mine = {part: [0.0, 0] for part in names}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((t / 1e3, e.key))
            launches += e.count
            for part, acc in mine.items():
                if any(n in e.key for n in names[part]):
                    acc[0] += t / 1e3
                    acc[1] += e.count
    rows.sort(reverse=True)
    device_ms = sum(t for t, _ in rows)
    return {"profiled_wall_ms": wall_ms,
            "device_ms": device_ms if rows else "not measured",
            "device_busy_share": device_ms / wall_ms if rows else None,
            "device_kernels": launches if rows else "not measured",
            **{f"{part}_ms_kernels": acc if rows else "not measured"
               for part, acc in mine.items()},
            "top_kernels_ms": [[k[:60], t] for t, k in rows[:6]]}


# the decode program of phase 4 (engine/programs.py): K steps per dispatch
PROGRAM_K = 8


def program_inputs(pos: int, table, B: int, M: int,
                   second_table=None) -> dict:
    """One dispatch's host inputs: slot 0 greedy over ``table`` at
    ``pos``; with ``second_table`` slot 1 too, sampled with a seed and
    top-p 0.9 (so the filtered branch runs); the other slots inactive."""
    import numpy as np
    tables = np.zeros((B, M), np.int32)
    tables[0] = table.cpu().numpy()
    inp = dict(tokens=np.array([11, 12] + [0] * (B - 2), np.int64),
               positions=np.zeros((B,), np.int32), tables=tables,
               seeds=np.arange(B, dtype=np.int64),
               steps0=np.zeros((B,), np.int64),
               temperature=np.zeros((B,), np.float32),
               top_k=np.zeros((B,), np.int64),
               top_p=np.ones((B,), np.float32))
    inp["positions"][0] = inp["steps0"][0] = pos
    if second_table is not None:
        tables[1] = second_table.cpu().numpy()
        inp["positions"][1] = inp["steps0"][1] = pos
        inp["temperature"][1], inp["top_p"][1] = 0.7, 0.9
    return inp


def check_decode_program(params, kv, cfg, table, B: int, M: int,
                         pos: int, mode: str) -> dict:
    """The decode program over the 8B weights and the pool phase 4 filled:
    a graph replay against the same program run eagerly from the same
    pool (tokens, logprobs, logits of the live slots and the pool rows
    outside the trash block, bit for bit) at K = 1 and K = 8; K = 8
    against eight K = 1 dispatches (the same tokens); a planted fault
    (the static inputs left stale for a second dispatch) that must differ
    from the eager run; then wall / device / launches per token of the
    eager step, the graphed K = 1 step and the K = 8 dispatch, one live
    slot of B, greedy."""
    import numpy as np
    import torch
    from dynamo_tpu_torch.engine.programs import DecodeProgram
    dev = kv["k"].device
    n_used = int((table > 0).sum().item())
    second = torch.zeros_like(table)
    second[:n_used] = torch.arange(1 + n_used, 1 + 2 * n_used, device=dev)
    prog = DecodeProgram(params, kv, cfg, KV_BLOCK, B, M, PROGRAM_K, 0, dev)
    inp = program_inputs(pos, table, B, M, second)
    live = [0, 1]
    snap = {n: t.clone() for n, t in kv.items()}

    def restore():
        for n, t in kv.items():
            t.copy_(snap[n])

    res = {}
    for K in (1, PROGRAM_K):
        restore()
        d = prog.dispatch(K, "filtered", inp, with_logits=True)
        toks, lps = d.fetch()
        logits = d.logits.clone()
        pool = {n: t[:, KV_BLOCK:].clone() for n, t in kv.items()}
        restore()
        e = prog.run_eager(K, "filtered", inp, with_logits=True)
        same = {"tokens": bool((toks[:, live] == e.toks.cpu().numpy()
                                [:, live]).all()),
                "logprobs": bool((lps[:, live] == e.logprobs.cpu().numpy()
                                  [:, live]).all()),
                "logits": torch.equal(logits[:, live], e.logits[:, live]),
                "pool": all(torch.equal(pool[n], kv[n][:, KV_BLOCK:])
                            for n in kv)}
        res[f"k{K}_replay_equals_eager"] = same
        del pool, logits, e
    # K = 8 against eight K = 1 dispatches fed on the host
    restore()
    toks8, _ = prog.dispatch(PROGRAM_K, "filtered", inp).fetch()
    restore()
    step = {k: v.copy() for k, v in inp.items()}
    toks1 = []
    for _ in range(PROGRAM_K):
        t, _ = prog.dispatch(1, "filtered", step).fetch()
        toks1.append(t[0])
        step["tokens"] = t[0].copy()
        step["positions"][live] += 1
        step["steps0"][live] += 1
    res["k8_equals_eight_k1"] = bool(
        (toks8[:, live] == np.stack(toks1)[:, live]).all())
    # the planted fault: a second dispatch whose inputs never reach the
    # graph (its static inputs keep the first dispatch's tokens)
    other = {k: v.copy() for k, v in inp.items()}
    other["tokens"] = other["tokens"] + 1000
    restore()
    prog.dispatch(1, "filtered", inp, with_logits=True).fetch()
    upload = prog._upload
    prog._upload = lambda inputs: None
    try:
        restore()
        stale = prog.dispatch(1, "filtered", other,
                              with_logits=True).logits.clone()
    finally:
        prog._upload = upload
    restore()
    right = prog.run_eager(1, "filtered", other, with_logits=True).logits
    res["planted_stale_inputs_caught"] = not torch.equal(
        stale[:, live], right[:, live])
    del stale, right
    restore()
    del snap
    res["profile"] = profile_program(prog, pos, table, B, M)
    res["captures"], res["replays"] = prog.captures, prog.replays
    bad = [k for k, v in res.items() if v is False
           or (isinstance(v, dict) and False in v.values())]
    log(f"program {mode} {json.dumps(res)}")
    if bad:
        raise RuntimeError(f"decode program {mode}: {bad} failed")
    return res


def profile_program(prog, pos: int, table, B: int, M: int) -> dict:
    """Per token (one live slot of B, greedy): host wall time (mean of 5
    calls ending in the host fetch), device time and device kernels from
    the profiler, and for a replay its CUDA-event time, of the eager
    step, the graphed K = 1 step and the K = 8 dispatch."""
    import torch
    inp = program_inputs(pos, table, B, M)
    runs = {"eager_k1": (1, lambda: prog.run_eager(1, "greedy",
                                                   inp).fetch()),
            "graph_k1": (1, lambda: prog.dispatch(1, "greedy",
                                                  inp).fetch()),
            f"graph_k{PROGRAM_K}": (PROGRAM_K, lambda: prog.dispatch(
                PROGRAM_K, "greedy", inp).fetch())}
    out = {}
    for name, (K, fn) in runs.items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(5):
            fn()
        wall_ms = 1e3 * (time.monotonic() - t0) / 5
        prof = device_profile(fn)
        row = {"wall_ms_per_token": wall_ms / K,
               "device_ms_per_token": (prof["device_ms"] / K
                                       if prof["device_kernels"]
                                       != "not measured" else
                                       "not measured"),
               "device_kernels_per_token": (prof["device_kernels"] / K
                                            if prof["device_kernels"]
                                            != "not measured" else
                                            "not measured"),
               "device_busy_share": (prof["device_ms"] / wall_ms
                                     if prof["device_kernels"]
                                     != "not measured" else None)}
        if name.startswith("graph"):
            row["event_ms_per_token"] = time_ms(fn, iters=5, warmup=1) / K
        out[name] = row
    return out


def check_sampling_noise(cfg, dev) -> dict:
    """The sampler's Gumbel noise (JAX's threefry, in plain PyTorch) for
    one and for eight sampled rows over the 8B vocabulary: CUDA-event time
    and the kernels one draw launches."""
    import torch
    from dynamo_tpu_torch.engine.sampling import gumbel_noise, make_slot_key
    res = {}
    for b in (1, 8):
        keys = [make_slot_key(0, 7 + i, 100) for i in range(b)]
        ms = time_ms(lambda: gumbel_noise(cfg.vocab_size, keys, dev))
        prof = device_profile(lambda: gumbel_noise(cfg.vocab_size, keys,
                                                   dev))
        res[f"rows_{b}"] = {"ms": ms, "device_ms": prof["device_ms"],
                            "device_kernels": prof["device_kernels"]}
    log(f"sampling_noise {json.dumps(res)}")
    return res


def check_model(cfg, dev, seed: int, mode: str) -> dict:
    import torch
    from dynamo_tpu_torch.engine import attention, kernels, lm_head, quant
    from dynamo_tpu_torch.engine import quant_matmul
    from dynamo_tpu_torch.engine.models import llama
    from dynamo_tpu_torch.engine.quant import init_params_quantized
    from dynamo_tpu_torch.engine.weights import init_params
    weights, kv_quant = MODEL_MODES[mode]
    t0 = time.monotonic()
    if weights == "none":
        params = init_params(cfg, seed, dev, torch.bfloat16)
    else:
        params = init_params_quantized(cfg, seed, dev, torch.bfloat16,
                                       bits=4 if weights == "int4" else 8)
    torch.cuda.synchronize()
    log(f"model {mode}: 8B random weights on the card in "
        f"{time.monotonic() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
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
                                               torch.bfloat16,
                                               quantization=kv_quant)
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

    # each kernel of the mode: (slot, plain version, planted fault)
    slots = {"prefill": (llama, "flash_prefill", attention.flash_prefill_ref,
                         prefill_without_last_tile),
             "decode": (llama, "paged_attention",
                        attention.paged_attention_ref,
                        decode_without_last_block)}
    if weights != "none":
        slots["head"] = (llama, "lm_head_int8", lm_head.lm_head_int8_ref,
                         head_without_first_strip)
    if weights == "int4":
        slots["int4"] = (quant, "grouped_int4_matmul",
                         quant_matmul.grouped_int4_matmul_ref,
                         int4_last_group_as_first)
    state = {}
    with torch.inference_mode():
        forced = torch.randint(3, cfg.vocab_size, (steps,), generator=gen,
                               device=dev)
        with swapped(*((m, a, plain) for m, a, plain, _ in slots.values())):
            ref = run()
        faults = {}
        for name, (m, a, _, fault) in slots.items():
            with swapped((m, a, fault)):
                faults[name] = run()
        k6 = kernels.GROUPED_INT4_MATMUL.launches
        got = run()
        k6 = kernels.GROUPED_INT4_MATMUL.launches - k6
        profile = profile_decode_step(params, state["kv"], cfg, table, B, M,
                                      prompt_len + steps)
        program = check_decode_program(params, state["kv"], cfg, table, B,
                                       M, prompt_len + steps + 1, mode)
    torch.cuda.synchronize()
    del state
    if not torch.isfinite(got).all() or not torch.isfinite(ref).all():
        raise RuntimeError(f"model {mode}: non-finite logits")
    spread = ref.abs().max().item()
    res = {"mode": mode, "weights": weights, "kv": kv_quant,
           "grouped_int4_launches_per_forward": k6 / (1 + steps),
           "max_abs_ref": spread, **compare(got),
           "planted_faults": {k: compare(v) for k, v in faults.items()},
           "decode_step": profile, "program": program}
    log(f"model {json.dumps(res)}")
    del got, ref, faults
    if mode in RAGGED_MODES:
        # the same weights through the ragged path: K4 in place of K1/K3
        plain_swaps = [(m, a, plain) for m, a, plain, _ in slots.values()
                       if a not in ("flash_prefill", "paged_attention")]
        plain_swaps.append((llama, "ragged_paged_attention",
                            attention.ragged_paged_attention_ref))
        res["ragged"] = check_ragged_model(params, cfg, dev, seed, mode,
                                           plain_swaps)
    if mode == "bf16":
        # the same weights through the sequence-parallel prefill (K2)
        res["sp"] = check_model_sp(params, cfg, dev, seed)
    del params
    torch.cuda.empty_cache()
    # every layer matmul of the 8B geometry passes the grouped kernel's
    # shape rule: 7 launches per layer and forward under int4
    want_k6 = 7 * cfg.num_layers if weights == "int4" else 0
    if res["grouped_int4_launches_per_forward"] != want_k6:
        raise RuntimeError(f"model {mode}: "
                           f"{res['grouped_int4_launches_per_forward']} "
                           f"grouped-int4 launches per forward, expected "
                           f"{want_k6}")
    if not res["rel_err"] <= MODEL_REL_TOL:
        raise RuntimeError(f"model {mode}: kernel and plain logits differ by "
                           f"{res['rel_err']} x {spread} > {MODEL_REL_TOL}")
    for k, v in res["planted_faults"].items():
        if not v["rel_err"] > MODEL_REL_TOL:
            raise RuntimeError(f"model {mode}: the planted fault {k} "
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
            "text_chunks": len(t), "latency_s": res["latency_s"],
            # each token's text, for comparing two servers (not printed)
            "_texts": [c["choices"][0].get("text") for c in res["chunks"]
                       if c.get("choices")]}


def check_unary(name: str, res: dict, max_tokens: int) -> dict:
    out = res["response"]
    ch = out.get("choices") or []
    if (out.get("object") != "text_completion" or len(ch) != 1
            or not isinstance(ch[0].get("text"), str)
            or ch[0].get("finish_reason") != "length"
            or out.get("usage", {}).get("completion_tokens") != max_tokens):
        raise RuntimeError(f"{name}: malformed response {out}")
    return {"latency_s": res["latency_s"], "text": ch[0]["text"][:60]}


# the kernels each served path must launch
PATH_KERNELS = {
    "bf16": ("flash_prefill", "paged_attention"),
    "int4_kv8": ("flash_prefill", "paged_attention_int8", "lm_head_int8",
                 "grouped_int4_matmul"),
    "ragged": ("ragged_paged_attention",),
    "ragged_int4_kv8": ("ragged_paged_attention_int8", "lm_head_int8",
                        "grouped_int4_matmul"),
    "sp": ("flash_prefill_partial", "flash_prefill", "paged_attention"),
    "dispatch": ("flash_prefill", "paged_attention_int8", "lm_head_int8",
                 "grouped_int4_matmul"),
}
# the sequence-parallel server (5e): sp = 2 shards on the one card
SERVE_SP = 2
# each served path's weights and KV pool (MODEL_MODES), and whether it
# serves with --ragged
SERVE_PATHS = {"bf16": ("bf16", False), "int4_kv8": ("int4_kv8", False),
               "ragged": ("bf16", True),
               "ragged_int4_kv8": ("int4_kv8", True), "sp": ("bf16", False),
               "dispatch": ("int4_kv8", False)}
# the dispatch modes' server (5f): K = 8 steps a dispatch, pipelined, lane
# prefill of admissions of up to 128 un-cached tokens into a busy batch,
# prompts prefilled in chunks of 512
DISPATCH_K, DISPATCH_CHUNK, DISPATCH_LANE = 8, 512, 128
DISPATCH_FLAGS = ["--decode-steps-per-dispatch", str(DISPATCH_K),
                  "--decode-dispatch-pipeline",
                  "--lane-prefill-max-tokens", str(DISPATCH_LANE),
                  "--prefill-chunk", str(DISPATCH_CHUNK)]
# the split path's attention kernels: on a ragged path every admission and
# decode step goes through K4, so these launch 0 times there
SPLIT_ATTENTION = ("flash_prefill", "paged_attention", "paged_attention_int8")


def serve_phase(cfg, seed: int, card: str, path: str) -> tuple:
    """Serve from a temporary model directory (8B config + tokenizer).
    Returns (launch counts, per-request report)."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="dtt-8b-") as tmp:
        model_dir = os.path.join(tmp, "llama3-8b-random")
        write_model_dir(model_dir, cfg)
        return _serve(cfg, seed, card, model_dir, path)


def _serve(cfg, seed: int, card: str, model_dir: str, path: str) -> tuple:
    import asyncio
    import gc
    import threading
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from dynamo_tpu_torch.engine import kernels
    from dynamo_tpu_torch.engine.models import llama
    from dynamo_tpu_torch.launch import run as launcher
    from dynamo_tpu_torch.parallel.sharding import make_mesh
    mode, ragged = SERVE_PATHS[path]
    weights, kv_quant = MODEL_MODES[mode]
    args = launcher.build_parser().parse_args(
        ["in=http", "out=torch", "--model-path", model_dir,
         "--random-weights", "--http-host", "127.0.0.1",
         "--http-port", "0", "--max-model-len", str(MAX_MODEL_LEN),
         "--kv-block-size", str(KV_BLOCK), "--num-kv-blocks", "2048",
         "--max-num-seqs", "8", "--device", "cuda",
         "--quantization", weights, "--kv-quantization", kv_quant]
        + (["--ragged", "--ragged-max-seq-rows", str(RAGGED_MAX_ROWS)]
           if ragged else [])
        + (DISPATCH_FLAGS if path == "dispatch" else []))
    launcher.parse_io(args.io)
    t0 = time.monotonic()
    mesh = None
    if path == "sp":
        mesh = make_mesh(sp=SERVE_SP, devices=["cuda:0"] * SERVE_SP)
        log(f"serve sp: {SERVE_SP} shards over "
            f"{len(mesh.distinct_devices)} distinct card(s)")
    core = launcher.build_core(args, mesh=mesh)
    log(f"serve {path}: engine core built in {time.monotonic() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    # which prefill each admission took: (true_len, start_pos) per call
    prefills = {"sp": [], "plain": []}
    orig_sp, orig_plain = llama.prefill_forward_sp, llama.prefill_forward

    def sp_prefill(*a, **kw):
        prefills["sp"].append((a[4], 0))
        return orig_sp(*a, **kw)

    def plain_prefill(*a, **kw):
        prefills["plain"].append((a[5], a[4]))
        return orig_plain(*a, **kw)
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
    # bring-up: a short greedy and a short sampled request, so that the
    # decode program's graphs (greedy and filtered sampling) are captured
    # before the measured requests; the capture time is reported
    warm = np.random.default_rng(seed + 2).integers(
        259, cfg.vocab_size, size=16).tolist()
    t0 = time.monotonic()
    for extra in ({"temperature": 0}, {"temperature": 0.7, "top_p": 0.9,
                                       "seed": 2}):
        http_completion(port, {"model": name, "prompt": warm,
                               "max_tokens": 4,
                               "nvext": {"ignore_eos": True}, **extra})
    bring_up = {"warm_requests_s": time.monotonic() - t0,
                "graph_captures": core.program.captures,
                "graph_capture_s": core.program.capture_s}
    rng = np.random.default_rng(seed)
    mk = lambda n: rng.integers(259, cfg.vocab_size, size=n).tolist()  # noqa: E731
    max_tokens = 32
    greedy = {"model": name, "max_tokens": max_tokens, "temperature": 0,
              "nvext": {"ignore_eos": True}}
    sampled = {"model": name, "prompt": "the time of the people who work to "
               "make a good day", "max_tokens": max_tokens,
               "temperature": 0.7, "top_p": 0.9, "seed": 1,
               "nvext": {"ignore_eos": True}}
    if mode == "bf16":
        prompts = {"p100": mk(100), "p700": mk(700), "p1500": mk(1500),
                   "p1900": mk(1900)}
    else:
        prompts = {"p700": mk(700), "p1900": mk(1900)}
    if path == "dispatch":
        # 5b's prompts and a 1500-token one (2, 4 and 3 chunks of 512),
        # and a 64-token stream posted once a slot decodes: it rides the
        # batch as a lane
        extra = np.random.default_rng(seed + 1)
        prompts["p1500"] = extra.integers(259, cfg.vocab_size,
                                          size=1500).tolist()
        lane_prompt = extra.integers(259, cfg.vocab_size, size=64).tolist()
    report = {"bring_up": bring_up}
    stack = contextlib.ExitStack()
    try:
        stack.enter_context(swapped((llama, "prefill_forward_sp", sp_prefill),
                                    (llama, "prefill_forward",
                                     plain_prefill)))
        kernels.reset_launch_counts()
        pool = core.kv_manager.pool
        # concurrent greedy streams of mixed prompt lengths
        with ThreadPoolExecutor(len(prompts) + 1) as ex:
            futs = {k: ex.submit(http_completion, port, {
                **greedy, "prompt": p, "stream": True,
                "stream_options": {"include_usage": True}})
                for k, p in prompts.items()}
            if path == "dispatch":
                def lane_request():
                    # posted once a slot decodes (a racy read of the
                    # engine's slot list from this thread is enough)
                    t_end = time.monotonic() + 300
                    while not any(x is not None for x in core.slots):
                        if time.monotonic() > t_end:
                            raise RuntimeError("lane64: no slot decoded")
                        time.sleep(0.002)
                    return http_completion(port, {
                        **greedy, "prompt": lane_prompt, "stream": True,
                        "stream_options": {"include_usage": True}})
                futs["lane64"] = ex.submit(lane_request)
            for k, f in futs.items():
                report[k] = check_stream(k, f.result(), max_tokens, True)
        # one more SSE stream, usage not requested
        report["sse"] = check_stream("sse", http_completion(port, {
            **greedy, "prompt": mk(200), "stream": True}), max_tokens, False)
        if mode == "bf16":
            # a repeated prompt: its full blocks hit the prefix cache, so
            # the prefill runs only the tail, at start_pos > 0
            hits0 = pool.match_hits
            report["prefix_repeat"] = check_unary(
                "prefix_repeat", http_completion(
                    port, {**greedy, "prompt": prompts["p700"]}), max_tokens)
            hit_blocks = pool.match_hits - hits0
            if hit_blocks < 700 // KV_BLOCK:
                raise RuntimeError(f"prefix_repeat: {hit_blocks} prefix "
                                   f"blocks hit, expected {700 // KV_BLOCK}")
            report["prefix_repeat"]["hit_blocks"] = hit_blocks
        # a seeded sampled text prompt
        report["sampled_text"] = check_unary(
            "sampled_text", http_completion(port, sampled), max_tokens)
        if path != "bf16":
            # sampling is keyed by (seed, request seed, step) alone: the
            # same seeded request gives the same text again
            again = check_unary("sampled_again", http_completion(
                port, sampled), max_tokens)
            if again["text"] != report["sampled_text"]["text"]:
                raise RuntimeError(f"sampled_text: a seeded request gave "
                                   f"{again['text']!r} after "
                                   f"{report['sampled_text']['text']!r}")
        launches = {k: v.launches for k, v in kernels.KERNELS.items()}
        if ragged:
            m = core.metrics()
            report["ragged_metrics"] = {
                "dispatches": core.ragged_dispatches,
                "mixed_dispatches": core.ragged_mixed_dispatches,
                "prefill_rows": core.ragged_prefill_rows_total,
                "decode_rows": core.ragged_decode_rows_total,
                "capacity": core.cfg.ragged_max_tokens,
                "ragged_fill_ratio": m.ragged_fill_ratio,
                "ragged_mixed_ratio": m.ragged_mixed_ratio,
                "ragged_dispatches_saved_total":
                    m.ragged_dispatches_saved_total}
        if path == "sp":
            report["prefills"] = {k: sorted(v) for k, v in prefills.items()}
        if path == "dispatch":
            report["dispatch_metrics"] = {
                "lane_admissions": core.lane_admissions,
                "host_roundtrips": core.host_roundtrips,
                "host_stall_s": core.host_stall_s,
                "decode_tokens": core.total_decode_tokens,
                "prefill_tokens": core.total_prefill_tokens,
                "graph_captures": core.program.captures,
                "graph_capture_s": core.program.capture_s,
                "graph_replays": core.program.replays,
                "prefill_calls": list(prefills["plain"])}
    finally:
        stack.close()
        if "task" in holder:
            loop.call_soon_threadsafe(holder["task"].cancel)
        th.join(120)
    if th.is_alive():
        raise RuntimeError("serve: server thread did not stop")
    loop.close()
    for k, v in report.items():
        shown = {a: b for a, b in v.items() if not a.startswith("_")}
        log(f"request {path} {k} {json.dumps(shown)} [{card}]")
    log(f"serve {path}: launches {json.dumps(launches)}")
    for k in PATH_KERNELS[path]:
        if launches[k] <= 0:
            raise RuntimeError(f"serve {path}: kernel {k} was never "
                               f"launched")
    if ragged:
        split = {k: launches[k] for k in SPLIT_ATTENTION if launches[k]}
        if split:
            raise RuntimeError(f"serve {path}: split-path attention "
                               f"launched on the ragged path: {split}")
        if report["ragged_metrics"]["mixed_dispatches"] <= 0:
            raise RuntimeError(f"serve {path}: no dispatch mixed prefill "
                               f"and decode rows")
    if path == "sp":
        check_sp_dispatch(cfg, prefills, launches)
    if path == "dispatch":
        check_dispatch_modes(cfg, report["dispatch_metrics"], launches)
    del core
    gc.collect()
    torch.cuda.empty_cache()
    return launches, report


def check_sp_dispatch(cfg, prefills: dict, launches: dict) -> None:
    """5e: the prompts of at least sp_min_prefill_tokens (512) with no
    prefix hit took the ring (p700, p1500, p1900); p100, the 200-token SSE
    prompt, the sampled text and the prefix-cached repeat took the
    whole-prompt prefill; K2 launched 32 x sp^2 per ring prefill and K1 32
    per other prefill."""
    sp_lens = sorted(n for n, _ in prefills["sp"])
    plain = prefills["plain"]
    if sp_lens != [700, 1500, 1900]:
        raise RuntimeError(f"serve sp: the ring prefilled {sp_lens}, "
                           f"expected [700, 1500, 1900]")
    if (100 not in [n for n, _ in plain]
            or not any(start > 0 for _, start in plain)):
        raise RuntimeError(f"serve sp: p100 or the prefix-cached repeat did "
                           f"not take the whole-prompt prefill: {plain}")
    want = {"flash_prefill_partial": cfg.num_layers * SERVE_SP ** 2
            * len(sp_lens), "flash_prefill": cfg.num_layers * len(plain)}
    if {k: launches[k] for k in want} != want:
        raise RuntimeError(f"serve sp: launches {launches}, expected {want}")


def check_dispatch_modes(cfg, m: dict, launches: dict) -> None:
    """5f: some admission rode the decode batch as a lane; the 700-, 1500-
    and 1900-token prompts prefilled in 2, 3 and 4 chunks of 512 (every
    other admission in one call) and K1 launched 32 times a call; the
    host fetched fewer times than a quarter of the decode tokens."""
    if m["lane_admissions"] <= 0:
        raise RuntimeError("serve dispatch: no lane admission")
    groups = []                   # one admission's prefill calls
    for true_len, start in m["prefill_calls"]:
        if start == 0 or not groups:
            groups.append([])
        groups[-1].append(true_len)
    chunks = {sum(g): len(g) for g in groups if sum(g) > DISPATCH_CHUNK}
    if chunks != {700: 2, 1500: 3, 1900: 4}:
        raise RuntimeError(f"serve dispatch: chunked prefills {chunks}, "
                           f"expected {{700: 2, 1500: 3, 1900: 4}}")
    want = cfg.num_layers * len(m["prefill_calls"])
    if launches["flash_prefill"] != want:
        raise RuntimeError(f"serve dispatch: {launches['flash_prefill']} "
                           f"K1 launches for {len(m['prefill_calls'])} "
                           f"prefill calls, expected {want}")
    if not m["host_roundtrips"] < m["decode_tokens"] / 4:
        raise RuntimeError(f"serve dispatch: {m['host_roundtrips']} host "
                           f"fetches for {m['decode_tokens']} decode tokens")


def compare_servers(card: str, base: dict, other: dict, path: str,
                    base_path: str = "bf16") -> None:
    """Print each streamed request's TTFT and ITL on ``path`` beside the
    ``base_path`` server's for the same prompts, and the share of token
    texts the two greedy streams agree on (a number, not a gate: random
    weights give near-uniform logits, where a last-bit difference can
    decide a token)."""
    for k, v in other.items():
        if "_texts" not in v or "_texts" not in base.get(k, {}):
            continue
        a, b = base[k]["_texts"], v["_texts"]
        agree = sum(x == y for x, y in zip(a, b)) / max(len(a), 1)
        row = {"ttft_ms": [base[k]["ttft_ms"], v["ttft_ms"]],
               "itl_ms_mean": [base[k]["itl_ms_mean"], v["itl_ms_mean"]],
               "greedy_token_agreement": agree}
        log(f"request {base_path}-vs-{path} {k} {json.dumps(row)} "
            f"[{card}]")


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
    entries = [check_flash_prefill(cfg, dev),
               check_flash_prefill_partial(cfg, dev),
               check_paged_attention(cfg, dev),
               check_paged_attention(cfg, dev, int8=True),
               check_lm_head_int8(cfg, dev), check_grouped_int4(cfg, dev),
               check_ragged_attention(cfg, dev),
               check_ragged_attention(cfg, dev, int8=True)]
    entries[1]["ring"] = check_ring(cfg, dev)

    # 4. the model through the kernels vs the plain versions, per mode
    seed = 0
    for mode in MODEL_MODES:
        check_model(cfg, dev, seed, mode)
    check_sampling_noise(cfg, dev)

    # 5. serving: bf16, quantized, both again with --ragged, then bf16 with
    # sequence-parallel prefill; each path's launch counts cover its own
    # phase alone, and each kernel reports those of the first path that
    # must launch it
    by_path = {path: serve_phase(cfg, seed, card, path)
               for path in PATH_KERNELS}
    compare_servers(card, by_path["bf16"][1], by_path["sp"][1], "sp")
    compare_servers(card, by_path["int4_kv8"][1], by_path["dispatch"][1],
                    "dispatch", "int4_kv8")
    for e in entries:
        path = next(m for m, ks in PATH_KERNELS.items() if e["name"] in ks)
        e["launches"] = by_path[path][0][e["name"]]
        e["launches_path"] = path
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
