"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA GPU (marker ``cuda``): a CUDA kernel has no
CPU mode. Without a card each test skips inside the test, with a reason.
The inputs are bf16; the plain versions round scores to bf16 before the
softmax where the kernels keep f32. An output row (one query row of one
head, or one row of a matmul) is taken against its own scale: max
|kernel - plain| over the row over the RMS of the plain row, at most
ROW_REL_TOL (a few bf16 ulps of the row's largest values; the int8 head's
f32 logits differ by summation order alone). Each case plants a fault
that must exceed it: attention leaves out keys, reads a wrong block or
scale, or (ragged) shifts its causal mask by one, a split merge (K3, K4)
leaves out one split, the int8 head leaves out one strip of columns, the
grouped-int4 matmul reads the last group's scales as the first group's
(and, where it splits the contraction, its partials are merged with one
split left out). Gemma-2's modes (soft-cap, sliding window, head dim 256)
plant a window one key wider, a dropped soft-cap and a dropped window (the
dead tiles and splits run and counted). The latent kernels (K3-MLA, K4-MLA:
MLA's ``v_lanes`` over bf16 rows and ``quant_sections`` over int8 rows, at
DeepSeek-V2's widths) are held against their plain versions in f32 and
plant V read 64 lanes late, the two sections' scales swapped, the last
block dropped and (ragged) the off-by-one causal mask; their own split
partials merge to their output, and K4-MLA's pad rows (past a sequence's
count in a 4-row tile) must write nothing, each row they fall on given
its own key so that a pad's write reads far above the limit.
"""

import pytest
import torch

from dynamo_tpu_torch.engine import attention, kernels, lm_head, quant
from dynamo_tpu_torch.engine import quant_matmul

pytestmark = pytest.mark.cuda

ROW_REL_TOL = 0.1


def _row_rel_err(out, ref, rows):
    d = (out.float() - ref.float())[rows]
    r = ref.float()[rows]
    return (d.abs().amax(-1) / r.pow(2).mean(-1).sqrt()).max().item()


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("T,S,start,true_len,H,KVH,Dh", [
    (40, 128, 0, 40, 8, 2, 128),
    (33, 200, 64, 20, 8, 8, 64),      # prefix hit, padded rows, g = 1
    (16, 64, 0, 16, 32, 8, 128),
    # S off the 64-key tile, T over many row blocks (the second a grid of
    # more CTAs than three per SM hold at once)
    (300, 1000, 600, 300, 16, 2, 64),
    (1100, 1100, 0, 1030, 32, 8, 128),
    # head dim 96 (phi3, g = 1 and g = 4): 12 16-byte pieces a row, which
    # do not divide the 128 threads; the live keys end in row 61 of the
    # last 64-key tile (and fill rows 60-63 of the first ones)
    (126, 126, 0, 126, 32, 32, 96),
    (190, 700, 500, 190, 16, 4, 96),
])
def test_flash_prefill_kernel_matches_plain(T, S, start, true_len, H, KVH, Dh):
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(T)
    q, k, v = (torch.randn(shape, generator=g, device=dev).bfloat16()
               for shape in ((T, H, Dh), (S, KVH, Dh), (S, KVH, Dh)))
    seq_len = start + true_len
    n0 = kernels.FLASH_PREFILL.launches
    out = attention.flash_prefill(q, k, v, scale=Dh ** -0.5,
                                  start_pos=start, seq_len=seq_len)
    ref = attention.flash_prefill_ref(q, k, v, scale=Dh ** -0.5,
                                      start_pos=start, seq_len=seq_len)
    # planted fault: the last quarter of the chunk's keys left out
    fault = kernels.flash_prefill_cuda(q, k, v, scale=Dh ** -0.5,
                                       start_pos=start,
                                       seq_len=seq_len - true_len // 4)
    torch.cuda.synchronize()
    assert kernels.FLASH_PREFILL.launches == n0 + 2
    assert torch.isfinite(out).all()
    assert _row_rel_err(out, ref, slice(0, true_len)) <= ROW_REL_TOL
    assert _row_rel_err(fault, ref, slice(0, true_len)) > ROW_REL_TOL


# K2's m and l are compared as numbers: both sides take exact bf16 products
# summed in f32, so they differ by summation order and the kernel's base-2
# detour (|dm| ~1e-5); m returned in base-2 units is off by 0.44 m, and a
# left-out key tile moves l by its share of the row
PARTIAL_M_ATOL = 1e-3
PARTIAL_L_RTOL = 1e-3


def _partial_errors(got, ref, seen):
    """(row-relative error of acc / l, max |dm|, max |dl| / l) over the
    rows that see a key."""
    (acc, m, l), (racc, rm, rl) = got, ref
    rel = _row_rel_err(acc / l[..., None], racc / rl[..., None], seen)
    return (rel, (m - rm)[seen].abs().max().item(),
            ((l - rl).abs() / rl)[seen].max().item())


@pytest.mark.parametrize("T,S,start,seq_len,H,KVH,Dh", [
    (96, 96, 0, 96, 8, 2, 128),        # the diagonal hop
    (96, 96, 96, 96, 8, 8, 64),        # every key in the past, g = 1
    (96, 96, -40, 96, 32, 8, 128),     # dead and live rows in one CTA
    (96, 96, 0, 50, 8, 2, 128),        # the padded tail
    (300, 1000, 500, 1000, 16, 2, 128),   # S off the tile, many row blocks
    (1100, 1100, -60, 400, 32, 8, 128),   # many CTAs, dead rows first
    (96, 96, 0, 96, 32, 32, 96),       # head dim 96, the diagonal hop
    (300, 1000, 500, 1000, 16, 2, 96),
])
def test_flash_prefill_partial_kernel_matches_plain(T, S, start, seq_len, H,
                                                    KVH, Dh):
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(T + start)
    q, k, v = (torch.randn(shape, generator=g, device=dev).bfloat16()
               for shape in ((T, H, Dh), (S, KVH, Dh), (S, KVH, Dh)))
    kw = dict(scale=Dh ** -0.5, start_pos=start, seq_len=seq_len)
    n0 = kernels.FLASH_PREFILL_PARTIAL.launches
    got = attention.flash_prefill_partial(q, k, v, **kw)
    again = kernels.flash_prefill_partial_cuda(q, k, v, **kw)
    ref = attention.flash_prefill_partial_ref(q, k, v, **kw)
    # planted fault: the last 16 keys the rows can see left out
    last = min(seq_len, start + T)
    fault = kernels.flash_prefill_partial_cuda(
        q, k, v, scale=Dh ** -0.5, start_pos=start, seq_len=last - 16)
    torch.cuda.synchronize()
    assert kernels.FLASH_PREFILL_PARTIAL.launches == n0 + 3
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    seen = (start + torch.arange(T, device=dev) >= 0)[:, None].expand(T, H)
    rel, dm, dl = _partial_errors(got, ref, seen)
    assert rel <= ROW_REL_TOL and dm <= PARTIAL_M_ATOL and dl <= PARTIAL_L_RTOL
    # the rows that see nothing: exact zeros and NEG_INF
    assert (got[0][~seen] == 0).all() and (got[2][~seen] == 0).all()
    assert (got[1][~seen] == attention.NEG_INF).all()
    # planted faults: m in the kernel's base-2 units; keys left out
    base2 = (got[0], got[1] * 1.4426950408889634, got[2])
    assert _partial_errors(base2, ref, seen)[1] > PARTIAL_M_ATOL
    frel, _, fdl = _partial_errors(fault, ref, seen)
    assert frel > ROW_REL_TOL and fdl > PARTIAL_L_RTOL


def test_flash_prefill_partial_kernel_dead_hop():
    dev = _device()
    q = torch.randn((64, 8, 128), device=dev).bfloat16()
    k = torch.randn((64, 2, 128), device=dev).bfloat16()
    for start, seq_len in ((-64, 64), (0, 0)):
        acc, m, l = attention.flash_prefill_partial(
            q, k, k, scale=0.1, start_pos=start, seq_len=seq_len)
        torch.cuda.synchronize()
        assert (acc == 0).all() and (l == 0).all()
        assert (m == attention.NEG_INF).all()


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_on_one_card_matches_flash_prefill(sp):
    from dynamo_tpu_torch.parallel.ring_attention import ring_attention
    from dynamo_tpu_torch.parallel.sharding import make_mesh
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(sp)
    T, H, KVH, Dh, kv_len = 256, 8, 2, 128, 230
    q, k, v = (torch.randn(shape, generator=g, device=dev).bfloat16()
               for shape in ((T, H, Dh), (T, KVH, Dh), (T, KVH, Dh)))
    mesh = make_mesh(sp=sp, devices=[dev] * sp)
    n0 = kernels.FLASH_PREFILL_PARTIAL.launches
    out = torch.cat(ring_attention(q.chunk(sp), k.chunk(sp), v.chunk(sp),
                                   mesh, scale=Dh ** -0.5, kv_len=kv_len))
    ref = attention.flash_prefill(q, k, v, scale=Dh ** -0.5, start_pos=0,
                                  seq_len=kv_len)
    torch.cuda.synchronize()
    assert kernels.FLASH_PREFILL_PARTIAL.launches == n0 + sp * sp
    assert out.dtype == torch.bfloat16
    assert _row_rel_err(out, ref, slice(0, T)) <= ROW_REL_TOL


def test_paged_attention_kernel_matches_plain():
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(0)
    B, H, KVH, Dh, bs, M = 5, 32, 8, 128, 16, 8
    lens = torch.tensor([1, 16, 17, 0, 128], dtype=torch.int32, device=dev)
    pool = (B * M + 1) * bs
    k = torch.randn((pool, KVH * Dh), generator=g, device=dev).bfloat16()
    v = torch.randn((pool, KVH * Dh), generator=g, device=dev).bfloat16()
    tables = (torch.randperm(B * M, generator=g, device=dev) + 1).reshape(
        B, M).to(torch.int32)
    q = torch.randn((B, H, Dh), generator=g, device=dev).bfloat16()
    n0 = kernels.PAGED_ATTENTION.launches
    out = attention.paged_attention(q, k, v, tables, lens, block_size=bs,
                                    scale=Dh ** -0.5)
    ref = attention.paged_attention_ref(q, k, v, tables, lens,
                                        block_size=bs, scale=Dh ** -0.5)
    # planted fault: the longest slot's last table entry read as block 0
    bad = tables.clone()
    bad[4, 7] = 0
    fault = kernels.paged_attention_cuda(q, k, v, bad, lens, block_size=bs,
                                         scale=Dh ** -0.5)
    torch.cuda.synchronize()
    assert kernels.PAGED_ATTENTION.launches == n0 + 2
    assert torch.isfinite(out).all()
    assert out[3].abs().max().item() == 0.0
    live = lens > 0
    assert _row_rel_err(out, ref, live) <= ROW_REL_TOL
    assert _row_rel_err(fault, ref, live) > ROW_REL_TOL


def _paged_pool(gen, dev, int8, n_rows, C):
    if int8:
        return _int8_pool(n_rows, C, gen, dev), _int8_pool(n_rows, C, gen, dev)
    return tuple(torch.randn((n_rows, C), generator=gen, device=dev).bfloat16()
                 for _ in range(2))


def _split_case(dev, int8, lens, H, KVH, Dh, M, bs=16, seed=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lens)
    k, v = _paged_pool(g, dev, int8, (B * M + 1) * bs, KVH * Dh)
    tables = (torch.randperm(B * M, generator=g, device=dev) + 1).reshape(
        B, M).to(torch.int32)
    q = torch.randn((B, H, Dh), generator=g, device=dev).bfloat16()
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, tables, lens


# K3 splits each sequence into 128-key chunks (attention.decode_split_plan):
# lengths on and around the split boundaries of a 384-key table, a
# zero-length slot and an inactive one (position 0, the trash block), for
# every compiled (Dh, g) in both pools. The kernel's own partials (read
# from the scratch it was given) must match the plain split form's (m in
# the exp2 domain within 1e-3, l within 1e-3 relative: the same bf16
# products summed in another order) and merge to its output; leaving out
# one split's partial in that merge must fail the row-relative limit.
K3_GEOMS = ([(Dh, g) for Dh in (64, 96, 128) for g in (1, 2, 4, 8)]
            # the groups qwen2 (7, 6), Qwen2.5-14B (5) and Llama-3.2-3B (3)
            # bring, at the head dims that compile them
            + [(Dh, g) for Dh in (64, 128) for g in (3, 5, 6, 7)])


@pytest.mark.parametrize("Dh,g", K3_GEOMS,
                         ids=lambda p: str(p))
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_paged_attention_split_kernel_matches_plain(int8, Dh, g):
    dev = _device()
    KVH, M, bs = 2, 24, 16
    chunk, S = attention.decode_split_plan(M, bs)
    lens = [0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk, M * bs, 1]
    q, k, v, tables, seq_lens = _split_case(dev, int8, lens, KVH * g, KVH,
                                            Dh, M, bs)
    tables[-1] = 0
    kernel = kernels.PAGED_ATTENTION_INT8 if int8 else kernels.PAGED_ATTENTION
    fn = (kernels.paged_attention_int8_cuda if int8
          else kernels.paged_attention_cuda)
    kw = dict(block_size=bs, scale=Dh ** -0.5)
    scratch = kernels.paged_scratch(q, KVH, M, bs)
    n0 = kernel.launches
    out = fn(q, k, v, tables, seq_lens, scratch=scratch, **kw)
    again = attention.paged_attention(q, k, v, tables, seq_lens, **kw)
    ref = attention.paged_attention_ref(q, k, v, tables, seq_lens, **kw)
    pm, pl, pacc = attention.paged_attention_partials_ref(
        q, k, v, tables, seq_lens, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 2
    assert torch.equal(out, again)
    assert torch.isfinite(out).all()
    assert out[0].abs().max().item() == 0.0
    live = seq_lens > 0
    assert _row_rel_err(out, ref, live) <= ROW_REL_TOL
    # the kernel's partials, for the sequences with two or more live splits
    km, kl, kacc = attention.split_scratch_views(scratch, len(lens), KVH, S,
                                                 g, Dh)
    multi = [b for b, n in enumerate(lens) if n > chunk]
    for b in multi:
        n = -(-lens[b] // chunk)
        assert (km[b, :, :n] - pm[b, :, :n]).abs().max().item() <= 1e-3
        assert ((kl[b, :, :n] - pl[b, :, :n]).abs()
                / pl[b, :, :n]).max().item() <= 1e-3
    sel = torch.tensor(multi, device=dev)
    km, kl, kacc = (t[sel, :, :].clone() for t in (km, kl, kacc))
    for i, b in enumerate(multi):         # splits past the live ones: empty
        n = -(-lens[b] // chunk)
        km[i, :, n:], kl[i, :, n:], kacc[i, :, n:] = float("-inf"), 0, 0
    merged = attention.merge_split_partials(km, kl, kacc)
    assert _row_rel_err(merged, out[sel], slice(None)) <= ROW_REL_TOL
    km[:, :, 0], kl[:, :, 0], kacc[:, :, 0] = float("-inf"), 0, 0
    dropped = attention.merge_split_partials(km, kl, kacc)
    assert _row_rel_err(dropped, ref[sel], slice(None)) > ROW_REL_TOL


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_paged_attention_kernel_full_batch(int8):
    """Eight slots of 2048 keys at the 8B heads: every CTA of the grid is
    live, and two calls give the same bits."""
    dev = _device()
    M = 128
    q, k, v, tables, seq_lens = _split_case(dev, int8, [M * 16] * 8, 32, 8,
                                            128, M)
    kw = dict(block_size=16, scale=128 ** -0.5)
    out = attention.paged_attention(q, k, v, tables, seq_lens, **kw)
    again = attention.paged_attention(q, k, v, tables, seq_lens, **kw)
    ref = attention.paged_attention_ref(q, k, v, tables, seq_lens, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert _row_rel_err(out, ref, slice(None)) <= ROW_REL_TOL


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_paged_attention_kernel_full_batch_phi3(int8):
    """Phi-3-mini's decode: 32 KV heads of 96 (g = 1), eight slots of 4096
    keys under its 2047-key window, whose floors fall inside a 128-key
    split (the window is not a whole number of splits); two calls give the
    same bits, and the window left out is a planted fault."""
    dev = _device()
    M, window = 256, 2047
    q, k, v, tables, seq_lens = _split_case(dev, int8, [M * 16] * 8, 32, 32,
                                            96, M)
    win_lo = seq_lens - 1 - window
    kw = dict(block_size=16, scale=96 ** -0.5)
    out = attention.paged_attention(q, k, v, tables, seq_lens, win_lo=win_lo,
                                    **kw)
    again = attention.paged_attention(q, k, v, tables, seq_lens,
                                      win_lo=win_lo, **kw)
    ref = attention.paged_attention_ref(q, k, v, tables, seq_lens,
                                        win_lo=win_lo, **kw)
    fault = attention.paged_attention(q, k, v, tables, seq_lens, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert _row_rel_err(out, ref, slice(None)) <= ROW_REL_TOL
    assert _row_rel_err(fault, ref, slice(None)) > ROW_REL_TOL


def test_kernels_refuse_unsupported_options():
    """What the kernels still lack raises on the card, never falls back:
    a head dim they are not compiled for (80: K1, K2, K3 and K4 in both
    pools), f32 inputs, an MLA mode on a pool that is not MLA's (JAX's
    rule, attention.check_latent_modes)."""
    dev = _device()
    assert 80 not in kernels.HEAD_DIMS
    q = torch.zeros((4, 8, 80), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((16, 2, 80), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        attention.flash_prefill(q, k, k, scale=0.1, start_pos=0, seq_len=4,
                                softcap=5.0)
    with pytest.raises(ValueError):
        attention.flash_prefill_partial(q, k, k, scale=0.1, start_pos=0,
                                        seq_len=4)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    for pool in (torch.zeros((16, 160), dtype=torch.bfloat16, device=dev),
                 torch.zeros((16, 288), dtype=torch.int8, device=dev)):
        with pytest.raises(ValueError):
            attention.paged_attention(q, pool, pool, i32([[1]] * 4),
                                      i32([1] * 4), block_size=16, scale=0.1)
        with pytest.raises(ValueError):
            attention.ragged_paged_attention(
                q, pool, pool, i32([[1]]), i32([0]), i32([4]), i32([4]),
                block_size=16, scale=0.1, max_rows=64)
    q, k = q[..., :64].contiguous(), k[..., :64].contiguous()
    with pytest.raises(ValueError):
        attention.flash_prefill(q.float(), k.float(), k.float(), scale=0.1,
                                start_pos=0, seq_len=4)
    pool = torch.zeros((16, 128), dtype=torch.bfloat16, device=dev)
    tables = torch.ones((4, 1), dtype=torch.int32, device=dev)
    lens = torch.ones((4,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):         # v_lanes over 2 KV heads
        attention.paged_attention(q, pool, pool, tables, lens, block_size=16,
                                  scale=0.1, v_lanes=64)
    with pytest.raises(ValueError):
        attention.paged_attention(torch.zeros((4, 8, 32), dtype=torch.bfloat16,
                                              device=dev), pool, pool, tables,
                                  lens, block_size=16, scale=0.1)


def _int8_pool(n_rows, C, gen, dev):
    return attention.quantize_kv_rows(
        torch.randn((n_rows, C), generator=gen, device=dev).bfloat16())


def test_paged_attention_int8_kernel_matches_plain():
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(1)
    B, H, KVH, Dh, bs, M = 5, 32, 8, 128, 16, 8
    lens = torch.tensor([1, 16, 17, 0, 128], dtype=torch.int32, device=dev)
    pool = (B * M + 1) * bs
    k = _int8_pool(pool, KVH * Dh, g, dev)
    v = _int8_pool(pool, KVH * Dh, g, dev)
    tables = (torch.randperm(B * M, generator=g, device=dev) + 1).reshape(
        B, M).to(torch.int32)
    q = torch.randn((B, H, Dh), generator=g, device=dev).bfloat16()
    n0 = kernels.PAGED_ATTENTION_INT8.launches
    out = attention.paged_attention(q, k, v, tables, lens, block_size=bs,
                                    scale=Dh ** -0.5)
    ref = attention.paged_attention_ref(q, k, v, tables, lens,
                                        block_size=bs, scale=Dh ** -0.5)
    # planted fault: the longest slot's last block read with its scale
    # lanes ignored (every scale 2^0 * (1 + 0/256) = 1)
    bad_k, bad_v = k.clone(), v.clone()
    rows = tables[4, 7].long() * bs + torch.arange(bs, device=dev)
    for t in (bad_k, bad_v):
        t[rows, KVH * Dh:KVH * Dh + 2] = 0
    fault = kernels.paged_attention_int8_cuda(q, bad_k, bad_v, tables, lens,
                                              block_size=bs,
                                              scale=Dh ** -0.5)
    torch.cuda.synchronize()
    assert kernels.PAGED_ATTENTION_INT8.launches == n0 + 2
    assert torch.isfinite(out).all()
    assert out[3].abs().max().item() == 0.0
    live = lens > 0
    assert _row_rel_err(out, ref, live) <= ROW_REL_TOL
    assert _row_rel_err(fault, ref, live) > ROW_REL_TOL


@pytest.mark.parametrize("B,D,V", [(1, 1024, 2048), (8, 1024, 4100),
                                   (13, 512, 1000)])
def test_lm_head_int8_kernel_matches_plain(B, D, V):
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(B)
    x = torch.randn((B, D), generator=g, device=dev).bfloat16()
    head = quant.quantize_array(
        torch.randn((D, V), generator=g, device=dev) * D ** -0.5)
    n0 = kernels.LM_HEAD_INT8.launches
    out = lm_head.lm_head_int8(x, head.q, head.scale)
    ref = lm_head.lm_head_int8_ref(x, head.q, head.scale)
    # planted fault: the first 256-column strip left out
    fault = torch.zeros_like(out)
    fault[:, 256:] = kernels.lm_head_int8_cuda(
        x, head.q[:, 256:].contiguous(),
        head.scale.reshape(-1)[256:].contiguous())
    torch.cuda.synchronize()
    assert kernels.LM_HEAD_INT8.launches == n0 + 2
    assert out.dtype == torch.float32 and out.shape == (B, V)
    rows = slice(0, B)
    assert _row_rel_err(out, ref, rows) <= ROW_REL_TOL
    assert _row_rel_err(fault, ref, rows) > ROW_REL_TOL


# K5 on the tensor cores: one pass over the weights serves up to 16 rows
# (B = 9 takes two n-tiles); a V that is not a multiple of 16 (or 128, the
# strip) and a D that is not a multiple of 8 take the masked plain-load
# edge. Repeated calls give the same bits; the first strip (128 columns)
# left out must fail the row limit.
@pytest.mark.parametrize("D,V", [(1000, 1001), (1032, 4112), (1001, 2000)])
@pytest.mark.parametrize("B", [1, 3, 8, 9])
def test_lm_head_int8_kernel_edges(B, D, V):
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(B + V)
    x = torch.randn((B, D), generator=g, device=dev).bfloat16()
    head = quant.quantize_array(
        torch.randn((D, V), generator=g, device=dev) * D ** -0.5)
    scale = head.scale.reshape(-1).contiguous()
    n0 = kernels.LM_HEAD_INT8.launches
    out = kernels.lm_head_int8_cuda(x, head.q, scale)
    again = lm_head.lm_head_int8(x, head.q, head.scale)
    ref = lm_head.lm_head_int8_ref(x, head.q, head.scale)
    fault = torch.zeros_like(out)
    fault[:, 128:] = kernels.lm_head_int8_cuda(
        x, head.q[:, 128:].contiguous(), scale[128:].contiguous())
    torch.cuda.synchronize()
    assert kernels.LM_HEAD_INT8.launches == n0 + 3
    assert torch.equal(out, again)
    assert out.dtype == torch.float32 and out.shape == (B, V)
    assert _row_rel_err(out, ref, slice(0, B)) <= ROW_REL_TOL
    assert _row_rel_err(fault, ref, slice(0, B)) > ROW_REL_TOL


@pytest.mark.parametrize("N,D,F", [(1, 512, 384), (8, 768, 256),
                                   (40, 512, 128), (130, 1024, 384),
                                   # the two sides of the tiling edge
                                   (16, 1024, 128), (17, 256, 128),
                                   (16, 4096, 1024), (17, 4096, 1024),
                                   # 8B plans with a shorter last split
                                   (8, 14336, 4096), (16, 4096, 14336)])
def test_grouped_int4_kernel_matches_plain(N, D, F):
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(N)
    x = torch.randn((N, D), generator=g, device=dev).bfloat16()
    w = quant.quantize_array_grouped(
        torch.randn((D, F), generator=g, device=dev) * D ** -0.5)
    assert w.packed4 and quant_matmul.grouped_kernel_eligible(D, F, w.group)
    n0 = kernels.GROUPED_INT4_MATMUL.launches
    out = quant_matmul.grouped_int4_matmul(x, w.q, w.scale)
    ref = quant_matmul.grouped_int4_matmul_ref(x, w.q, w.scale)
    # planted fault: the last group's scales read as the first group's
    bad = w.scale.clone()
    bad[-1] = bad[0]
    fault = kernels.grouped_int4_matmul_cuda(x, w.q, bad)
    scratch = kernels.grouped_int4_scratch(x, F)
    again = kernels.grouped_int4_matmul_cuda(x, w.q, w.scale, scratch=scratch)
    torch.cuda.synchronize()
    assert kernels.GROUPED_INT4_MATMUL.launches == n0 + 3
    # the same bits every run (a seeded sampled stream must repeat)
    assert torch.equal(out, again)
    assert out.dtype == torch.bfloat16 and out.shape == (N, F)
    assert _row_rel_err(out, ref, slice(0, N)) <= ROW_REL_TOL
    assert _row_rel_err(fault, ref, slice(0, N)) > ROW_REL_TOL
    splits, _ = quant_matmul.int4_split_plan(N, D, F)
    assert (scratch is None) == (splits == 1)
    if scratch is not None:
        # the kernel's split partials: merged in order they give its output;
        # one split left out must fail the limit
        merge = quant_matmul.merge_int4_split_partials
        assert _row_rel_err(merge(scratch, torch.bfloat16), out,
                            slice(0, N)) <= ROW_REL_TOL
        assert _row_rel_err(merge(scratch[:-1], torch.bfloat16), ref,
                            slice(0, N)) > ROW_REL_TOL


def _ragged_inputs(gen, dev, int8: bool, H=32, KVH=8, Dh=128):
    """A ragged mix (default: the 8B head shapes): a 40-row chunk
    continuing a 100-token context (two KV tiles), a fresh 20-row chunk,
    decode rows at 1 and 128 keys, a zero-count slot, the trash sequence;
    three rows past the spans that no sequence owns."""
    bs, M = 16, 8
    spans = [(40, 100), (20, 20), (1, 1), (1, 128), (0, 0), (0, 0)]
    S = len(spans)
    starts, counts, ctx, cursor = [], [], [], 0
    for n, c in spans:
        starts.append(cursor)
        counts.append(n)
        ctx.append(c)
        cursor += n
    pool = (S * M + 1) * bs
    if int8:
        k, v = _int8_pool(pool, KVH * Dh, gen, dev), _int8_pool(
            pool, KVH * Dh, gen, dev)
    else:
        k, v = (torch.randn((pool, KVH * Dh), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
    tables = (torch.randperm(S * M, generator=gen, device=dev) + 1).reshape(
        S, M).to(torch.int32)
    tables[-1] = 0                                  # the trash sequence
    q = torch.randn((cursor + 3, H, Dh), generator=gen, device=dev).bfloat16()
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    return q, k, v, tables, i32(starts), i32(counts), i32(ctx), bs, Dh


# (H, KVH, Dh): the 8B heads (g = 4, 16 rows per CTA), then g = 1 (64 rows
# per CTA) and g = 8 (8 rows per CTA) at head dims 64 and 96 (phi3), then
# the groups whose row tiles leave pad vectors: Qwen2-7B's g = 7 (9 rows
# and one pad a CTA), Qwen2-1.5B's g = 6 at Dh 64, g = 5 and Llama-3.2-3B's
# g = 3 at Dh 128
RAGGED_GEOMS = [(32, 8, 128), (8, 8, 64), (16, 2, 64), (8, 8, 96),
                (16, 2, 96), (28, 4, 128), (12, 2, 64), (40, 8, 128),
                (24, 8, 128)]


@pytest.mark.parametrize("geom", RAGGED_GEOMS,
                         ids=lambda p: "h{}-kvh{}-dh{}".format(*p))
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_ragged_paged_attention_kernel_matches_plain(int8, geom):
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v, tables, starts, counts, ctx, bs, Dh = _ragged_inputs(
        g, dev, int8, *geom)
    kernel = (kernels.RAGGED_PAGED_ATTENTION_INT8 if int8
              else kernels.RAGGED_PAGED_ATTENTION)
    fn = (kernels.ragged_paged_attention_int8_cuda if int8
          else kernels.ragged_paged_attention_cuda)
    kw = dict(block_size=bs, scale=Dh ** -0.5, max_rows=64)
    n0 = kernel.launches
    out = attention.ragged_paged_attention(q, k, v, tables, starts, counts,
                                           ctx, **kw)
    ref = attention.ragged_paged_attention_ref(q, k, v, tables, starts,
                                               counts, ctx, **kw)
    # planted fault: an off-by-one causal mask — each chunk's rows sit one
    # position early, so each misses its own key
    fault = fn(q, k, v, tables, starts, counts,
               torch.where(counts > 1, ctx - 1, ctx), **kw)
    again = fn(q, k, v, tables, starts, counts, ctx, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 3
    assert torch.equal(out, again)
    assert torch.isfinite(out).all()
    owned = torch.zeros(q.shape[0], dtype=torch.bool, device=dev)
    for st, n in zip(starts.tolist(), counts.tolist()):
        owned[st:st + n] = True
    assert out[~owned].abs().max().item() == 0.0
    assert _row_rel_err(out, ref, owned) <= ROW_REL_TOL
    assert _row_rel_err(fault, ref, owned) > ROW_REL_TOL


# K4 at the groups that leave pad vectors in a row tile (g = 3, 5, 6, 7):
# two sequences that cross row tiles, one whose tiles have one live chunk
# (a fresh 30-row prompt: the direct write) and one whose tiles have
# several (40 rows continuing to 1000 keys: the partials and the merge),
# a decode row, the trash sequence. Every row a pad vector maps to gets its
# own key planted (chip_smoke.plant_own_keys), so that the output a pad
# vector would write over it, which lacks that key, reads far above the
# limit; four more calls give the same bits.
PAD_MIX = [(30, 30), (40, 1000), (1, 500), (0, 0)]
PAD_GEOMS = [(28, 4, 128), (14, 2, 64), (12, 2, 64), (12, 2, 128),
             (40, 8, 128), (24, 8, 128)]


@pytest.mark.parametrize("geom", PAD_GEOMS,
                         ids=lambda p: "h{}-kvh{}-dh{}".format(*p))
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_ragged_kernel_writes_no_pad_vector(int8, geom):
    from chip_smoke import pad_vectors_written, plant_own_keys
    dev = _device()
    H, KVH, Dh = geom
    g, bs, M = H // KVH, 16, 64
    gen = torch.Generator(device=dev).manual_seed(6)
    S = len(PAD_MIX)
    starts_l, cursor = [], 0
    for n, _ in PAD_MIX:
        starts_l.append(cursor)
        cursor += n
    k, v = _paged_pool(gen, dev, int8, (S * M + 1) * bs, KVH * Dh)
    tables = (torch.randperm(S * M, generator=gen, device=dev) + 1).reshape(
        S, M).to(torch.int32)
    tables[-1] = 0
    q = torch.randn((cursor, H, Dh), generator=gen, device=dev).bfloat16()
    crossed = plant_own_keys(k, q, tables, starts_l, PAD_MIX, g, bs)
    assert {s for s, _ in crossed} == {0, 1}
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    args = (q, k, v, tables, i32(starts_l), i32([n for n, _ in PAD_MIX]),
            i32([c for _, c in PAD_MIX]))
    kw = dict(block_size=bs, scale=Dh ** -0.5, max_rows=64)
    out = attention.ragged_paged_attention(*args, **kw)
    again = [attention.ragged_paged_attention(*args, **kw) for _ in range(4)]
    ref = attention.ragged_paged_attention_ref(*args, **kw)
    fault = pad_vectors_written(out, q, k, v, tables, starts_l, PAD_MIX,
                                crossed, g, block_size=bs, scale=kw["scale"])
    torch.cuda.synchronize()
    assert all(torch.equal(out, a) for a in again)
    assert torch.isfinite(out).all()
    assert _row_rel_err(out, ref, slice(None)) <= ROW_REL_TOL
    assert _row_rel_err(fault, ref, slice(None)) > ROW_REL_TOL


def test_attention_kernels_refuse_groups_outside_the_table():
    """K3 and K4 take the groups of kernels.GROUPS for the head dim and
    raise on any other, in both pools, never handing the call to the plain
    version: groups above 8, and 7 at head dims 96 and 256."""
    dev = _device()
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    for Dh, g in ((128, 9), (64, 16), (96, 7), (256, 7)):
        assert Dh in kernels.HEAD_DIMS and g not in kernels.GROUPS[Dh]
        q = torch.zeros((4, g, Dh), dtype=torch.bfloat16, device=dev)
        for pool in (torch.zeros((16, Dh), dtype=torch.bfloat16, device=dev),
                     torch.zeros((16, Dh + 128), dtype=torch.int8,
                                 device=dev)):
            n0 = {k: x.launches for k, x in kernels.KERNELS.items()}
            with pytest.raises(ValueError, match="GROUPS"):
                attention.paged_attention(q, pool, pool, i32([[1]] * 4),
                                          i32([1] * 4), block_size=16,
                                          scale=0.1)
            with pytest.raises(ValueError, match="GROUPS"):
                attention.ragged_paged_attention(
                    q, pool, pool, i32([[1]]), i32([0]), i32([4]), i32([4]),
                    block_size=16, scale=0.1, max_rows=64)
            assert n0 == {k: x.launches for k, x in kernels.KERNELS.items()}


def test_ragged_kernel_refuses_unsupported_options():
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v, tables, starts, counts, ctx, bs, Dh = _ragged_inputs(g, dev,
                                                                  False)
    with pytest.raises(ValueError):         # sections need an int8 pool
        attention.ragged_paged_attention(q, k, v, tables, starts, counts, ctx,
                                         block_size=bs, scale=0.1,
                                         max_rows=64, quant_sections=(64, 64))
    with pytest.raises(ValueError):
        attention.ragged_paged_attention(q, k, v, tables, starts,
                                         counts[:-1], ctx, block_size=bs,
                                         scale=0.1, max_rows=64)


# K4 splits each row tile's keys into chunks (K3's 128-key plan, twice
# that for wide tiles: attention.ragged_row_plan) and merges
# them in the launch: a 768-key table (six 128-key splits at 16-token
# blocks) with decode rows that see 127, 128, 129 and 256 keys, a 20-row
# chunk whose rows straddle the first boundary, a 16-row chunk ending at
# 700 keys (a wide tile over three 256-key splits where g >= 4), a chunk that
# ends on the table's last key, a zero-count sequence, the trash sequence
# and three rows no sequence owns, for every geometry of RAGGED_GEOMS in
# both pools. The
# kernel's own partials (read from the scratch it was given, for the rows
# whose tile has two or more live splits) must match the plain split form's
# (m in the exp2 domain within 1e-3, l within 1e-3 relative: the same bf16
# products summed in another order) and merge to its output; leaving out
# each such row's first split in that merge must fail the row limit.
SPLIT_SPANS = [(1, 127), (1, 128), (1, 129), (1, 256), (20, 140), (0, 0),
               (16, 700), (12, 768), (0, 0)]


def _ragged_split_inputs(gen, dev, int8, H, KVH, Dh, bs=16, M=48):
    S = len(SPLIT_SPANS)
    starts, cursor = [], 0
    for n, _ in SPLIT_SPANS:
        starts.append(cursor)
        cursor += n
    k, v = _paged_pool(gen, dev, int8, (S * M + 1) * bs, KVH * Dh)
    tables = (torch.randperm(S * M, generator=gen, device=dev) + 1).reshape(
        S, M).to(torch.int32)
    tables[-1] = 0                                  # the trash sequence
    q = torch.randn((cursor + 3, H, Dh), generator=gen, device=dev).bfloat16()
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    return (q, k, v, tables, i32(starts), i32([n for n, _ in SPLIT_SPANS]),
            i32([c for _, c in SPLIT_SPANS]))


@pytest.mark.parametrize("geom", RAGGED_GEOMS,
                         ids=lambda p: "h{}-kvh{}-dh{}".format(*p))
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_ragged_split_kernel_matches_plain(int8, geom):
    dev = _device()
    H, KVH, Dh = geom
    g, bs, M = H // KVH, 16, 48
    gen = torch.Generator(device=dev).manual_seed(5)
    args = _ragged_split_inputs(gen, dev, int8, H, KVH, Dh, bs, M)
    q, k, v, tables, starts, counts, ctx = args
    TT = q.shape[0]
    kernel = (kernels.RAGGED_PAGED_ATTENTION_INT8 if int8
              else kernels.RAGGED_PAGED_ATTENTION)
    fn = (kernels.ragged_paged_attention_int8_cuda if int8
          else kernels.ragged_paged_attention_cuda)
    kw = dict(block_size=bs, scale=Dh ** -0.5, max_rows=32)
    chunk, S = attention.decode_split_plan(M, bs)
    scratch = kernels.paged_scratch(q, KVH, M, bs)
    n0 = kernel.launches
    out = fn(*args, scratch=scratch, **kw)
    again = attention.ragged_paged_attention(*args, **kw)
    ref = attention.ragged_paged_attention_ref(*args, **kw)
    pm, pl, _ = attention.ragged_attention_partials_ref(*args, **kw)
    # planted fault: an off-by-one causal mask inside each chunk
    fault = fn(q, k, v, tables, starts, counts,
               torch.where(counts > 1, ctx - 1, ctx), **kw)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 3
    assert torch.equal(out, again)
    assert torch.isfinite(out).all()
    owned = torch.zeros(TT, dtype=torch.bool, device=dev)
    for st, n in zip(starts.tolist(), counts.tolist()):
        owned[st:st + n] = True
    assert out[~owned].abs().max().item() == 0.0
    assert _row_rel_err(out, ref, owned) <= ROW_REL_TOL
    assert _row_rel_err(fault, ref, owned) > ROW_REL_TOL
    # the kernel's partials of the rows whose tile has two or more splits
    _, live = attention.ragged_row_plan(starts, counts, ctx, TT, g, M, bs)
    multi = [r for r in range(TT) if live[r] > 1]
    assert multi
    km, kl, kacc = (t[multi].clone() for t in attention.split_scratch_views(
        scratch, TT, KVH, S, g, Dh))
    for i, r in enumerate(multi):
        n = int(live[r])
        got_m, want_m = km[i, :, :n], pm[r, :, :n].to(dev)
        assert torch.equal(torch.isneginf(got_m), torch.isneginf(want_m))
        fin = torch.isfinite(want_m)
        assert (got_m[fin] - want_m[fin]).abs().max().item() <= 1e-3
        want_l = pl[r, :, :n].to(dev)
        assert ((kl[i, :, :n][fin] - want_l[fin]).abs()
                / want_l[fin]).max().item() <= 1e-3
        km[i, :, n:], kl[i, :, n:], kacc[i, :, n:] = float("-inf"), 0, 0
    merged = attention.merge_split_partials(km, kl, kacc)
    assert _row_rel_err(merged, out[multi], slice(None)) <= ROW_REL_TOL
    # planted merge fault: each such row's first split left out
    km[:, :, 0], kl[:, :, 0], kacc[:, :, 0] = float("-inf"), 0, 0
    dropped = attention.merge_split_partials(km, kl, kacc)
    assert _row_rel_err(dropped, ref[multi], slice(None)) > ROW_REL_TOL


# ---------------------------------------------------------------------------
# Gemma-2's modes: logit soft-capping, sliding windows, head dim 256
# ---------------------------------------------------------------------------

# q is scaled so that the scores (std ~6 in natural units) reach the bend
# of the 50 soft-cap, and the plain version runs in f32 on the same bf16
# inputs: its bf16 form rounds such scores by up to ~0.1 before the
# softmax, more than the kernels' own error. Each case plants three
# faults: the window one key wider (">=" for ">"), the soft-cap dropped,
# and the window dropped (the dead tiles and splits run and counted).
Q_GAIN = 6.0
CAP = 50.0


def _gained(q):
    return (q.float() * Q_GAIN).bfloat16()


def _f32(t):
    return t if t.dtype == torch.int8 else t.float()


# (T, S, start_pos, true_len, window): a prefix hit whose rows' floors
# cross many key tiles; a fresh prompt whose window is one 64-key tile
# (Dh 128) or two 32-key tiles (Dh 256); a window of one 32-key tile
GEMMA_PREFILL = [(200, 704, 500, 190, 96), (130, 130, 0, 130, 64),
                 (64, 160, 96, 64, 32)]


@pytest.mark.parametrize("case", GEMMA_PREFILL, ids=str)
@pytest.mark.parametrize("Dh,H,KVH", [(256, 16, 8), (128, 8, 2),
                                      (96, 8, 8)],
                         ids=["dh256", "dh128", "dh96"])
def test_flash_prefill_gemma_modes_match_plain(Dh, H, KVH, case):
    dev = _device()
    T, S, start, true_len, window = case
    g = torch.Generator(device=dev).manual_seed(T + Dh)
    q = _gained(torch.randn((T, H, Dh), generator=g, device=dev))
    k, v = (torch.randn((S, KVH, Dh), generator=g, device=dev).bfloat16()
            for _ in range(2))
    kw = dict(scale=Dh ** -0.5, start_pos=start, seq_len=start + true_len)
    n0 = kernels.FLASH_PREFILL.launches
    out = attention.flash_prefill(q, k, v, sliding=True, window=window,
                                  softcap=CAP, **kw)
    again = kernels.flash_prefill_cuda(q, k, v, window=window, softcap=CAP,
                                       **kw)
    glob = attention.flash_prefill(q, k, v, sliding=False, window=window,
                                   softcap=CAP, **kw)
    ref, gref = (attention.flash_prefill_ref(
        q.float(), k.float(), v.float(), sliding=sl, window=window,
        softcap=CAP, **kw) for sl in (True, False))
    faults = [kernels.flash_prefill_cuda(q, k, v, **kw, **f) for f in (
        dict(window=window + 1, softcap=CAP), dict(window=window),
        dict(softcap=CAP))]
    torch.cuda.synchronize()
    assert kernels.FLASH_PREFILL.launches == n0 + 6
    assert torch.equal(out, again)
    rows = slice(0, true_len)
    assert _row_rel_err(out, ref, rows) <= ROW_REL_TOL
    assert _row_rel_err(glob, gref, rows) <= ROW_REL_TOL
    for f in faults:
        assert _row_rel_err(f, ref, rows) > ROW_REL_TOL


# K3 over a 640-key table (five 128-key splits) with a 200-key window:
# sequences whose first live key is 0, 1, 128 (a split boundary), 129, 257
# and 440, one that sees a single key, a zero-length slot
GEMMA_LENS = [1, 200, 201, 328, 329, 457, 640, 0]
GEMMA_WINDOW = 200


@pytest.mark.parametrize("Dh,g", [(256, 2), (256, 8), (128, 4), (96, 2),
                                  (96, 4)],
                         ids=lambda p: str(p))
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_paged_attention_gemma_modes_match_plain(int8, Dh, g):
    dev = _device()
    KVH, M, bs = 4, 40, 16
    q, k, v, tables, seq_lens = _split_case(dev, int8, GEMMA_LENS, KVH * g,
                                            KVH, Dh, M, bs, seed=6)
    q = _gained(q)
    win_lo = seq_lens - 1 - GEMMA_WINDOW
    kernel = kernels.PAGED_ATTENTION_INT8 if int8 else kernels.PAGED_ATTENTION
    fn = (kernels.paged_attention_int8_cuda if int8
          else kernels.paged_attention_cuda)
    kw = dict(block_size=bs, scale=Dh ** -0.5, softcap=CAP)
    n0 = kernel.launches
    out = attention.paged_attention(q, k, v, tables, seq_lens, win_lo=win_lo,
                                    **kw)
    again = fn(q, k, v, tables, seq_lens, win_lo=win_lo, **kw)
    glob = attention.paged_attention(q, k, v, tables, seq_lens, **kw)
    ref, gref = (attention.paged_attention_ref(
        q.float(), _f32(k), _f32(v), tables, seq_lens, win_lo=w, **kw)
        for w in (win_lo, None))
    faults = [fn(q, k, v, tables, seq_lens, **{**kw, **f}) for f in (
        dict(win_lo=win_lo - 1), dict(win_lo=win_lo, softcap=0.0), dict())]
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 6
    assert torch.equal(out, again)
    assert torch.isfinite(out).all()
    assert out[-1].abs().max().item() == 0.0
    live = seq_lens > 0
    assert _row_rel_err(out, ref, live) <= ROW_REL_TOL
    assert _row_rel_err(glob, gref, live) <= ROW_REL_TOL
    for f in faults:
        assert _row_rel_err(f, ref, live) > ROW_REL_TOL


# K4 over the same table and window, (rows, kv length) per sequence:
# decode rows at 200, 201 and 329 keys, a 20-row chunk whose floors cross
# the 128-key split boundary, a 40-row chunk ending at the table's last key
# (wide tiles over 256-key splits), a zero-count slot, a 12-row chunk; then
# the trash sequence
GEMMA_SPANS = [(1, 200), (1, 201), (1, 329), (20, 340), (40, 640), (0, 0),
               (12, 457), (0, 0)]


@pytest.mark.parametrize("geom", [(16, 8, 256), (32, 8, 128),
                                  (32, 32, 96)],
                         ids=lambda p: "h{}-kvh{}-dh{}".format(*p))
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_ragged_attention_gemma_modes_match_plain(int8, geom):
    dev = _device()
    H, KVH, Dh = geom
    bs, M = 16, 40
    gen = torch.Generator(device=dev).manual_seed(7)
    S = len(GEMMA_SPANS)
    counts = torch.tensor([n for n, _ in GEMMA_SPANS], dtype=torch.int32,
                          device=dev)
    ctx = torch.tensor([c for _, c in GEMMA_SPANS], dtype=torch.int32,
                       device=dev)
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    k, v = _paged_pool(gen, dev, int8, (S * M + 1) * bs, KVH * Dh)
    tables = (torch.randperm(S * M, generator=gen, device=dev) + 1).reshape(
        S, M).to(torch.int32)
    tables[-1] = 0                                  # the trash sequence
    TT = int(counts.sum()) + 3
    q = _gained(torch.randn((TT, H, Dh), generator=gen, device=dev))
    win_base = torch.where(counts > 0, ctx - counts - GEMMA_WINDOW,
                           attention.RAGGED_WIN_SENTINEL).to(torch.int32)
    kernel = (kernels.RAGGED_PAGED_ATTENTION_INT8 if int8
              else kernels.RAGGED_PAGED_ATTENTION)
    fn = (kernels.ragged_paged_attention_int8_cuda if int8
          else kernels.ragged_paged_attention_cuda)
    args = (tables, starts, counts, ctx)
    kw = dict(block_size=bs, scale=Dh ** -0.5, max_rows=64, softcap=CAP)
    n0 = kernel.launches
    out = attention.ragged_paged_attention(q, k, v, *args,
                                           win_base=win_base, **kw)
    again = fn(q, k, v, *args, win_base=win_base, **kw)
    glob = attention.ragged_paged_attention(q, k, v, *args, **kw)
    sentinel = fn(q, k, v, *args, win_base=torch.full_like(
        win_base, attention.RAGGED_WIN_SENTINEL), **kw)
    ref, gref = (attention.ragged_paged_attention_ref(
        q.float(), _f32(k), _f32(v), *args, win_base=w, **kw)
        for w in (win_base, None))
    faults = [fn(q, k, v, *args, **{**kw, **f}) for f in (
        dict(win_base=win_base - 1), dict(win_base=win_base, softcap=0.0),
        dict())]
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 7
    assert torch.equal(out, again)
    assert torch.equal(glob, sentinel)     # the global sentinel never masks
    owned = torch.zeros(TT, dtype=torch.bool, device=dev)
    for st, n in zip(starts.tolist(), counts.tolist()):
        owned[st:st + n] = True
    assert out[~owned].abs().max().item() == 0.0
    assert _row_rel_err(out, ref, owned) <= ROW_REL_TOL
    assert _row_rel_err(glob, gref, owned) <= ROW_REL_TOL
    for f in faults:
        assert _row_rel_err(f, ref, owned) > ROW_REL_TOL


# --------------------------------------------------------------- MLA modes

# DeepSeek-V2's latent widths (the latent kernels' compiled shape): 16
# heads, query [q_lat 512 | q_pe 64 | 0 64], rows of 640 bf16 or 768 int8
LATENT_M = 24


def _latent_inputs(gen, dev, int8, lens, n_rows=None, max_len=LATENT_M * 16,
                   compact=False):
    bs = 32 if int8 else 16
    M = max_len // bs
    # the pool: M blocks a row, or (compact) the blocks the lengths use
    nb = (sum(-(-n // bs) for n in lens) if compact else len(lens) * M) + 1
    vals = torch.randn((nb * bs, 576), generator=gen, device=dev)
    vals[:, 512:] *= 8.0
    if int8:
        pool = torch.zeros((nb * bs, 768), dtype=torch.int8, device=dev)
        pool[:, :704] = attention.quantize_kv_rows_sections(vals, (512, 64))
    else:
        pool = torch.zeros((nb * bs, 640), dtype=torch.bfloat16, device=dev)
        pool[:, :576] = vals.bfloat16()
    perm = (torch.randperm(nb - 1, generator=gen, device=dev) + 1).int()
    tables = torch.zeros((len(lens), M), dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(lens):
        k = -(-n // bs)
        tables[b, :k] = perm[used:used + k]
        used += k
    q = torch.randn((n_rows or len(lens), 16, 640), generator=gen,
                    device=dev) * 0.1
    q[..., 576:] = 0
    kw = dict(block_size=bs, scale=192 ** -0.5, v_lanes=512,
              quant_sections=(512, 64) if int8 else None)
    return (q.bfloat16(), pool, tables,
            torch.tensor(lens, dtype=torch.int32, device=dev), kw)


def _latent_faults(call, q, pool, tables, lens, int8, bs):
    longest = max(range(len(lens)), key=lambda b: lens[b])
    bad = tables.clone()
    bad[longest, (lens[longest] - 1) // bs] = 0
    out = [call(tt=bad)]
    if int8:
        sw = pool.clone()
        sw[:, 576:578], sw[:, 578:580] = pool[:, 578:580], pool[:, 576:578]
        out.append(call(pp=sw))
    else:
        out.append(call(qq=torch.roll(q, -64, -1).contiguous(),
                        pp=torch.roll(pool, -64, -1).contiguous()))
    return out


def _latent_partials_merged(scratch, rows, live, out, splits):
    """The latent kernel's own partials of ``rows`` ({row: live splits of
    ``splits``, attention.latent_split_plan}), read from the room it was
    given and merged in plain PyTorch: the row error against its
    output."""
    sel = sorted(live)
    m, l, acc = (t[sel].clone() for t in attention.split_scratch_views(
        scratch, rows, 1, splits, 16, 512))
    for i, r in enumerate(sel):
        n = live[r]
        m[i, :, n:], l[i, :, n:], acc[i, :, n:] = float("-inf"), 0, 0
    return _row_rel_err(attention.merge_split_partials(m, l, acc), out[sel],
                        slice(None))


@pytest.mark.parametrize("int8", [False, True], ids=["v_lanes", "sections"])
def test_latent_paged_kernel_matches_plain(int8):
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(21)
    lens = [1, 127, 128, 129, 300, 384, 0]
    q, pool, tables, sl, kw = _latent_inputs(gen, dev, int8, lens)
    kernel = (kernels.LATENT_PAGED_ATTENTION_INT8 if int8
              else kernels.LATENT_PAGED_ATTENTION)
    scratch = kernels.paged_scratch(q, 1, tables.shape[1], kw["block_size"],
                                    512)

    def call(qq=q, pp=pool, tt=tables):
        return attention.paged_attention(qq, pp, pp, tt, sl, **kw)
    n0 = kernel.launches
    out, again = call(), call()
    written = kernels.latent_paged_attention_cuda(q, pool, tables, sl,
                                                  scratch=scratch, **kw)
    ref = attention.paged_attention_ref(q.float(), pool if int8
                                        else pool.float(), None, tables, sl,
                                        **kw)
    faults = _latent_faults(call, q, pool, tables, lens, int8,
                            kw["block_size"])
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 5
    assert out.shape == (len(lens), 16, 512) and torch.equal(out, again)
    assert torch.equal(out, written)
    live = sl > 0
    assert out[~live].abs().max().item() == 0.0
    assert _row_rel_err(out, ref, live) <= ROW_REL_TOL
    for f in faults:
        assert _row_rel_err(f, ref, live) > ROW_REL_TOL
    # the kernel's own partials (latent_decode_splits(B) splits of the keys
    # each row sees, over 8 clusters a row here) merge to its output
    S = attention.latent_decode_splits(len(lens))
    assert attention.latent_decode_clusters(len(lens)) == 8
    multi = {b: attention.latent_split_plan(n, S)[1]
             for b, n in enumerate(lens)
             if attention.latent_split_plan(n, S)[1] > 1}
    assert sorted(multi) == [1, 2, 3, 4, 5]
    assert _latent_partials_merged(scratch, len(lens), multi, out,
                                   S) <= ROW_REL_TOL


# K3-MLA's plan at the lengths around its 32-key tiles and at V2-Lite's
# 4096: alone (B = 1) and as a batch of 8
LATENT_LENS = [0, 1, 127, 128, 129, 4096]


@pytest.mark.parametrize("lens", [[n] for n in LATENT_LENS]
                         + [LATENT_LENS + [4096, 129]],
                         ids=[f"b1-{n}" for n in LATENT_LENS] + ["b8"])
@pytest.mark.parametrize("int8", [False, True], ids=["v_lanes", "sections"])
def test_latent_paged_kernel_lengths(int8, lens):
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(24 + len(lens))
    q, pool, tables, sl, kw = _latent_inputs(gen, dev, int8, lens,
                                             max_len=4096)
    out, again = (kernels.latent_paged_attention_cuda(q, pool, tables, sl,
                                                      **kw)
                  for _ in range(2))
    ref = attention.paged_attention_ref(q.float(), pool if int8
                                        else pool.float(), None, tables, sl,
                                        **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.isfinite(out).all()
    live = sl > 0
    if not live.all():
        assert out[~live].abs().max().item() == 0.0
    if live.any():
        assert _row_rel_err(out, ref, live) <= ROW_REL_TOL


def _latent_ref_by_row(q, pool, tables, lens, int8, kw):
    """paged_attention_ref row by row over the table entries each row
    reads (a long context's gathered rows, in f32, at no more than one
    row's size)."""
    bs, wide = kw["block_size"], pool if int8 else pool.float()
    rows = []
    for b, n in enumerate(lens.tolist()):
        k = max(-(-n // bs), 1)
        rows.append(attention.paged_attention_ref(
            q[b:b + 1].float(), wide, None, tables[b:b + 1, :k].contiguous(),
            lens[b:b + 1], **kw))
    return torch.cat(rows)


# K3-MLA at V2-Lite's long contexts (32K, its 64K): alone, in a batch of 8
# and in a batch of 64, where a row is one cluster of 4 splits and a 64K
# row's CTA spans more table entries than it keeps in shared memory
LATENT_LONG = {1: lambda L: [L],
               8: lambda L: [L, L - 1, 32641, 4097, 129, 1, 0, L // 2 + 7],
               64: lambda L: [L] + [1 + 37 * b for b in range(63)]}


@pytest.mark.parametrize("max_len", [32768, 65536])
@pytest.mark.parametrize("B", sorted(LATENT_LONG))
@pytest.mark.parametrize("int8", [False, True], ids=["v_lanes", "sections"])
def test_latent_paged_kernel_long_context(int8, B, max_len):
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(26 + B)
    lens = LATENT_LONG[B](max_len)
    q, pool, tables, sl, kw = _latent_inputs(gen, dev, int8, lens,
                                             max_len=max_len, compact=True)
    out, again = (kernels.latent_paged_attention_cuda(q, pool, tables, sl,
                                                      **kw)
                  for _ in range(2))
    ref = _latent_ref_by_row(q, pool, tables, sl, int8, kw)
    # the fault: the longest row's second half of table entries (past a
    # CTA's shared-memory span at 64K) read as the trash block
    bad, nblk = tables.clone(), -(-lens[0] // kw["block_size"])
    bad[0, nblk // 2:nblk] = 0
    fault = kernels.latent_paged_attention_cuda(q, pool, bad, sl, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.isfinite(out).all()
    live = sl > 0
    if not live.all():
        assert out[~live].abs().max().item() == 0.0
    assert _row_rel_err(out, ref, live) <= ROW_REL_TOL
    assert _row_rel_err(fault, ref, slice(0, 1)) > ROW_REL_TOL


@pytest.mark.parametrize("int8", [False, True], ids=["v_lanes", "sections"])
def test_latent_ragged_kernel_long_context(int8):
    # a 5-row chunk ending at 139264 keys: a bf16 tile's split spans more
    # table entries than a CTA keeps in shared memory
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(27)
    spans = [(5, 139264), (1, 70001), (0, 0), (2, 32768)]
    counts_l = [n for n, _ in spans]
    q, pool, tables, ctx, kw = _latent_inputs(gen, dev, int8,
                                              [c for _, c in spans],
                                              n_rows=sum(counts_l),
                                              max_len=139264, compact=True)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    args = (tables, i32([sum(counts_l[:i]) for i in range(len(spans))]),
            i32(counts_l), ctx)
    kw["max_rows"] = 64
    out, again = (kernels.latent_ragged_attention_cuda(q, pool, *args, **kw)
                  for _ in range(2))
    ref = attention.ragged_paged_attention_ref(
        q.float(), pool if int8 else pool.float(), None, *args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.isfinite(out).all()
    assert _row_rel_err(out, ref, slice(None)) <= ROW_REL_TOL


@pytest.mark.parametrize("int8", [False, True], ids=["v_lanes", "sections"])
def test_latent_ragged_kernel_matches_plain(int8):
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(22)
    spans = [(20, 140), (9, 9), (1, 33), (1, 384), (0, 0)]
    counts_l = [n for n, _ in spans]
    TT = sum(counts_l)
    q, pool, tables, ctx, kw = _latent_inputs(gen, dev, int8,
                                              [c for _, c in spans],
                                              n_rows=TT + 3)
    starts = torch.tensor([sum(counts_l[:i]) for i in range(len(spans))],
                          dtype=torch.int32, device=dev)
    counts = torch.tensor(counts_l, dtype=torch.int32, device=dev)
    kw["max_rows"] = 32
    M = tables.shape[1]
    scratch = kernels.paged_scratch(q, 1, M, kw["block_size"], 512,
                                    ragged=True)

    def call(qq=q, pp=pool, tt=tables, lens=ctx, **f):
        return kernels.latent_ragged_attention_cuda(qq, pp, tt, starts,
                                                    counts, lens, **kw, **f)
    out, again = attention.ragged_paged_attention(
        q, pool, pool, tables, starts, counts, ctx, **kw), call(
            scratch=scratch)
    ref = attention.ragged_paged_attention_ref(
        q.float(), pool if int8 else pool.float(), None, tables, starts,
        counts, ctx, **kw)
    faults = _latent_faults(call, q, pool, tables, [c for _, c in spans],
                            int8, kw["block_size"])
    faults.append(call(lens=torch.where(counts > 1, ctx - 1, ctx)))
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.isfinite(out).all()
    assert out[TT:].abs().max().item() == 0.0
    rows = slice(0, TT)
    assert _row_rel_err(out, ref, rows) <= ROW_REL_TOL
    for f in faults:
        assert _row_rel_err(f, ref, rows) > ROW_REL_TOL
    # the kernel's own partials (LATENT_TILE_ROWS rows a tile, each tile's
    # keys in LATENT_SPLITS splits) merge to it
    _, live = attention.ragged_row_plan(starts, counts, ctx, TT + 3, 16, M,
                                        kw["block_size"],
                                        attention.LATENT_TILE_ROWS)
    multi = {r: int(live[r]) for r in range(TT) if live[r] > 1}
    assert len(multi) == 22
    assert _latent_partials_merged(scratch, TT + 3, multi, out,
                                   attention.LATENT_SPLITS) <= ROW_REL_TOL


# counts that leave pad rows in K4-MLA's 4-row tiles, each falling on the
# next sequence's first rows (and the last one's past q)
LATENT_PAD_MIX = [(6, 200), (3, 301), (1, 384), (7, 64), (2, 100), (0, 0)]


@pytest.mark.parametrize("int8", [False, True], ids=["v_lanes", "sections"])
def test_latent_ragged_kernel_writes_no_pad_row(int8):
    from chip_smoke import (latent_pad_crossings, latent_pad_rows_written,
                            plant_latent_own_keys)
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(25)
    mix = LATENT_PAD_MIX
    starts_l = [sum(n for n, _ in mix[:s]) for s in range(len(mix))]
    TT = sum(n for n, _ in mix)
    q, pool, tables, ctx, kw = _latent_inputs(gen, dev, int8,
                                              [c for _, c in mix],
                                              n_rows=TT)
    crossed = latent_pad_crossings(starts_l, mix, TT)
    assert [row for _, _, row in crossed] == [6, 7, 9, 10, 11, 12, 17]
    plant_latent_own_keys(pool, q, tables, starts_l, mix, crossed,
                          kw["block_size"], 576,
                          (512, 64) if int8 else None)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    args = (tables, i32(starts_l), i32([n for n, _ in mix]), ctx)
    kw["max_rows"] = 64
    out, *again = (kernels.latent_ragged_attention_cuda(q, pool, *args, **kw)
                   for _ in range(4))
    wide = pool if int8 else pool.float()
    ref = attention.ragged_paged_attention_ref(q.float(), wide, None, *args,
                                               **kw)
    fault = latent_pad_rows_written(
        out, q.float(), wide, tables, mix, crossed,
        **{k: v for k, v in kw.items() if k != "max_rows"})
    torch.cuda.synchronize()
    assert all(torch.equal(out, a) for a in again)
    assert torch.isfinite(out).all()
    assert _row_rel_err(out, ref, slice(None)) <= ROW_REL_TOL
    assert _row_rel_err(fault, ref, slice(None)) > ROW_REL_TOL


def test_latent_kernels_refuse_unsupported_options():
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(23)
    q, pool, tables, sl, kw = _latent_inputs(gen, dev, False, [5, 9])
    with pytest.raises(ValueError):          # 8 heads: not compiled
        kernels.latent_paged_attention_cuda(q[:, :8].contiguous(), pool,
                                            tables, sl, **kw)
    with pytest.raises(ValueError):          # no soft-cap in the modes
        attention.paged_attention(q, pool, pool, tables, sl, softcap=30.0,
                                  **kw)


def test_mla_decode_refuses_int8_rank_the_kernels_lack():
    """A latent rank that is not 128-aligned (tiny_mla's 64) has no
    sectioned kernel mode: a decode step over an int8 CUDA pool raises
    rather than gathering in plain PyTorch. (Over a bf16 pool such a rank
    takes K3 itself, the row as K and V over one KV head.)"""
    from dynamo_tpu_torch.engine.config import bench_model_config
    from dynamo_tpu_torch.engine.models import mla
    from dynamo_tpu_torch.engine.weights import init_params
    dev = _device()
    cfg = bench_model_config("tiny_mla")
    assert cfg.kv_lora_rank % 128
    bs, M = 16, 4
    params = init_params(cfg, 0, dev, torch.bfloat16)
    kv = mla.init_kv_cache(cfg, M + 1, bs, dev, torch.bfloat16,
                           quantization="int8")
    tables = torch.arange(1, M + 1, dtype=torch.int32,
                          device=dev)[None].repeat(2, 1)
    with pytest.raises(ValueError):
        mla.decode_forward(params, kv, torch.tensor([3, 4], device=dev),
                           torch.tensor([5, 9], dtype=torch.int32,
                                        device=dev), tables, cfg, bs)
