"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA GPU (marker ``cuda``): a CUDA kernel has no
CPU mode. Without a card each test skips inside the test, with a reason.
The inputs are bf16; the plain versions round scores to bf16 before the
softmax where the kernels keep f32. An output row (one query row of one
head) is a convex combination of N(0, 1) value rows whose size falls as
1/sqrt(keys seen), so each row's error is taken against its own scale:
max |kernel - plain| over the row over the RMS of the plain row, at most
ROW_REL_TOL (a few bf16 ulps of the row's largest values). A planted fault
that leaves out the last keys must exceed it.
"""

import pytest
import torch

from dynamo_tpu_torch.engine import attention, kernels

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


def test_kernels_refuse_unsupported_options():
    dev = _device()
    q = torch.zeros((4, 8, 64), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((16, 2, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(NotImplementedError):
        attention.flash_prefill(q, k, k, scale=0.1, start_pos=0, seq_len=4,
                                softcap=5.0)
    with pytest.raises(ValueError):
        attention.flash_prefill(q.float(), k.float(), k.float(), scale=0.1,
                                start_pos=0, seq_len=4)
