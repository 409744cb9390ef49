"""The PyTorch port's attention against the JAX package's, on the CPU.

The port's plain ``flash_prefill`` / ``paged_attention`` (the CPU side of
its dispatch) must compute what the JAX package's Pallas kernels compute
in interpret mode, and what its XLA reference paths compute. Inputs come
from one numpy generator and go to both packages as numpy arrays.

Tolerance (f32): atol=2e-5, rtol=1e-5. Both sides compute the same f32
arithmetic; the sums run in another order (XLA's and PyTorch's matmuls,
the Pallas kernel's online softmax), and there is nothing more to it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamo_tpu.engine import attention as jattn
from dynamo_tpu_torch.engine import attention as tattn

ATOL, RTOL = 2e-5, 1e-5

# the Pallas kernels' interpret mode needs KVH*Dh % 128 == 0 and a block
# size % 8 == 0 (attention.pallas_supported / flash_prefill_supported);
# the decode kernel runs one sequence per program (seqs_per_program=1),
# which interprets several times faster than the default 8, and is called
# once for the whole module (a fixed seconds-long cost per call)
H, KVH, DH, BS = 4, 2, 64, 8


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("T,S,start,true_len,sliding,window,softcap", [
    (24, 48, 0, 24, False, None, None),      # fresh prompt
    (16, 48, 16, 16, False, None, None),     # prefix hit: start_pos > 0
    (24, 48, 0, 10, False, None, None),      # padded queries past true_len
    (24, 48, 8, 20, True, 8, None),          # sliding-window layer
    (24, 48, 0, 24, False, None, 5.0),       # logit soft-capping
])
def test_flash_prefill_matches_jax(T, S, start, true_len, sliding, window,
                                   softcap):
    rng = np.random.default_rng(T * 1000 + start + true_len)
    q = rng.standard_normal((T, H, DH), dtype=np.float32)
    k = rng.standard_normal((S, KVH, DH), dtype=np.float32)
    v = rng.standard_normal((S, KVH, DH), dtype=np.float32)
    scale = DH ** -0.5
    seq_len = start + true_len
    got = tattn.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=scale,
                              start_pos=start, seq_len=seq_len,
                              sliding=sliding, window=window,
                              softcap=softcap)
    want = jattn.flash_prefill(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), scale=scale,
                               start_pos=start, seq_len=seq_len,
                               sliding=sliding, window=window,
                               softcap=softcap, interpret=True)
    assert np.isfinite(got.numpy()).all()
    _close(got, want)
    if not sliding and softcap is None:
        ref = jattn.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), scale=scale,
                                     kv_offset=start, length=seq_len)
        _close(got, ref)


def _paged_inputs(seed, seq_lens, M=4, num_blocks=24):
    rng = np.random.default_rng(seed)
    B = len(seq_lens)
    q = rng.standard_normal((B, H, DH), dtype=np.float32)
    k = rng.standard_normal((num_blocks * BS, KVH * DH), dtype=np.float32)
    v = rng.standard_normal((num_blocks * BS, KVH * DH), dtype=np.float32)
    perm = rng.permutation(np.arange(1, num_blocks)).astype(np.int32)
    tables = np.zeros((B, M), np.int32)
    used = 0
    for b, n in enumerate(seq_lens):
        nb = -(-n // BS)
        tables[b, :nb] = perm[used:used + nb]
        used += nb
    return q, k, v, tables, np.asarray(seq_lens, np.int32)


# one decode batch covers every slot kind: lengths 1 … several blocks over
# a shuffled table, a zero-length (padded) slot, and an inactive slot
# (position 0, all-zero table: it reads the trash block's row 0)
PAGED_LENS = [1, 7, 8, 9, 25, 32, 0, 1]
ZERO_SLOT, TRASH_SLOT = 6, 7


@pytest.fixture(scope="module")
def paged_case():
    q, k, v, tables, lens = _paged_inputs(3, PAGED_LENS)
    tables[TRASH_SLOT] = 0
    scale = DH ** -0.5
    got = tattn.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), torch.from_numpy(lens), block_size=BS,
        scale=scale).numpy()
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(tables), jnp.asarray(lens))
    # coalesce=False: the per-block DMA path, bit-identical to the
    # coalesced one and cheaper to interpret
    pallas = jattn.paged_attention_pallas(*args, block_size=BS, scale=scale,
                                          seqs_per_program=1, coalesce=False,
                                          interpret=True)
    xla = jattn.paged_attention_xla(*args, block_size=BS, scale=scale)
    return got, np.asarray(pallas), np.asarray(xla), lens


def test_paged_attention_matches_jax_pallas(paged_case):
    got, pallas, _, _ = paged_case
    assert np.isfinite(got).all()
    _close(got, pallas)                      # empty slot: zeros on both


def test_paged_attention_matches_jax_xla(paged_case):
    got, _, xla, lens = paged_case
    live = lens > 0
    _close(got[live], xla[live])
    assert not got[ZERO_SLOT].any()


def test_paged_attention_trash_table_slot_is_finite(paged_case):
    got, pallas, _, _ = paged_case
    assert np.isfinite(got[TRASH_SLOT]).all()
    _close(got[TRASH_SLOT], pallas[TRASH_SLOT])


def test_sliding_window_and_softcap_decode_match_xla():
    q, k, v, tables, lens = _paged_inputs(11, [20, 13, 3])
    scale = DH ** -0.5
    win_lo = (lens - 1) - 8          # trailing window of 8 at each position
    got = tattn.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), torch.from_numpy(lens), block_size=BS,
        scale=scale, softcap=4.0, win_lo=torch.from_numpy(win_lo)).numpy()
    want = jattn.paged_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(lens), block_size=BS, scale=scale, softcap=4.0,
        win_lo=jnp.asarray(win_lo))
    _close(got, want)


# K3's split arithmetic (csrc/paged_attention.cu, flash-decoding): the
# plain split form (per-split f32 partials, then the merge in the kernel's
# order) against the JAX package's Pallas kernel in interpret mode and its
# XLA path, same tolerance as above (f32, another order of the sums). A
# 320-key table gives three 128-key splits; the lengths sit on and around
# the split boundaries. Blocks of 32 rows (the int8 Pallas tile, kept here
# so both pools share the plan), 6 s of interpretation per group size.
SPLIT_BS, SPLIT_M = 32, 10


def _split_lens():
    chunk, _ = tattn.decode_split_plan(SPLIT_M, SPLIT_BS)
    # the last slot is inactive: position 0 over the trash block
    return [0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk, SPLIT_M * SPLIT_BS,
            1]


def _split_inputs(seed, g, int8):
    rng = np.random.default_rng(seed)
    lens = np.asarray(_split_lens(), np.int32)
    B, C = len(lens), KVH * DH
    num_blocks = B * SPLIT_M + 1
    pools = [rng.standard_normal((num_blocks * SPLIT_BS, C), dtype=np.float32)
             for _ in range(2)]
    if int8:
        pools = [np.asarray(jattn.quantize_kv_rows(jnp.asarray(p)))
                 for p in pools]
    tables = (rng.permutation(num_blocks - 1)[:B * SPLIT_M] + 1).reshape(
        B, SPLIT_M).astype(np.int32)
    tables[-1] = 0
    q = rng.standard_normal((B, KVH * g, DH), dtype=np.float32)
    return q, pools[0], pools[1], tables, lens


def split_case(g, int8):
    """(split form, its partials, Pallas, XLA, lens) for group size g."""
    q, k, v, tables, lens = _split_inputs(20 + g, g, int8)
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, tables, lens)]
    kw = dict(block_size=SPLIT_BS, scale=DH ** -0.5)
    parts = tattn.paged_attention_partials_ref(*t, **kw)
    got = tattn.merge_split_partials(*parts).numpy()
    args = [jnp.asarray(a) for a in (q, k, v, tables, lens)]
    pallas = jattn.paged_attention_pallas(*args, **kw, seqs_per_program=1,
                                          coalesce=False, interpret=True)
    xla = jattn.paged_attention_xla(*args, **kw)
    return got, parts, np.asarray(pallas), np.asarray(xla), lens


def row_rel(a, b):
    """Per (slot, head) row: max |a - b| over the RMS of b's row."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max(-1) / np.sqrt((b ** 2).mean(-1))


@pytest.fixture(scope="module", params=[1, 2, 4, 8], ids=lambda g: f"g{g}")
def bf16_split_case(request):
    return split_case(request.param, int8=False)


def test_paged_split_ref_matches_jax_pallas(bf16_split_case):
    got, _, pallas, _, lens = bf16_split_case
    assert np.isfinite(got).all()
    _close(got, pallas)
    assert not got[lens == 0].any()          # zero-length slot: exact zeros


def test_paged_split_ref_matches_jax_xla(bf16_split_case):
    got, _, _, xla, lens = bf16_split_case
    _close(got[lens > 0], xla[lens > 0])


def test_paged_split_ref_dropped_split_fails(bf16_split_case):
    """A merge that leaves out one split's partial must fail the
    comparison by far: each sequence with two or more live splits loses
    its first one (a whole chunk of keys), and every row of such a
    sequence moves by more than the card tests' 0.1 row-relative limit."""
    _, (m, l, acc), pallas, _, lens = bf16_split_case
    chunk, _ = tattn.decode_split_plan(SPLIT_M, SPLIT_BS)
    m, l, acc = m.clone(), l.clone(), acc.clone()
    multi = [b for b, n in enumerate(lens) if n > chunk]
    for b in multi:
        m[b, :, 0] = float("-inf")
        l[b, :, 0] = 0
        acc[b, :, 0] = 0
    dropped = tattn.merge_split_partials(m, l, acc).numpy()
    assert np.isfinite(dropped).all()
    assert row_rel(dropped[multi], pallas[multi]).min() > 0.1
    others = [b for b in range(len(lens)) if b not in multi]
    _close(dropped[others], pallas[others])


@pytest.mark.parametrize("block_size", [8, 16, 32, 48, 64, 256])
@pytest.mark.parametrize("max_blocks", [1, 7, 128])
def test_decode_split_plan_covers_the_table(block_size, max_blocks):
    chunk, splits = tattn.decode_split_plan(max_blocks, block_size)
    assert chunk % block_size == 0 and chunk >= tattn.DECODE_CHUNK_TOKENS
    assert chunk - block_size < tattn.DECODE_CHUNK_TOKENS
    assert (splits - 1) * chunk < max_blocks * block_size <= splits * chunk


def test_merge_of_empty_splits_is_zero_not_nan():
    m = torch.full((1, 2, 3, 4), float("-inf"))
    l = torch.zeros((1, 2, 3, 4))
    acc = torch.zeros((1, 2, 3, 4, 8))
    out = tattn.merge_split_partials(m, l, acc)
    assert out.shape == (1, 8, 8) and (out == 0).all()
    # one live split among empty ones is that split's normalised acc
    m[0, :, 1], l[0, :, 1], acc[0, :, 1] = 0.5, 2.0, 3.0
    assert torch.allclose(tattn.merge_split_partials(m, l, acc),
                          torch.full((1, 8, 8), 1.5))
