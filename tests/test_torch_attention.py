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
