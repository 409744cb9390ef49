"""K4's split arithmetic against the JAX package's ragged attention, on the CPU.

The CUDA kernel ``csrc/ragged_paged_attention.cu`` cuts each row tile's
keys into chunks, one CTA per chunk, and merges the chunks' f32 partials
in index order: a tile of at most 16 live (row, head) query vectors takes
the chunk of ``attention.decode_split_plan`` (128 keys rounded up to whole
blocks), wider tiles twice that (``ragged_row_plan``). Its plain split form,
``attention.ragged_attention_partials_ref`` completed by
``attention.merge_split_partials``, is held here against the JAX package's
ragged Pallas kernel in interpret mode and its XLA decode attention over
row-expanded tables, over f32 pools and int8 pools (the pool bytes from
JAX's ``quantize_kv_rows``, fed to both).

The mix sits on and around the split boundaries of a 640-key table (five
128-key splits at 32-token blocks, the int8 Pallas tile): decode rows that
see 127, 128, 129 and 256 keys, a 20-row chunk whose rows straddle the
first boundary, a 16-row chunk ending at 600 keys (at g = 4 and 8 one
wide tile over three 256-key splits), a chunk that ends on the table's
last key, a zero-count sequence and rows no sequence owns. Tolerances are test_torch_ragged.py's:
f32 2e-5 (JAX's own bar for this kernel; another order of the f32 sums)
and 2e-4 for int8 rows (JAX's int8 bar). A merge that leaves out one
split must move every row that has two or more live splits by more than
the card tests' 0.1 row-relative limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import attention as jattn
from dynamo_tpu_torch.engine import attention as tattn

F32_TOL = 2e-5
INT8_TOL = 2e-4
BS, M = 32, 20                   # 640 keys: five 128-key splits
MAX_ROWS = 32

# (rows, kv length) per sequence
SPANS = [(1, 127), (1, 128), (1, 129), (1, 256), (20, 140), (0, 0),
         (16, 600), (12, 640), (1, 1)]

# (H, KVH, Dh): g = 4, 1 and 8, each with 128 value lanes per pool row
GEOMS = [(4, 1, 128), (2, 2, 64), (8, 1, 128)]


def _inputs(seed, H, KVH, Dh, int8):
    rng = np.random.default_rng(seed)
    S = len(SPANS)
    C = KVH * Dh
    num_blocks = S * M + 1
    pools = [rng.standard_normal((num_blocks * BS, C), dtype=np.float32)
             for _ in range(2)]
    if int8:
        pools = [np.asarray(jattn.quantize_kv_rows(jnp.asarray(p)))
                 for p in pools]
    tables = (rng.permutation(num_blocks - 1)[:S * M] + 1).reshape(
        S, M).astype(np.int32)
    starts, cursor = [], 0
    for n, _ in SPANS:
        starts.append(cursor)
        cursor += n
    counts = np.asarray([n for n, _ in SPANS], np.int32)
    ctx = np.asarray([c for _, c in SPANS], np.int32)
    q = rng.standard_normal((cursor + 3, H, Dh), dtype=np.float32)
    return q, pools[0], pools[1], tables, np.asarray(starts, np.int32), \
        counts, ctx


def _owned_rows():
    """(flat row, its sequence, the keys it sees) of every owned row."""
    out, cursor = [], 0
    for s, (n, c) in enumerate(SPANS):
        for r in range(n):
            out.append((cursor + r, s, c - n + r + 1))
        cursor += n
    return out


def _case(H, KVH, Dh, int8):
    q, k, v, tables, starts, counts, ctx = _inputs(
        30 + H + KVH + Dh + int8, H, KVH, Dh, int8)
    t = [torch.from_numpy(np.array(a))
         for a in (q, k, v, tables, starts, counts, ctx)]
    kw = dict(block_size=BS, scale=Dh ** -0.5)
    parts = tattn.ragged_attention_partials_ref(*t, **kw, max_rows=MAX_ROWS)
    got = tattn.merge_split_partials(*parts).numpy()
    pallas = jattn.ragged_paged_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v, tables, starts, counts, ctx)),
        **kw, max_rows=MAX_ROWS, chunk_blocks=2, interpret=True)
    rows = _owned_rows()
    idx = np.asarray([r for r, _, _ in rows])
    xla = jattn.paged_attention_xla(
        jnp.asarray(q[idx]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables[[s for _, s, _ in rows]]),
        jnp.asarray(np.asarray([n for _, _, n in rows], np.int32)), **kw)
    return got, parts, np.asarray(pallas), np.asarray(xla), idx


@pytest.fixture(scope="module", params=[(g, p) for g in GEOMS
                                        for p in (False, True)],
                ids=lambda p: "h{}-kvh{}-dh{}-".format(*p[0])
                + ("int8" if p[1] else "f32"))
def split_case(request):
    geom, int8 = request.param
    return (*_case(*geom, int8), INT8_TOL if int8 else F32_TOL)


def row_rel(a, b):
    """Per (row, head): max |a - b| over the RMS of b's row."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max(-1) / np.sqrt((b ** 2).mean(-1))


def test_ragged_split_ref_matches_jax_pallas(split_case):
    got, _, pallas, _, idx, tol = split_case
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[idx], pallas[idx], rtol=tol, atol=tol)
    unowned = np.ones(got.shape[0], bool)
    unowned[idx] = False
    assert not got[unowned].any()            # rows no sequence owns: zeros


def test_ragged_split_ref_matches_jax_xla(split_case):
    got, _, _, xla, idx, tol = split_case
    np.testing.assert_allclose(got[idx], xla, rtol=tol, atol=tol)


def _row_chunks(g):
    """Each flat row's chunk under K4's plan (0: unowned)."""
    counts = torch.tensor([n for n, _ in SPANS], dtype=torch.int32)
    starts = torch.cumsum(counts, 0) - counts
    ctx = torch.tensor([c for _, c in SPANS], dtype=torch.int32)
    TT = int(counts.sum()) + 3
    return tattn.ragged_row_plan(starts, counts, ctx, TT, g, M, BS)[0]


def test_ragged_split_ref_partials_follow_the_plan(split_case):
    """Each owned row's live splits are those its keys reach in its tile's
    chunk; the others, and every split of an unowned row, are (-inf, 0,
    0)."""
    _, (m, l, acc), _, _, idx, _ = split_case
    _, S = tattn.decode_split_plan(M, BS)
    assert m.shape[2] == S == 5
    chunks = _row_chunks(m.shape[3])
    live = np.zeros(m.shape[:1] + (S,), bool)
    for r, _, n in _owned_rows():
        live[r, :-(-n // int(chunks[r]))] = True
    live = torch.from_numpy(live)[:, None, :, None].expand(m.shape)
    assert torch.isfinite(m[live]).all() and (l[live] > 0).all()
    assert torch.isneginf(m[~live]).all()
    assert not l[~live].any() and not acc[~live].any()


def test_ragged_split_ref_dropped_split_fails(split_case):
    """Leaving out each multi-split row's first split (a whole chunk of its
    keys) moves every such row by more than 0.1 of its RMS; the rows with
    one live split are untouched."""
    _, (m, l, acc), pallas, _, _, tol = split_case
    chunks = _row_chunks(m.shape[3])
    multi = [r for r, _, n in _owned_rows() if n > chunks[r]]
    single = [r for r, _, n in _owned_rows() if n <= chunks[r]]
    assert multi and single
    m, l, acc = m.clone(), l.clone(), acc.clone()
    m[multi, :, 0], l[multi, :, 0], acc[multi, :, 0] = float("-inf"), 0, 0
    dropped = tattn.merge_split_partials(m, l, acc).numpy()
    assert np.isfinite(dropped).all()
    assert row_rel(dropped[multi], pallas[multi]).min() > 0.1
    np.testing.assert_allclose(dropped[single], pallas[single], rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("max_rows,g,tiles", [(64, 4, 4), (8, 4, 1),
                                              (136, 1, 3), (1, 8, 1),
                                              (9, 8, 2)])
def test_ragged_row_tiles(max_rows, g, tiles):
    """K4's grid: 64 / g rows of a sequence per CTA."""
    assert tattn.ragged_row_tiles(max_rows, g) == tiles


def test_ragged_row_plan_widens_the_chunk_of_wide_tiles():
    """At g = 4 (16 rows a tile): a decode row and a tile of 4 rows keep
    K3's 128-key chunk, a tile of 5 or more rows doubles it; a tile's live
    splits come from the keys its last row sees."""
    counts = torch.tensor([1, 20, 8], dtype=torch.int32)
    starts = torch.tensor([0, 1, 21], dtype=torch.int32)
    ctx = torch.tensor([300, 600, 200], dtype=torch.int32)
    chunks, live = tattn.ragged_row_plan(starts, counts, ctx, 31, 4, 40, 16)
    assert chunks.tolist() == ([128] + [256] * 16 + [128] * 4 + [256] * 8
                               + [0] * 2)
    assert live.tolist() == [3] + [3] * 16 + [5] * 4 + [1] * 8 + [0] * 2


def test_ragged_split_ref_refuses_counts_above_max_rows():
    q, k, v, tables, starts, counts, ctx = _inputs(1, 4, 1, 128, False)
    t = [torch.from_numpy(np.array(a))
         for a in (q, k, v, tables, starts, counts, ctx)]
    with pytest.raises(ValueError, match="max_rows"):
        tattn.ragged_attention_partials_ref(*t, block_size=BS, scale=0.1,
                                            max_rows=8)
