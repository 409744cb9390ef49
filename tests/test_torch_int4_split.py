"""K6's split arithmetic against the JAX package's grouped-int4 matmul, on the CPU.

The CUDA kernel ``csrc/grouped_int4_matmul.cu`` cuts the D/128 contraction
groups into the ranges of ``int4_split_plan``, one CTA per (128-column
strip, 128-row tile, range), wherever its grid alone would leave SMs idle
(always at decode, N <= 16), and sums the ranges' f32 partials in index
order. Its plain split form, ``grouped_int4_matmul_split_ref``, is held
here against the JAX package's Pallas kernel in interpret mode:

- at tiny eligible shapes (D 256-1024, F 128-384, N 1, 8, 16, 17, 40), with
  the plan sized for a card of a few SMs, so that the 8B shapes' kinds of
  plan appear: ranges of several groups with a shorter last one (4096 ->
  14336 and 14336 -> 4096 at decode), equal ranges (4096 -> 4096), one
  group per range (4096 -> 1024), and split prefill tiles (N 17 and 40);
- at the four 8B shapes' own plans, at their real D with 128 columns.

Tolerance: f32 inputs on both sides, the same products summed in another
order, so 2e-5 of the output's largest value, the bar of
``test_torch_quant.py``'s grouped-int4 case. A reduction that leaves out
one range must fail it, and also the card tests' 0.1 row-relative limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import quant as jquant
from dynamo_tpu.engine.quant_matmul import (grouped_int4_matmul as
                                            j_grouped_int4_matmul)
from dynamo_tpu_torch.engine.quant_matmul import (
    DECODE_ROWS, GROUP, STRIP, grouped_int4_matmul_ref,
    grouped_int4_matmul_split_ref, grouped_int4_split_partials_ref,
    int4_split_plan, merge_int4_split_partials)

TOL = 2e-5
ROW_REL_TOL = 0.1

# (D, F, SMs of a scaled-down card); the plans at N = 1 and N = 17
TINY = [(1024, 384, 4),     # 3 ranges of 3, 3, 2 groups; prefill unsplit
        (1024, 128, 2),     # 4 ranges of 2 groups; prefill unsplit
        (768, 256, 2),      # 2 ranges of 3 groups; prefill unsplit
        (1024, 256, 6),     # 4 ranges of 2 groups; prefill the same
        (512, 128, 3),      # 4 ranges of 1 group; prefill the same
        (256, 384, 8)]      # 2 ranges of 1 group; prefill the same
TINY_N = [1, 8, 16, 17, 40]

# the Llama-3-8B layer matmuls (D, F): wq/wo, wk/wv, gate/up, down
SHAPES_8B = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


def _case(N, D, F, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = rng.standard_normal((D, F)).astype(np.float32)
    qa = jquant.quantize_array_grouped(jnp.asarray(w), group=GROUP, bits=4)
    want = np.asarray(j_grouped_int4_matmul(jnp.asarray(x), qa.q, qa.scale,
                                            interpret=True))
    t = (torch.from_numpy(x), torch.from_numpy(np.array(qa.q)),
         torch.from_numpy(np.array(qa.scale)))
    return t, want


def _row_rel(got, want):
    d = np.abs(got - want).max(-1)
    return (d / np.sqrt((want ** 2).mean(-1))).max()


def _check(t, want, plan):
    got = grouped_int4_matmul_split_ref(*t, plan).numpy()
    atol = TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(grouped_int4_matmul_ref(*t).numpy(), got,
                               rtol=0, atol=atol)
    splits = plan[0]
    if splits == 1:
        return
    parts = grouped_int4_split_partials_ref(*t, plan)
    assert parts.shape == (splits, want.shape[0], want.shape[1])
    for s in range(splits):
        keep = [i for i in range(splits) if i != s]
        fault = merge_int4_split_partials(parts[keep], torch.float32).numpy()
        assert np.abs(fault - want).max() > atol
        assert _row_rel(fault, want) > ROW_REL_TOL


@pytest.mark.parametrize("N", TINY_N)
@pytest.mark.parametrize("D,F,sms", TINY)
def test_split_ref_matches_pallas_interpret(N, D, F, sms):
    plan = int4_split_plan(N, D, F, sms=sms)
    t, want = _case(N, D, F, seed=N * 7 + D + F)
    _check(t, want, plan)


@pytest.mark.parametrize("N", [1, 8])
@pytest.mark.parametrize("D,F", SHAPES_8B)
def test_split_ref_at_the_8b_plans(N, D, F):
    """Each 8B shape's own plan, at its real D over 128 columns."""
    plan = int4_split_plan(N, D, F)
    assert plan[0] > 1
    t, want = _case(N, D, STRIP, seed=D + F + N)
    _check(t, want, plan)


@pytest.mark.parametrize("N", [1, 8, 16])
@pytest.mark.parametrize("D,F", SHAPES_8B)
def test_plan_fills_the_card_at_8b_decode(N, D, F):
    splits, per = int4_split_plan(N, D, F)
    assert splits * (F // STRIP) >= 2 * 128     # at least ~2 CTAs per SM
    assert 1 < splits <= D // GROUP and per >= 1


@pytest.mark.parametrize("sms", [1, 3, 7, 33, 132, 1000])
@pytest.mark.parametrize("D,F", [(256, 128), (768, 128), (1280, 256),
                                 (1792, 384), (4096, 1024), (14336, 4096),
                                 (4096, 14336)])
def test_plan_covers_every_group_once(D, F, sms):
    groups = D // GROUP
    for N in (1, 16, 17, 300, 2048):
        splits, per = int4_split_plan(N, D, F, sms=sms)
        ranges = [range(s * per, min((s + 1) * per, groups))
                  for s in range(splits)]
        assert all(len(r) > 0 for r in ranges)
        assert sorted(g for r in ranges for g in r) == list(range(groups))
        if N > DECODE_ROWS:
            # the prefill tiling splits only a grid of fewer than sms / 2
            tiles = (F // STRIP) * -(-N // 128)
            assert (splits == 1) == (2 * tiles >= sms)


def test_plan_at_the_8b_shapes_and_uneven_ranges():
    """The plans PERF.md reports, three of them with a shorter last range
    (D/128 not a multiple of the split count)."""
    assert int4_split_plan(8, 4096, 14336) == (3, 11)     # 11, 11, 10
    assert int4_split_plan(8, 14336, 4096) == (9, 13)     # 8 x 13, then 8
    assert int4_split_plan(8, 4096, 4096) == (8, 4)
    assert int4_split_plan(8, 4096, 1024) == (32, 1)
    assert int4_split_plan(17, 14336, 4096) == (9, 13)
    assert int4_split_plan(17, 4096, 14336) == (1, 32)
    assert int4_split_plan(512, 4096, 1024) == (8, 4)
    assert int4_split_plan(512, 14336, 4096) == (1, 112)
