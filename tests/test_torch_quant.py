"""The PyTorch port's quantization against the JAX package's, on the CPU.

- The quantizers (int8 per-channel, grouped int4 with packing, int8 KV rows
  with in-row scales) give the same bytes as the JAX package's: int8
  payloads and packed bytes exactly equal, scales within f32 rtol=1e-6.
- The plain versions of the three kernels of this slice match the JAX
  package's Pallas kernels run in interpret mode: the int8 LM head (K5),
  the grouped-int4 matmul (K6) and paged decode attention over an int8
  pool (K3's int8 mode), the last also against the XLA path.
- ``quant.mm`` equals the JAX ``mm`` for int8 and grouped weights.
- ``kv_block_size=0`` resolves to the JAX package's block size, and an
  unknown quantization is refused with ``ValueError``.

Inputs come from numpy generators and go to both packages. Tolerances, all
f32: the same arithmetic summed in another order (XLA's, PyTorch's and the
interpreted kernels' matmuls), so atol=2e-5 relative to the output's size
unless a case says otherwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine import quant as jquant
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.lm_head import lm_head_int8 as j_lm_head_int8
from dynamo_tpu.engine.quant_matmul import (grouped_int4_matmul as
                                            j_grouped_int4_matmul)
from dynamo_tpu.engine.quant_matmul import (grouped_kernel_eligible as
                                            j_grouped_kernel_eligible)
from dynamo_tpu_torch.engine import attention as tattn
from dynamo_tpu_torch.engine import quant as tquant
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.engine.lm_head import lm_head_int8
from dynamo_tpu_torch.engine.quant_matmul import (grouped_int4_matmul,
                                                  grouped_kernel_eligible)
from dynamo_tpu_torch.engine.weights import init_params
from tests.test_torch_attention import SPLIT_BS, SPLIT_M, row_rel, split_case


def _np(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_same_quant(jq, tq):
    assert jq.group == tq.group and jq.packed4 == tq.packed4
    np.testing.assert_array_equal(tq.q.numpy(), _np(jq.q))
    np.testing.assert_allclose(tq.scale.numpy(), _np(jq.scale), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("shape,keep_axes", [
    ((3, 64, 96), (0, -1)),      # stacked layer matmul: per (layer, column)
    ((96, 64), (0,)),            # embedding: per row
    ((64, 300), (-1,)),          # lm head: per column
])
def test_quantize_array_matches_jax(shape, keep_axes):
    w = np.random.default_rng(sum(shape)).standard_normal(shape,
                                                          dtype=np.float32)
    w[0] *= 40.0                 # one outlier row per tensor
    _assert_same_quant(jquant.quantize_array(jnp.asarray(w),
                                             keep_axes=keep_axes),
                       tquant.quantize_array(_t(w), keep_axes=keep_axes))


@pytest.mark.parametrize("shape", [
    (2, 256, 384),               # two 128-row groups, packed
    (2, 64, 96),                 # D % 128 != 0: one whole-axis group
    (1, 63, 32),                 # odd D: unpacked, int8-held
])
def test_quantize_array_grouped_matches_jax(shape):
    w = np.random.default_rng(shape[1]).standard_normal(shape,
                                                        dtype=np.float32)
    jq = jquant.quantize_array_grouped(jnp.asarray(w))
    tq = tquant.quantize_array_grouped(_t(w))
    _assert_same_quant(jq, tq)
    if tq.packed4:
        np.testing.assert_array_equal(
            tquant.unpack_int4_rows(tq.q).numpy(),
            _np(jquant.unpack_int4_rows(jq.q)).astype(np.int8))
    np.testing.assert_allclose(tq.dequantize().numpy(),
                               _np(jq.dequantize()), rtol=1e-6, atol=0)


def test_pack_int4_rows_matches_jax_on_every_nibble_pair():
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8), indexing="ij")
    q = np.stack([lo.ravel(), hi.ravel()]).astype(np.int8)      # [2, 256]
    q = np.tile(q, (2, 1))                                        # [4, 256]
    packed = tquant.pack_int4_rows(_t(q))
    np.testing.assert_array_equal(packed.numpy(),
                                  _np(jquant.pack_int4_rows(jnp.asarray(q))))
    np.testing.assert_array_equal(tquant.unpack_int4_rows(packed).numpy(), q)


def test_quantize_kv_rows_match_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((512, 128))
         * rng.uniform(1e-3, 1e3, (512, 1))).astype(np.float32)
    x[0] = 0.0                                # all-zero row
    x[1, :] = 127.0 * 2.0 ** np.arange(-8, 8).repeat(8)[:128]   # powers of 2
    x[2, 0] = 127.0 * 8                        # absmax/127 exactly 2^3
    got = tattn.quantize_kv_rows(_t(x)).numpy()
    want = _np(jattn.quantize_kv_rows(jnp.asarray(x)))
    # floor(log2) of an exact power of two could differ between torch and
    # XLA, so the rows above include exact powers of two: none differs
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tattn.dequant_kv_rows(_t(got), 128, torch.float32).numpy(),
        _np(jattn.dequant_kv_rows(jnp.asarray(want), 128, jnp.float32)))


@pytest.mark.parametrize("B,D,V", [(8, 128, 512), (1, 128, 256),
                                   (33, 128, 768)])
def test_lm_head_int8_plain_matches_pallas_interpret(B, D, V):
    rng = np.random.default_rng(B * 1000 + V)
    # bf16 activations: the Pallas kernel casts x to bf16 before its dot
    x = jnp.asarray(rng.standard_normal((B, D)), jnp.bfloat16)
    w = rng.standard_normal((D, V)).astype(np.float32)
    qa = jquant.quantize_array(jnp.asarray(w), keep_axes=(-1,))
    want = _np(j_lm_head_int8(x, qa.q, qa.scale, interpret=True))
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    got = lm_head_int8(xt, _t(qa.q), _t(qa.scale))
    assert got.dtype == torch.float32 and got.shape == (B, V)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    # the 1-D form (one prefill row) and the [V] / [V, 1] scale layouts
    for scale in (_t(qa.scale).reshape(V), _t(qa.scale).reshape(V, 1)):
        one = lm_head_int8(xt[0], _t(qa.q), scale)
        np.testing.assert_allclose(one.numpy(), want[0], rtol=0,
                                   atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("N,D,F", [(5, 256, 384), (32, 512, 256),
                                   (130, 256, 128)])
def test_grouped_int4_matmul_plain_matches_pallas_interpret(N, D, F):
    rng = np.random.default_rng(N)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = rng.standard_normal((D, F)).astype(np.float32)
    qa = jquant.quantize_array_grouped(jnp.asarray(w), group=128, bits=4)
    assert grouped_kernel_eligible(D, F, 128)
    assert j_grouped_kernel_eligible(N, D, F, 128)
    want = _np(j_grouped_int4_matmul(jnp.asarray(x), qa.q, qa.scale,
                                     interpret=True))
    got = grouped_int4_matmul(_t(x), _t(qa.q), _t(qa.scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("d,f,group", [(384, 256, 128), (256, 256, 256),
                                       (256, 200, 128), (1024, 128, 128),
                                       (4096, 14336, 128), (14336, 4096, 128),
                                       (4096, 1024, 128)])
def test_grouped_kernel_eligibility_is_the_jax_rule(d, f, group):
    assert grouped_kernel_eligible(d, f, group) == j_grouped_kernel_eligible(
        8, d, f, group)


@pytest.mark.parametrize("kind", ["int8", "int4", "int4_whole_axis"])
def test_mm_matches_jax(kind):
    rng = np.random.default_rng(len(kind))
    D = 64 if kind == "int4_whole_axis" else 256
    x = rng.standard_normal((6, D)).astype(np.float32)
    w = rng.standard_normal((D, 128)).astype(np.float32)
    if kind == "int8":
        jw = jquant.quantize_array(jnp.asarray(w[None]), keep_axes=(0, -1))
        tw = tquant.quantize_array(_t(w[None]), keep_axes=(0, -1))
    else:
        jw = jquant.quantize_array_grouped(jnp.asarray(w[None]))
        tw = tquant.quantize_array_grouped(_t(w[None]))
    want = _np(jquant.mm(jnp.asarray(x), jw[0]))
    got = tquant.mm(_t(x), tw[0]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


# K3's int8 mode: the Pallas kernel needs KVH*Dh % 128 == 0 and a block of
# 32 rows for int8 pools (its sublane tile); one sequence per program and
# per-block DMAs interpret several times faster than the defaults
H, KVH, DH, BS = 4, 2, 64, 32
PAGED_LENS = [1, 31, 32, 33, 70, 0, 1]
ZERO_SLOT, TRASH_SLOT = 5, 6


@pytest.fixture(scope="module")
def paged_int8_case():
    rng = np.random.default_rng(12)
    B, M, num_blocks = len(PAGED_LENS), 3, 16
    C = KVH * DH
    q = rng.standard_normal((B, H, DH), dtype=np.float32)
    k = _np(jattn.quantize_kv_rows(jnp.asarray(
        rng.standard_normal((num_blocks * BS, C), dtype=np.float32))))
    v = _np(jattn.quantize_kv_rows(jnp.asarray(
        rng.standard_normal((num_blocks * BS, C), dtype=np.float32))))
    perm = rng.permutation(np.arange(1, num_blocks)).astype(np.int32)
    tables = np.zeros((B, M), np.int32)
    used = 0
    for b, n in enumerate(PAGED_LENS):
        nb = -(-n // BS)
        tables[b, :nb] = perm[used:used + nb]
        used += nb
    # an inactive slot: position 0 over an all-zero table (the trash row)
    tables[TRASH_SLOT] = 0
    lens = np.asarray(PAGED_LENS, np.int32)
    scale = DH ** -0.5
    got = tattn.paged_attention(_t(q), _t(k), _t(v), _t(tables), _t(lens),
                                block_size=BS, scale=scale).numpy()
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(tables), jnp.asarray(lens))
    pallas = jattn.paged_attention_pallas(*args, block_size=BS, scale=scale,
                                          seqs_per_program=1, coalesce=False,
                                          interpret=True)
    xla = jattn.paged_attention_xla(*args, block_size=BS, scale=scale)
    return got, _np(pallas), _np(xla), lens


def test_paged_attention_int8_matches_jax_pallas(paged_int8_case):
    got, pallas, _, _ = paged_int8_case
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-5)
    assert not got[ZERO_SLOT].any()          # zero-length slot: zeros
    assert np.isfinite(got[TRASH_SLOT]).all()  # trash-table slot: finite


def test_paged_attention_int8_matches_jax_xla(paged_int8_case):
    got, _, xla, lens = paged_int8_case
    live = lens > 0
    np.testing.assert_allclose(got[live], xla[live], atol=2e-5, rtol=1e-5)


# K3's split arithmetic over an int8 pool (the int8 scales taken out of the
# dot, as csrc/paged_attention.cu does): the plain split form against the
# Pallas kernel in interpret mode and the XLA path, on and around the split
# boundaries of a 320-key table, for each compiled group size; a merge that
# leaves out one split must fail (cases shared with test_torch_attention.py)
@pytest.fixture(scope="module", params=[1, 2, 4, 8], ids=lambda g: f"g{g}")
def int8_split_case(request):
    return split_case(request.param, int8=True)


def test_paged_split_ref_int8_matches_jax_pallas(int8_split_case):
    got, _, pallas, _, lens = int8_split_case
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-5)
    assert not got[lens == 0].any()          # zero-length slot: zeros


def test_paged_split_ref_int8_matches_jax_xla(int8_split_case):
    got, _, _, xla, lens = int8_split_case
    live = lens > 0
    np.testing.assert_allclose(got[live], xla[live], atol=2e-5, rtol=1e-5)


def test_paged_split_ref_int8_dropped_split_fails(int8_split_case):
    _, (m, l, acc), pallas, _, lens = int8_split_case
    chunk, _ = tattn.decode_split_plan(SPLIT_M, SPLIT_BS)
    multi = [b for b, n in enumerate(lens) if n > chunk]
    m, l, acc = m.clone(), l.clone(), acc.clone()
    m[multi, :, 0], l[multi, :, 0], acc[multi, :, 0] = float("-inf"), 0, 0
    dropped = tattn.merge_split_partials(m, l, acc).numpy()
    assert np.isfinite(dropped).all()
    assert row_rel(dropped[multi], pallas[multi]).min() > 0.1


def test_init_params_quantized_equals_quantize_params():
    cfg = ModelConfig(vocab_size=96, hidden_size=256, intermediate_size=256,
                      num_layers=2, num_heads=4, num_kv_heads=2,
                      head_dim=64, tie_word_embeddings=True)
    for bits, embed in ((8, True), (4, True), (4, False)):
        want = tquant.quantize_params(
            init_params(cfg, 3, "cpu", torch.float32), include_embed=embed,
            bits=bits)
        got = tquant.init_params_quantized(cfg, 3, "cpu", torch.float32,
                                           include_embed=embed, bits=bits)
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            g = got[name]
            if isinstance(w, tquant.QuantizedTensor):
                assert (g.group, g.packed4) == (w.group, w.packed4), name
                assert torch.equal(g.q, w.q) and torch.equal(g.scale,
                                                             w.scale), name
            else:
                assert torch.equal(g, w), name
        # tied: the pre-transposed int8 head exists only with the embed
        assert ("lm_head" in got) == embed


@pytest.mark.parametrize("kvh,dh,kv_quant", [(8, 128, "none"),
                                             (8, 128, "int8"),
                                             (1, 128, "int8"),
                                             (2, 64, "none")])
def test_auto_kv_block_size_matches_jax(kvh, dh, kv_quant):
    geom = dict(vocab_size=64, hidden_size=64, intermediate_size=64,
                num_layers=1, num_heads=8, num_kv_heads=kvh, head_dim=dh)
    want = JEngineConfig.auto_kv_block_size(JModelConfig(**geom), kv_quant)
    assert EngineConfig.auto_kv_block_size(ModelConfig(**geom),
                                           kv_quant) == want
    core = EngineCore(ModelConfig(**geom),
                      EngineConfig(kv_block_size=0, max_model_len=128,
                                   num_kv_blocks=4, dtype="float32",
                                   kv_quantization=kv_quant), device="cpu")
    assert core.cfg.kv_block_size == want
    assert core.kv["k"].shape[1] == 4 * want


def test_unknown_quantization_is_refused():
    for kw in (dict(quantization="int2"), dict(kv_quantization="fp8")):
        with pytest.raises(ValueError):
            EngineConfig(**kw)
