"""The PyTorch port's sampling keys and noise against JAX's threefry.

The port draws each sampled row's Gumbel noise as the JAX engine does:
``make_slot_keys(engine seed, request seed, key_step)`` (``PRNGKey``, two
``fold_in``s) and ``jax.random.gumbel(key, (V,), float32)``.

- Keys and the 32-bit ``random_bits`` are equal exactly (integer
  arithmetic on both sides), for several (engine seed, request seed, step)
  triples and an odd vocabulary.
- The noise is ``-log(-log(u))`` of the same u. PyTorch's and XLA's f32
  ``log`` may each round 1 ulp apart, so each of the two logs must be
  within 2 ulp of JAX's given the same input; the composed noise, where
  the inner log's rounding is amplified near zero, within atol=1e-6 (the
  noise's ulp at its largest values, ~16, is 2e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine.sampling import make_slot_keys
from dynamo_tpu_torch.engine import sampling as tsampling

V = 4099
TRIPLES = [(0, 0, 0), (0, 1, 5), (7, 12345, 31), (3, 2 ** 31 - 1, 1000),
           (123456789, 42, 2 ** 20)]


def _jax_key(base, seed, step):
    return make_slot_keys(base, jnp.asarray([seed]), jnp.asarray(step))[0]


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("base,seed,step", TRIPLES)
def test_keys_and_random_bits_equal_jax(base, seed, step):
    jk = _jax_key(base, seed, step)
    tk = tsampling.make_slot_key(base, seed, step)
    assert tuple(int(v) for v in np.asarray(jax.random.key_data(jk))) == tk
    want = np.asarray(jax.random.bits(jk, (V,), jnp.uint32)).astype(np.int64)
    got = tsampling.random_bits(torch.tensor([tk]), V)[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("base,seed,step", TRIPLES)
def test_gumbel_noise_matches_jax(base, seed, step):
    jk = _jax_key(base, seed, step)
    want = np.asarray(jax.random.gumbel(jk, (V,), jnp.float32))
    tk = tsampling.make_slot_key(base, seed, step)
    # rows without a key (greedy slots) are zeros
    noise = tsampling.gumbel_noise(V, [None, tk], "cpu").numpy()
    assert not noise[0].any()
    got = noise[1]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # stage by stage from the same u: each log within 2 ulp of XLA's
    bits = tsampling.random_bits(torch.tensor([tk]), V)
    tiny = np.finfo(np.float32).tiny
    fl = (((bits[0].numpy() >> 9) | 0x3F800000).astype(np.int32)
          .view(np.float32) - np.float32(1.0))
    u = np.maximum(np.float32(tiny), fl + np.float32(tiny))
    inner_j = np.array(-jnp.log(jnp.asarray(u)))
    inner_t = (-torch.log(torch.from_numpy(u))).numpy()
    assert _ulps(inner_t, inner_j).max() <= 2
    outer_j = np.asarray(-jnp.log(jnp.asarray(inner_j)))
    outer_t = (-torch.log(torch.from_numpy(inner_j))).numpy()
    assert _ulps(outer_t, outer_j).max() <= 2
    np.testing.assert_array_equal(
        tsampling.gumbel_from_bits(bits)[0].numpy(),
        (-torch.log(torch.from_numpy(inner_t))).numpy())
