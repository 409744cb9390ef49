"""The PyTorch port's sampler against the JAX package's.

Greedy rows must pick the same tokens. Temperature, top-k and top-p rows
must pick the same tokens given the same Gumbel noise: the noise the JAX
sampler draws from its per-slot keys is drawn here once and handed to the
port's ``sample_tokens``. Chosen-token logprobs agree to f32 rounding
(atol=1e-6: the same log-softmax, summed in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine.sampling import sample_tokens as jax_sample
from dynamo_tpu_torch.engine.sampling import sample_tokens as torch_sample

V = 96


def _run(temperature, top_k, top_p, seed):
    B = len(temperature)
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    # exactly the noise jax's sample_tokens draws from these keys
    gumbel = np.array(jax.vmap(
        lambda k: jax.random.gumbel(k, (V,), dtype=jnp.float32))(keys))
    temperature = np.asarray(temperature, np.float32)
    top_k = np.asarray(top_k, np.int32)
    top_p = np.asarray(top_p, np.float32)
    jt, jl = jax_sample(jnp.asarray(logits), keys, jnp.asarray(temperature),
                        jnp.asarray(top_k), jnp.asarray(top_p))
    tt, tl = torch_sample(torch.from_numpy(logits), torch.from_numpy(gumbel),
                          torch.from_numpy(temperature),
                          torch.from_numpy(top_k.astype(np.int64)),
                          torch.from_numpy(top_p))
    return np.asarray(jt), np.asarray(jl), tt.numpy(), tl.numpy(), logits


@pytest.mark.parametrize("temperature,top_k,top_p", [
    ([0.0, 0.0, 0.0, 0.0], [0] * 4, [1.0] * 4),                 # greedy
    ([0.7, 1.0, 0.3, 0.0], [0] * 4, [1.0] * 4),                 # temperature
    ([0.7, 1.0, 0.8, 0.0], [5, 0, 2, 0], [1.0, 0.9, 1.0, 1.0]),  # top-k/p
    ([1.3, 0.5, 1.0, 0.9], [0, 3, 0, 0], [0.5, 1.0, 0.95, 0.2]),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_sampler_matches_jax(temperature, top_k, top_p, seed):
    jt, jl, tt, tl, logits = _run(temperature, top_k, top_p, seed)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tl, jl, atol=1e-6, rtol=0)
    greedy = np.asarray(temperature) <= 0
    np.testing.assert_array_equal(tt[greedy], logits.argmax(-1)[greedy])
