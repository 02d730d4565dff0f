"""The port's flash attention forward against the JAX package's.

The cases are tests/test_kernels.py's (S, T, window), with blocks of 32 (q)
and 48 (kv), so every case runs several blocks and a ragged tail.  Inputs are
drawn with numpy.  Tolerance 2e-5: float32, sums in the same block order.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.flash import flash_attention as jax_flash
from repro_torch.models.flash import flash_attention


@pytest.mark.parametrize("S,T,window", [(64, 64, 0), (100, 100, 0), (100, 100, 17),
                                        (33, 70, 0), (128, 128, 32)])
def test_flash_forward_matches_jax(S, T, window):
    B, KV, G, hd = 2, 2, 3, 32
    rng = np.random.default_rng(S + T + window)
    q = rng.standard_normal((B, KV, G, S, hd), np.float32)
    k = rng.standard_normal((B, T, KV, hd), np.float32)
    v = rng.standard_normal((B, T, KV, hd), np.float32)
    qp, kp = np.arange(S, dtype=np.int32), np.arange(T, dtype=np.int32)
    scale = 1 / math.sqrt(hd)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp),
                     jnp.asarray(kp), scale, True, window, 32, 48)
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          torch.tensor(qp), torch.tensor(kp), scale, True, window, 32, 48)
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
