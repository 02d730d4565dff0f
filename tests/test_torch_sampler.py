"""The port's sampling against ``jax.random`` and ``repro.engine.sampler``.

The key scheme is threefry2x32 written in integer tensor ops, so keys and
random bits must match JAX exactly, uniforms too (the same float32
construction), and Gumbel noise to the last bits of float32 ``log``
(1e-6 absolute: the two libraries' ``log`` may differ by an ulp).  Tokens
drawn from identical logits must then be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import sampler as JS
from repro_torch.engine import prng
from repro_torch.engine import sampler as S


def _key(jkey):
    return torch.tensor(np.asarray(jkey).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
def test_prng_key_and_fold_in_match_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    key = prng.prng_key(seed)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    data = np.asarray([0, 1, 2, 63, 1000, 2**31 - 1], np.int64)
    want = np.stack([np.asarray(jax.random.fold_in(jkey, int(d))) for d in data])
    np.testing.assert_array_equal(prng.fold_in(key, torch.tensor(data)).numpy(), want)


def test_worker_key_chain_matches_jax():
    """Sequence key fold_in(PRNGKey(seed + worker_id), seq_id), then one fold_in
    of pos per decode step, batched over lanes as the decode loop does."""
    base = jax.random.PRNGKey(3 + 1)
    seq_keys = np.stack([np.asarray(jax.random.fold_in(base, s)) for s in (5, 6, 900)])
    pos = np.asarray([0, 17, 2047], np.int32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(jnp.asarray(seq_keys), jnp.asarray(pos)))
    got_seq = prng.fold_in(prng.prng_key(3 + 1), torch.tensor([5, 6, 900]))
    np.testing.assert_array_equal(got_seq.numpy(), seq_keys)
    np.testing.assert_array_equal(prng.fold_in(got_seq, torch.tensor(pos)).numpy(), want)


def test_bits_uniform_gumbel_match_jax():
    keys = [jax.random.PRNGKey(s) for s in (0, 42)]
    n = 1001                                       # odd: no pairing assumption
    for jkey in keys:
        key = _key(jkey)[None]
        np.testing.assert_array_equal(prng.random_bits(key, n)[0].numpy(),
                                      np.asarray(jax.random.bits(jkey, (n,))))
        tiny = float(jnp.finfo(jnp.float32).tiny)
        np.testing.assert_array_equal(
            prng.uniform(key, n, minval=tiny)[0].numpy(),
            np.asarray(jax.random.uniform(jkey, (n,), minval=tiny)))
        np.testing.assert_allclose(prng.gumbel(key, n)[0].numpy(),
                                   np.asarray(jax.random.gumbel(jkey, (n,))), atol=1e-6,
                                   rtol=0)


def test_greedy_and_top_p_filter_match():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 512)).astype(np.float32) * 3
    greedy = S.sample_slots(torch.zeros(6, 2, dtype=torch.int64), torch.tensor(logits),
                            S.SamplerConfig(temperature=0.0))
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))
    for top_p in (0.5, 0.9, 0.99):
        got = S.top_p_filter(torch.tensor(logits), top_p).numpy()
        want = np.asarray(JS.top_p_filter(jnp.asarray(logits), top_p))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])


def test_sample_slots_matches_jax_on_identical_logits():
    rng = np.random.default_rng(1)
    B, V = 8, 512
    base = jax.random.PRNGKey(9)
    jkeys = jax.vmap(jax.random.fold_in)(jnp.stack([base] * B), jnp.arange(B))
    active = np.asarray([True] * 6 + [False] * 2)
    cfg_j, cfg_t = JS.SamplerConfig(), S.SamplerConfig()
    matched = 0
    for step in range(20):
        logits = rng.standard_normal((B, V)).astype(np.float32) * (0.5 + step / 10)
        want = np.asarray(JS.sample_slots(jkeys, jnp.asarray(logits), cfg_j,
                                          active=jnp.asarray(active)))
        got = S.sample_slots(_key(jkeys), torch.tensor(logits), cfg_t,
                             active=torch.tensor(active)).numpy()
        assert got.dtype == np.int32 and (got[~active] == -1).all()
        matched += int((got == want).all())
        jkeys = jax.vmap(jax.random.fold_in)(jkeys, jnp.full((B,), step))
    assert matched == 20


def test_streams_are_independent_of_batch_composition():
    """A lane's draw depends only on its own key and logits."""
    rng = np.random.default_rng(2)
    logits = torch.tensor(rng.standard_normal((4, 256)).astype(np.float32))
    keys = prng.fold_in(prng.prng_key(0), torch.arange(4))
    full = S.sample_slots(keys, logits)
    for b in range(4):
        alone = S.sample_slots(keys[b:b + 1], logits[b:b + 1])
        assert int(alone[0]) == int(full[b])
