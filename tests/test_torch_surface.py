"""The reference's last public names in the port, each held against the JAX
package on the same inputs: ``sample``, ``ProgressivePredictor.predict_batch``,
``ModelConfig.layer_kinds`` / ``has_kv_cache`` and ``all_configs``; and the
reference's ``ServiceConfig`` knobs as the port's ``ReplayBuffer`` arguments.

``sample``'s tokens are held ``==``: the port draws the JAX package's threefry
bits.  ``predict_batch`` equals the port's ``predict`` row by row (``==``,
both numpy float64) and the JAX ``predict_batch`` within ``rtol=1e-4``: the
JAX package evaluates the batch's log-length ``y = f @ w`` in f32 (``jnp``)
and returns f32, and an error ``dy`` in ``y`` moves ``expm1(y)`` by about
``dy`` of itself; on the workbench's 24 trajectories the rows differ by at
most 4.4e-7 of their value.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_config
from repro.engine import sampler as JS
from repro.rl.service import ServiceConfig as JaxServiceConfig
from repro_torch.configs import ARCHITECTURES, all_configs, get_config
from repro_torch.engine import sampler as TS
from repro_torch.engine.prng import prng_key
from repro_torch.rl.service import ReplayBuffer

from _torch_parity import workbench

SAMPLERS = [(0.0, 1.0), (1.0, 1.0), (0.7, 0.9), (1.0, 0.5)]


@pytest.mark.parametrize("temperature, top_p", SAMPLERS,
                         ids=[f"t{t}-p{p}" for t, p in SAMPLERS])
def test_sample_matches_jax(temperature, top_p):
    """Seeds 0-7, B 4, V 1,000: the port's tokens are the JAX tokens, int32;
    at a temperature above 0 some draw leaves the argmax, so the noise is
    held, not only the argmax."""
    off_argmax = 0
    for seed in range(8):
        logits = (3 * np.random.default_rng(seed).standard_normal((4, 1000))).astype(np.float32)
        want = np.asarray(JS.sample(jax.random.PRNGKey(seed), jnp.asarray(logits),
                                    JS.SamplerConfig(temperature, top_p)))
        got = TS.sample(prng_key(seed), torch.from_numpy(logits),
                        TS.SamplerConfig(temperature, top_p))
        assert got.dtype == torch.int32 and got.shape == (4,)
        np.testing.assert_array_equal(got.numpy(), want)
        off_argmax += int((got.numpy() != logits.argmax(-1)).sum())
    assert (off_argmax > 0) == (temperature > 0)


def test_predict_batch_matches_predict_and_jax():
    (jb, jp), (tb, tp) = workbench()
    got = tp.predict_batch(tb)
    assert got.dtype == np.float64 and got.shape == (len(tb),)
    assert list(got) == [tp.predict(t) for t in tb]
    np.testing.assert_allclose(got, jp.predict_batch(jb), rtol=1e-4)
    assert tp.predict_batch([]).shape == (0,)


@pytest.mark.parametrize("name", ARCHITECTURES)
def test_layer_kinds_and_kv_cache_match_jax(name):
    cfg, jcfg = get_config(name), jax_config(name)
    assert cfg.layer_kinds() == jcfg.layer_kinds()
    assert len(cfg.layer_kinds()) == cfg.n_layers
    assert cfg.has_kv_cache() == jcfg.has_kv_cache()
    window = cfg.with_sliding_window(64)
    assert window.has_kv_cache() == jcfg.with_sliding_window(64).has_kv_cache()


# the reference's TPU knobs that the port's ModelConfig does not carry: the
# Pallas switch (a tensor's device picks kernel or plain version) and the
# mesh's sequence axis
TPU_FIELDS = {"use_pallas_decode", "sequence_parallel"}


def test_all_configs_match_jax():
    """The same keys; every field of the port's configs equal to the
    reference's, which has only ``TPU_FIELDS`` besides."""
    got, want = all_configs(), jax_all_configs()
    assert set(got) == set(want) == set(ARCHITECTURES)
    for name, jcfg in want.items():
        names = [f.name for f in dataclasses.fields(got[name])]
        assert set(names) == {f.name for f in dataclasses.fields(jcfg)} - TPU_FIELDS, name
        assert {n: getattr(got[name], n) for n in names} == \
            {n: getattr(jcfg, n) for n in names}, name


def test_service_config_knobs_are_replay_buffer_arguments():
    """The reference's ``ServiceConfig`` has no counterpart (nothing reads
    it): each of its knobs is an argument of the port's ``ReplayBuffer``."""
    knobs = {"replay_capacity": (ReplayBuffer.__init__, "capacity"),
             "groups_per_update": (ReplayBuffer.take, "n_groups"),
             "max_staleness": (ReplayBuffer.take, "max_staleness")}
    assert set(knobs) == {f.name for f in dataclasses.fields(JaxServiceConfig)}
    for fn, arg in knobs.values():
        assert arg in inspect.signature(fn).parameters, (fn, arg)
