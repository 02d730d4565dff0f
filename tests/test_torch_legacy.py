"""The port's legacy per-sequence worker against the JAX package's, and against
the port's slot-pool worker as tests/test_slot_pool.py holds the JAX pair.

Config: ``qwen3_1_7b.reduced(n_periods=1)`` (f32), the JAX weights carried
across with ``from_jax``, greedy and at temperature 1.0 / top-p 0.9.  Tokens
must be equal; every cache leaf (per-sequence K/V, ``pos``) within 2e-5 of
the JAX worker's; ``kv_bytes`` equal.
"""

import numpy as np
import pytest

from _torch_parity import jax_and_port
from _torch_parity import one_torch_thread  # noqa: F401
from repro.engine.legacy import LegacyRolloutWorker as JaxLegacy
from repro.engine.sampler import SamplerConfig as JaxSampler
from repro_torch.engine.legacy import LegacyRolloutWorker
from repro_torch.engine.sampler import SamplerConfig
from repro_torch.engine.worker import RolloutWorker
from repro_torch.models import model as M

pytestmark = pytest.mark.usefixtures("one_torch_thread")
KV_TOL = 2e-5


@pytest.fixture(scope="module")
def models():
    return jax_and_port("qwen3_1_7b", n_periods=1)


def _caches_match(port, ref):
    assert port.store.keys() == ref.store.keys()
    for sid, seq in port.store.items():
        rseq = ref.store[sid]
        assert seq.tokens == rseq.tokens and seq.generated == rseq.generated
        assert np.array_equal(seq.key, np.asarray(rseq.key))
        assert port.kv_bytes(sid) == ref.kv_bytes(sid)
        assert seq.cache["pos"].tolist() == np.asarray(rseq.cache["pos"]).tolist()
        for key, leaves in seq.cache["blocks"].items():
            for name, leaf in leaves.items():
                np.testing.assert_allclose(leaf.numpy(), np.asarray(rseq.cache["blocks"][key][name]),
                                           atol=KV_TOL, rtol=0, err_msg=f"{sid} {key} {name}")


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_legacy_matches_the_jax_legacy_worker(models, temperature):
    """The interleaved lifecycle of tests/test_slot_pool.py, plus a stop-token
    decode, a preemption and a migration to a second worker and back: tokens
    equal, caches within 2e-5."""
    jcfg, cfg, jparams, params = models
    port = [LegacyRolloutWorker(cfg, params, capacity=64, worker_id=i, device="cpu",
                                sampler=SamplerConfig(temperature=temperature, top_p=0.9))
            for i in range(2)]
    ref = [JaxLegacy(jcfg, jparams, capacity=64, worker_id=i,
                     sampler=JaxSampler(temperature=temperature, top_p=0.9))
           for i in range(2)]
    for w in (port[0], ref[0]):
        w.prefill(1, [5, 7, 9, 11])
        w.prefill(2, [5, 7, 9])
    assert port[0].decode([1, 2], 4) == ref[0].decode([1, 2], 4)
    for w in (port[0], ref[0]):                   # admission mid-flight
        w.prefill(3, [2, 4, 6, 8, 10])
    assert port[0].decode([1, 2, 3], 3) == ref[0].decode([1, 2, 3], 3)
    for w in (port[0], ref[0]):                   # tool absorption, one lane only
        w.extend(2, [101, 102, 103])
        w.preempt(1)
    _caches_match(port[0], ref[0])
    assert port[0].decode([2, 3], 3) == ref[0].decode([2, 3], 3)
    stop = port[0].store[3].tokens[-1]
    assert port[0].decode([1, 3], 6, stop_token=stop) == \
        ref[0].decode([1, 3], 6, stop_token=stop)
    port[1].migrate_in(port[0].migrate_out(2))
    ref[1].migrate_in(ref[0].migrate_out(2))
    assert port[1].decode([2], 3) == ref[1].decode([2], 3)
    _caches_match(port[1], ref[1])
    port[0].migrate_in(port[1].migrate_out(2))
    ref[0].migrate_in(ref[1].migrate_out(2))
    for w in (port[0], ref[0]):                   # finish one, keep decoding the rest
        w.release(1)
    assert port[0].decode([2, 3], 2) == ref[0].decode([2, 3], 2)
    _caches_match(port[0], ref[0])
    assert port[0].decode_steps == ref[0].decode_steps


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_slot_pool_worker_matches_the_legacy_oracle(models, paged, temperature):
    """tests/test_slot_pool.py's interleaved lifecycle in the port: the dense
    and the paged slot-pool worker give the legacy worker's tokens."""
    _, cfg, _, params = models
    sampler = SamplerConfig(temperature=temperature, top_p=0.9)
    pool = RolloutWorker(cfg, params, capacity=64, max_slots=4, sampler=sampler,
                         paged=paged, device="cpu")
    legacy = LegacyRolloutWorker(cfg, params, capacity=64, sampler=sampler, device="cpu")
    for w in (pool, legacy):
        w.prefill(1, [5, 7, 9, 11])
        w.prefill(2, [5, 7, 9])
    assert pool.decode([1, 2], 4) == legacy.decode([1, 2], 4)
    for w in (pool, legacy):
        w.prefill(3, [2, 4, 6, 8, 10])
    assert pool.decode([1, 2, 3], 3) == legacy.decode([1, 2, 3], 3)
    for w in (pool, legacy):
        w.extend(2, [101, 102, 103])
    assert pool.decode([2, 3], 3) == legacy.decode([2, 3], 3)
    for w in (pool, legacy):
        w.release(1)
    assert pool.decode([2], 2) == legacy.decode([2], 2)
    assert pool.store[2].tokens == legacy.store[2].tokens


def test_legacy_preempt_resume_and_migration_round_trip(models):
    """A preempted sequence resumes with the tokens it would have produced;
    migrate_out -> migrate_in -> back gives an unmigrated run's tokens, the
    package's cache on the host and copied into the receiving worker."""
    _, cfg, _, params = models
    sampler = SamplerConfig(temperature=1.0, top_p=0.9)
    w0, w1, ref = (LegacyRolloutWorker(cfg, params, capacity=64, worker_id=i, sampler=sampler,
                                       device="cpu") for i in (0, 1, 0))
    for e in (w0, ref):
        e.prefill(1, [5, 7, 9, 11])
        e.prefill(2, [3, 5, 8])
    assert w0.decode([1, 2], 3) == ref.decode([1, 2], 3)
    w0.preempt(1)
    with pytest.raises(KeyError):
        w0.preempt(99)
    assert w0.decode([2], 2) == ref.decode([2], 2)
    pkg = w0.migrate_out(1)
    assert 1 not in w0.store and all(t.device.type == "cpu"
                                     for t in M.tree_leaves(pkg["cache"]))
    w1.migrate_in(pkg)
    assert w1.decode([1], 4)[1] == ref.decode([1], 4)[1]
    w0.migrate_in(w1.migrate_out(1))
    assert w0.decode([1], 3)[1] == ref.decode([1], 3)[1]
    assert w0.prefix_index.match_len(w0.store[1].tokens) == len(w0.store[1].tokens)
