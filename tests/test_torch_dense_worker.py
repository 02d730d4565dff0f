"""The dense plane as a whole: the port's RolloutWorker against the JAX one.

Each script runs on both packages (same config, params, seeds and worker
ids), once greedy and once at temperature 1.0 / top-p 0.9.  After every call
the two must agree on the tokens emitted (sampling keys are bit-exact and
logits agree to ~1e-5, so no draw at these seeds lies near a tie), on
``dispatch_stats`` (less the decode-timing fields: the JAX worker times only
calls that compiled nothing, the port every call), on the paged workers'
block ids, and on every lane's KV within 2e-5.

  * dense: sibling prefill with lane reuse, pool growth, decode, chunked
    extend, preempt and resume, a stop-token decode, checkpoint and restore,
    migration dense -> dense, dense -> paged and paged -> dense, release,
    re-entry from a retired lane, reset;
  * full-sequence admission on the paged plane (``use_chunked=False``), with
    per-token tool absorption;
  * a sliding-window config (dense by force): a prompt longer than the
    window (the ring wraps at admission) and one of 2,100 tokens (the flash
    branch of full attention), decode past the window, per-token extend.
"""

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.engine.legacy import LegacyRolloutWorker
from repro.engine.sampler import SamplerConfig as JaxSampler
from repro.engine.worker import RolloutWorker as JaxWorker
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.engine.sampler import SamplerConfig
from repro_torch.engine.worker import RolloutWorker
from repro_torch.models import model as M
from repro_torch.params import from_jax

TIMING = {"decode_wall_s", "decode_timed_steps", "decode_timed_lane_steps"}
KV_TOL = 2e-5
KW = dict(capacity=64, chunk_size=8)
PROMPT = [3 + i for i in range(20)]


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("qwen3_1_7b").reduced(n_periods=2)
    cfg = get_config("qwen3_1_7b").reduced(n_periods=2)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _lanes(w) -> dict:
    """seq_id -> the lane's KV as numpy (P, n, KV, hd) copies of its first
    n = min(len(tokens), capacity) slots (all of a ring), from either
    package's worker (the port's pool changes in place: copy it)."""
    out = {}
    for sid, seq in w.store.items():
        n = min(len(seq.tokens), w.capacity)
        leaves = {}
        for key, c in w.pool["blocks"].items():
            for name, leaf in c.items():
                leaf = np.array(leaf)
                if w._paged:
                    lane = leaf[:, w.lane_pages[seq.slot]]
                    lane = lane.reshape((lane.shape[0], -1) + lane.shape[3:])
                else:
                    lane = leaf[:, seq.slot]
                leaves[f"{key}/{name}"] = lane[:, :n]
        out[sid] = leaves
    return out


def _snapshot(workers) -> dict:
    return {name: {"stats": {k: v for k, v in w.dispatch_stats().items() if k not in TIMING},
                   "pages": {s: list(b) for s, b in getattr(w, "lane_pages", {}).items()},
                   "slots": {sid: seq.slot for sid, seq in w.store.items()},
                   "kv": _lanes(w)}
            for name, w in workers.items()}


def _run(script, make, models, temp):
    """script(workers, step) on both packages -> (jax log, port log)."""
    jcfg, cfg, jparams, params = models
    logs = []
    for pkg in ("jax", "port"):
        log = []
        workers = make(pkg, jcfg if pkg == "jax" else cfg, jparams if pkg == "jax" else params,
                       JaxSampler(temp) if pkg == "jax" else SamplerConfig(temp))

        def step(label, result=None):
            log.append((label, result, _snapshot(workers)))
        script(workers, step)
        logs.append(log)
    return logs


def _compare(jax_log, port_log):
    assert [s[0] for s in jax_log] == [s[0] for s in port_log]
    for (label, want, jsnap), (_, got, snap) in zip(jax_log, port_log):
        assert got == want, label
        for name, j in jsnap.items():
            p = snap[name]
            assert p["stats"] == j["stats"], (label, name)
            assert p["pages"] == j["pages"], (label, name)
            assert p["slots"] == j["slots"], (label, name)
            for sid, leaves in j["kv"].items():
                for leaf, want_kv in leaves.items():
                    np.testing.assert_allclose(p["kv"][sid][leaf], want_kv,
                                               atol=KV_TOL, rtol=0,
                                               err_msg=f"{label} {name} seq {sid} {leaf}")


def _workers(specs):
    """specs: name -> (worker_id, kwargs); returns make(pkg, cfg, params, sampler)."""
    def make(pkg, cfg, params, sampler):
        cls = JaxWorker if pkg == "jax" else RolloutWorker
        extra = {} if pkg == "jax" else {"device": "cpu"}
        return {name: cls(cfg, params, worker_id=wid, sampler=sampler, **kw, **extra)
                for name, (wid, kw) in specs.items()}
    return make


def _dense_script(w, step):
    d0, d1, pg = w["d0"], w["d1"], w["pg"]
    d0.prefill(1, PROMPT)
    d0.prefill(2, PROMPT)                      # sibling: lane-prefix copy
    d0.prefill(3, [7, 11, 13, 5, 2, 9, 40, 41, 42, 43, 44])   # 3 lanes of 2: growth
    step("prefill")
    step("decode", d0.decode([1, 2, 3], 6))
    d0.extend(1, [101, 102, 103, 104, 105, 106, 107, 108, 109, 110])   # chunked, 2 chunks
    step("extend")
    d0.preempt(2)
    step("decode_preempted", d0.decode([1, 3], 4))
    step("resume", d0.decode([2], 3))
    first = d0.store[3].tokens[-1]
    step("stop_decode", d0.decode([3], 12, stop_token=first))
    d1.migrate_in(d0.checkpoint_out(1))        # restore a host copy on d1
    step("restore", {"d1": d1.decode([1], 4), "d0": d0.decode([1], 4)})
    d1.migrate_in(d0.migrate_out(3))           # dense -> dense
    step("migrate_dense", d1.decode([3], 3))
    pg.migrate_in(d0.migrate_out(2))           # dense -> paged
    step("migrate_to_paged", pg.decode([2], 5))
    d0.migrate_in(pg.migrate_out(2))           # paged -> dense
    step("migrate_to_dense", d0.decode([2], 5))
    for sid in (1, 2):
        d0.release(sid)
    step("release")
    d0.prefill(4, PROMPT[:13])                 # re-entry: a retired lane's prefix
    step("reentry", d0.decode([4], 3))
    d0.reset_cache()
    step("reset")


def _full_admission_script(w, step):
    a, b = w["a"], w["b"]
    a.prefill(1, PROMPT)
    a.prefill(2, PROMPT[:17])                  # no radix reuse without chunked prefill
    step("prefill")
    step("decode", a.decode([1, 2], 5))
    a.extend(1, [101, 102, 103, 104])          # per-token absorption
    step("extend")
    b.migrate_in(a.migrate_out(2))             # paged -> paged, same layout
    step("migrate", b.decode([2], 4))
    a.migrate_in(b.checkpoint_out(2))          # paged -> paged from a host copy
    step("restore", {"a": a.decode([2], 3), "b": b.decode([2], 3)})


@pytest.mark.parametrize("temp", [0.0, 1.0], ids=["greedy", "temperature1"])
def test_dense_worker_matches_jax(models, temp):
    make = _workers({"d0": (0, dict(KW, max_slots=2, paged=False)),
                     "d1": (1, dict(KW, max_slots=2, paged=False)),
                     "pg": (2, dict(KW, max_slots=2, page_size=8))})
    jax_log, port_log = _run(_dense_script, make, models, temp)
    _compare(jax_log, port_log)
    stats = port_log[0][2]["d0"]["stats"]
    assert stats["reused_tokens"] > 0 and stats["pool_grows"] == 1
    restored = dict((label, r) for label, r, _ in port_log)["restore"]
    assert restored["d1"] == restored["d0"]    # the key and pos travel with the lane


@pytest.mark.parametrize("temp", [0.0, 1.0], ids=["greedy", "temperature1"])
def test_full_sequence_admission_on_paged_plane_matches_jax(models, temp):
    make = _workers({"a": (0, dict(KW, max_slots=2, page_size=8, use_chunked=False)),
                     "b": (1, dict(KW, max_slots=2, page_size=8, use_chunked=False))})
    jax_log, port_log = _run(_full_admission_script, make, models, temp)
    _compare(jax_log, port_log)
    stats = port_log[-1][2]["a"]["stats"]
    assert stats["prefill_dispatches"] == 0 and stats["absorbed_tokens"] == 4


def _window_script(w, step):
    s = w["s"]
    assert not s._paged                        # a ring cannot be paged: dense by force
    rng = np.random.default_rng(11)
    s.prefill(1, rng.integers(0, 512, 100).tolist())      # > window: wraps at admission
    s.prefill(2, rng.integers(0, 512, 2100).tolist())     # flash branch
    step("prefill")
    step("decode", s.decode([1, 2], 6))
    s.extend(1, [101, 102, 103])                          # per-token teacher forcing
    step("extend")
    s.preempt(2)
    step("decode_preempted", s.decode([1], 3))
    s.release(1)
    s.release(2)
    step("release")


@pytest.mark.parametrize("temp", [0.0, 1.0], ids=["greedy", "temperature1"])
def test_sliding_window_worker_matches_jax(models, temp):
    jcfg, cfg, jparams, params = models
    window = (jcfg.with_sliding_window(64), cfg.with_sliding_window(64), jparams, params)
    make = _workers({"s": (0, dict(capacity=64, max_slots=2))})
    jax_log, port_log = _run(_window_script, make, window, temp)
    _compare(jax_log, port_log)


def test_chunk_window_past_capacity_edge_matches_documented_semantics(models):
    """The seed failure's edge (capacity 16, chunks of 8, the last extend's
    window 11..18 hanging past the lane): the port's lane KV equals the legacy
    per-token path's (every key at its absolute slot) within 1e-5, and the
    next token agrees."""
    jcfg, cfg, jparams, params = models
    w = RolloutWorker(cfg, params, capacity=16, max_slots=2, chunk_size=8, paged=False,
                      sampler=SamplerConfig(1.0, 0.9), device="cpu")
    legacy = LegacyRolloutWorker(jcfg, jparams, capacity=16, sampler=JaxSampler(1.0, 0.9))
    for e in (w, legacy):
        e.prefill(1, [5, 7, 9, 11, 13])
        e.extend(1, [21, 22, 23, 24, 25, 26])   # off 5..10
        e.extend(1, [31, 32, 33, 34])           # off 11: window 11..18 > cap 16
    lane = M.gather_slots(w.pool, [w.store[1].slot])
    for key, c in lane["blocks"].items():
        for name, got in c.items():
            want = np.asarray(legacy.store[1].cache["blocks"][key][name])
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert w.decode([1], 1) == legacy.decode([1], 1)
