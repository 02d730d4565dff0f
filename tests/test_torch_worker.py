"""The slice as a whole: the port's paged RolloutWorker against the JAX one.

Two workers per package (same config, params, seeds and worker ids) run one
script, once greedy and once at temperature 1.0 / top-p 0.9: sibling prefill
with page sharing, decode, a tool extension, preempt and resume, a stop-token
decode, migration w0 -> w1, a checkpoint restored on w1, release and reset.
After every call the two packages must agree on:

  * the tokens emitted -- sampling keys are bit-exact (tests/test_torch_sampler.py)
    and logits agree to ~1e-5, so no draw at these seeds lies near a tie;
  * every lane's block-id sequence (``lane_pages``);
  * ``dispatch_stats``, except the decode-timing fields (the JAX worker times
    only calls that compiled nothing; the port times every call);
  * block conservation (``allocated - freed == resident + shared``).
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.analysis.sanitize import check_block_conservation as jax_check
from repro.configs import get_config as jax_config
from repro.engine.sampler import SamplerConfig as JaxSampler
from repro.engine.worker import RolloutWorker as JaxWorker
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.engine.paging import check_block_conservation
from repro_torch.engine.sampler import SamplerConfig
from repro_torch.engine.worker import RolloutWorker
from repro_torch.models.model import init_params
from repro_torch.params import from_jax

TIMING = {"decode_wall_s", "decode_timed_steps", "decode_timed_lane_steps"}
KW = dict(capacity=64, max_slots=4, page_size=8, chunk_size=8)
PROMPT = [3 + i for i in range(20)]          # 2.5 pages: full pages shared + a boundary


def _script(w0, w1):
    """The scenario; returns a list of (label, result, snapshot)."""
    log = []

    def snap(label, result=None):
        log.append((label, result, {
            "w0_pages": {s: list(b) for s, b in w0.lane_pages.items()},
            "w1_pages": {s: list(b) for s, b in w1.lane_pages.items()},
            "w0_stats": {k: v for k, v in w0.dispatch_stats().items() if k not in TIMING},
            "w1_stats": {k: v for k, v in w1.dispatch_stats().items() if k not in TIMING},
        }))

    w0.prefill(1, PROMPT)
    w0.prefill(2, PROMPT)                      # sibling: shares full pages
    w0.prefill(3, [7, 11, 13, 5, 2, 9, 40, 41, 42, 43, 44])
    snap("prefill")
    snap("decode", w0.decode([1, 2, 3], 6))
    w0.extend(1, [101, 102, 103, 104, 105, 106])
    snap("extend")
    w0.preempt(2)
    snap("decode_preempted", w0.decode([1, 3], 4))
    snap("resume", w0.decode([2], 3))
    first = w0.store[3].tokens[-1]
    snap("stop_decode", w0.decode([3], 12, stop_token=first))
    w1.migrate_in(w0.migrate_out(3))
    snap("migrate", w1.decode([3], 5))
    w1.migrate_in(w0.checkpoint_out(1))        # restore a copy of lane 1 on w1
    snap("restore", {"w1": w1.decode([1], 4), "w0": w0.decode([1], 4)})
    for sid in (1, 2):
        w0.release(sid)
    for sid in (3, 1):
        w1.release(sid)
    snap("release")
    w0.prefill(4, PROMPT[:13])                 # re-entry: a retired lane's pages
    snap("reentry", w0.decode([4], 3))
    w0.reset_cache()
    w1.reset_cache()
    snap("reset")
    return log


@pytest.fixture(scope="module", params=[0.0, 1.0], ids=["greedy", "temperature1"])
def runs(request):
    jcfg = jax_config("qwen3_1_7b").reduced(n_periods=2)
    cfg = get_config("qwen3_1_7b").reduced(n_periods=2)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    temp = request.param                       # top-p 0.9 in both
    jax_log = _script(*(JaxWorker(jcfg, jparams, worker_id=i, sampler=JaxSampler(temp),
                                  **KW) for i in (0, 1)))
    port_log = _script(*(RolloutWorker(cfg, params, worker_id=i, sampler=SamplerConfig(temp),
                                       device="cpu", **KW) for i in (0, 1)))
    return jax_log, port_log


def test_tokens_match(runs):
    jax_log, port_log = runs
    for (label, want, _), (_, got, _) in zip(jax_log, port_log):
        assert got == want, label
    restored = dict((label, r) for label, r, _ in port_log)["restore"]
    assert restored["w1"] == restored["w0"]    # the key and pos travel with the lane


def test_block_ids_match(runs):
    jax_log, port_log = runs
    for (label, _, want), (_, _, got) in zip(jax_log, port_log):
        assert got["w0_pages"] == want["w0_pages"], label
        assert got["w1_pages"] == want["w1_pages"], label


def test_dispatch_stats_match(runs):
    jax_log, port_log = runs
    for (label, _, want), (_, _, got) in zip(jax_log, port_log):
        assert got["w0_stats"] == want["w0_stats"], label
        assert got["w1_stats"] == want["w1_stats"], label
    stats = port_log[1][2]["w0_stats"]
    assert stats["blocks_shared"] > 0 and stats["reused_tokens"] > 0   # sharing engaged


def test_block_conservation_clean(runs):
    _, port_log = runs
    for label, _, snap in port_log:
        for w in ("w0_stats", "w1_stats"):
            assert check_block_conservation(snap[w]) == [], label
            assert jax_check({0: snap[w]}) == [], label
    final = port_log[-1][2]["w0_stats"]
    assert final["blocks_resident"] == 0 and final["blocks_shared"] == 0


def test_migration_package_pages_match_jax():
    """The D2D package carries the same page contents, key and byte price."""
    jcfg = jax_config("qwen3_1_7b").reduced(n_periods=2)
    cfg = get_config("qwen3_1_7b").reduced(n_periods=2)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jw = JaxWorker(jcfg, jparams, worker_id=0, **KW)
    tw = RolloutWorker(cfg, params, worker_id=0, device="cpu", **KW)
    for w in (jw, tw):
        w.prefill(1, PROMPT)
        w.decode([1], 2)
    assert tw.kv_bytes(1) == jw.kv_bytes(1)
    jpkg, pkg = jw.migrate_out(1), tw.migrate_out(1)
    assert pkg["logical_bytes"] == jpkg["logical_bytes"]
    np.testing.assert_array_equal(pkg["key"], jpkg["key"])
    for key, c in jpkg["pages"].items():
        for name, leaf in c.items():
            np.testing.assert_allclose(pkg["pages"][key][name].numpy(), np.asarray(leaf),
                                       atol=2e-5, rtol=0)


def test_ported_worker_guards(monkeypatch):
    cfg = get_config("qwen3_1_7b").reduced(n_periods=1)
    params = init_params(cfg, seed=0, device="cpu")
    src = RolloutWorker(cfg, params, device="cpu", paged=False, **KW)
    src.prefill(1, PROMPT)
    dst = RolloutWorker(cfg, params, device="cpu", paged=False, **dict(KW, capacity=32))
    with pytest.raises(ValueError, match="capacity"):   # a 64-slot lane into 32-slot lanes
        dst.migrate_in(src.checkpoint_out(1))
    with pytest.raises(NotImplementedError):   # layer kinds of later slices
        RolloutWorker(replace(cfg, block_pattern=("mamba",)), params, device="cpu", **KW)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RolloutWorker(cfg, params, **KW)       # device=None means the card
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
