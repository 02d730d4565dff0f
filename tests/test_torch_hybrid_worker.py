"""The hybrid Mamba + MoE slice as a whole: the port's jamba RolloutWorker
against the JAX one.

``jamba_v0_1_52b.reduced(n_periods=1)`` (float32: 7 Mamba layers, 1
attention layer, 4 MoE layers of 4 experts top-2).  MoE makes the config
non-chunkable, so every admission is one full-sequence forward (the scan of
each Mamba layer, then its last state kept), tool output is absorbed one
masked decode step per token, and the radix cache reuses nothing.

One script runs on both packages (same params, seeds and worker ids), once
greedy and once at temperature 1.0 / top-p 0.9, over two paged workers
(``a``, ``b``) and two dense ones (``c``, ``d``): admission on both planes,
decode, per-token extend, preempt and resume, migration paged -> paged ->
dense -> dense -> paged, and checkpoints restored across planes.  Batched
MoE decode is not independent per lane (masked lanes compete for expert
capacity), so the script keeps the batch composition identical in both.
After every call the two must agree on the tokens emitted (exactly), on
``dispatch_stats`` (less the decode-timing fields, as in the other worker
tests), on block ids and lane slots, and on every lane's KV (its own pages,
never scratch block 0) and Mamba state within 2e-5.
"""

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.engine.sampler import SamplerConfig as JaxSampler
from repro.engine.worker import RolloutWorker as JaxWorker
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.engine.paging import check_block_conservation
from repro_torch.engine.sampler import SamplerConfig
from repro_torch.engine.worker import RolloutWorker
from repro_torch.params import from_jax

TIMING = {"decode_wall_s", "decode_timed_steps", "decode_timed_lane_steps"}
TOL = 2e-5
PROMPT = [3 + i for i in range(20)]
PROMPT2 = [7, 11, 13, 5, 2, 9, 40, 41, 42, 43, 44]
TOOL = [101, 102, 103]
N = 4                                          # decode steps per call (one JAX compile)
PAGED = dict(capacity=64, max_slots=4, page_size=8)
DENSE = dict(capacity=64, max_slots=4, paged=False)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("jamba_v0_1_52b").reduced(n_periods=1)
    cfg = get_config("jamba_v0_1_52b").reduced(n_periods=1)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _lanes(w) -> dict:
    """seq_id -> {leaf: numpy copy} of the lane's first min(len(tokens),
    capacity) KV positions (gathered through its pages on a paged worker)
    and its Mamba state rows."""
    out = {}
    for sid, seq in w.store.items():
        n = min(len(seq.tokens), w.capacity)
        leaves = {}
        for key, c in w.pool["blocks"].items():
            for name, leaf in c.items():
                leaf = np.array(leaf)
                if name in ("h", "conv"):
                    leaves[f"{key}/{name}"] = leaf[:, seq.slot]
                    continue
                if w._paged:
                    lane = leaf[:, w.lane_pages[seq.slot]]
                    lane = lane.reshape((lane.shape[0], -1) + lane.shape[3:])
                else:
                    lane = leaf[:, seq.slot]
                leaves[f"{key}/{name}"] = lane[:, :n]
        out[sid] = leaves
    return out


def _script(w, step):
    a, b, c, d = w["a"], w["b"], w["c"], w["d"]
    a.prefill(1, PROMPT)
    a.prefill(2, PROMPT)                       # a sibling: no reuse without chunking
    a.prefill(3, PROMPT2)
    c.prefill(4, PROMPT)                       # dense-plane admission
    step("prefill")
    step("decode", {"a": a.decode([1, 2, 3], N), "c": c.decode([4], N)})
    a.extend(1, TOOL)                          # per-token absorption
    c.extend(4, TOOL)
    step("extend")
    a.preempt(2)
    step("decode_preempted", a.decode([1, 3], N))
    step("resume", a.decode([2], N))
    b.migrate_in(a.migrate_out(3))             # paged -> paged
    step("migrate_paged", b.decode([3], N))
    c.migrate_in(b.migrate_out(3))             # paged -> dense
    step("migrate_to_dense", c.decode([3, 4], N))
    d.migrate_in(c.migrate_out(3))             # dense -> dense
    step("migrate_dense", d.decode([3], N))
    a.migrate_in(d.migrate_out(3))             # dense -> paged
    step("migrate_to_paged", a.decode([1, 2, 3], N))
    d.migrate_in(a.checkpoint_out(1))          # a paged host copy restored on a dense worker
    b.migrate_in(c.checkpoint_out(4))          # a dense host copy restored on a paged worker
    step("restore", {"d": d.decode([1], N), "a": a.decode([1], N),
                     "b": b.decode([4], N), "c": c.decode([4], N)})
    for sid in (1, 2, 3):
        a.release(sid)
    step("release")


def _snapshot(workers) -> dict:
    return {name: {"stats": {k: v for k, v in w.dispatch_stats().items() if k not in TIMING},
                   "pages": {s: list(p) for s, p in getattr(w, "lane_pages", {}).items()},
                   "slots": {sid: seq.slot for sid, seq in w.store.items()},
                   "kv_bytes": {sid: w.kv_bytes(sid) for sid in w.store},
                   "lanes": _lanes(w)}
            for name, w in workers.items()}


def _run(models, temp):
    jcfg, cfg, jparams, params = models
    logs = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            make = lambda wid, kw: JaxWorker(jcfg, jparams, worker_id=wid,      # noqa: E731
                                             sampler=JaxSampler(temp), **kw)
        else:
            make = lambda wid, kw: RolloutWorker(cfg, params, worker_id=wid,     # noqa: E731
                                                 sampler=SamplerConfig(temp), device="cpu",
                                                 **kw)
        workers = {"a": make(0, PAGED), "b": make(1, PAGED), "c": make(2, DENSE),
                   "d": make(3, DENSE)}
        log = []
        _script(workers, lambda label, result=None: log.append(
            (label, result, _snapshot(workers))))
        logs.append(log)
    return logs


@pytest.mark.parametrize("temp", [0.0, 1.0], ids=["greedy", "temperature1"])
def test_hybrid_worker_matches_jax(models, temp):
    jax_log, port_log = _run(models, temp)
    assert [s[0] for s in jax_log] == [s[0] for s in port_log]
    for (label, want, jsnap), (_, got, snap) in zip(jax_log, port_log):
        assert got == want, label
        for name, j in jsnap.items():
            p = snap[name]
            for field in ("stats", "pages", "slots", "kv_bytes"):
                assert p[field] == j[field], (label, name, field)
            for sid, leaves in j["lanes"].items():
                for leaf, want_v in leaves.items():
                    np.testing.assert_allclose(p["lanes"][sid][leaf], want_v, atol=TOL, rtol=0,
                                               err_msg=f"{label} {name} seq {sid} {leaf}")
    for label, _, snap in port_log:
        for name in ("a", "b"):
            assert check_block_conservation(snap[name]["stats"]) == [], (label, name)
    stats = port_log[-1][2]
    assert stats["a"]["stats"]["prefill_dispatches"] == 0        # whole-prompt admission
    assert stats["a"]["stats"]["reused_tokens"] == 0             # no radix reuse
    assert stats["a"]["stats"]["absorbed_tokens"] == len(TOOL)
