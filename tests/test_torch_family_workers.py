"""Whole rollout workers of the new families against the JAX package's, on
both planes: qwen2-moe (shared experts), arctic (dense residual) and xLSTM.

Configs at ``reduced()`` sizes, float32, params from the JAX ``init_params``
carried across by ``from_jax``.  MoE configs run with the no-drop capacity
of tests/test_paging.py::test_moe_paged_parity_non_chunked_admission (``E /
top_k + 1``); they are not chunk-safe, so every admission is one
full-sequence forward and tool output is absorbed one masked decode step a
token.  xLSTM has no attention layer: its paged pool is pure per-lane state
(``_page_bytes`` 0, the page machinery bookkeeping only, as in
tests/test_paging.py::test_recurrent_paged_parity), and it admits by chunked
recurrent prefill.

One script runs on both packages (same params, seeds and worker ids) at
temperature 1.0 / top-p 0.9, over two paged workers (``a``, ``b``) and two
dense ones (``c``, ``d``): admission, decode, extend, preempt and resume,
migration paged -> paged -> dense -> dense -> paged, checkpoints restored
across planes, release.  Batched MoE decode is not independent per lane
(masked lanes compete for expert capacity), so the batch composition is the
same in both.  After every call the two must agree on the tokens emitted
(exactly), on the migration packages' ``logical_bytes``, on
``dispatch_stats`` (less the decode-timing fields), block ids, lane slots
and ``kv_bytes``, and on every lane's KV (its own pages, never scratch
block 0) and recurrent state within 2e-5.

The last test holds the reference hazard of ``ROADMAP.md`` Queue 3 item 9:
a paged xLSTM lane readmitted into a released slot.
"""

from dataclasses import replace

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

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# not compared with the JAX worker: decode timing, and the CUDA-graph
# counters (zero on the CPU; the JAX worker has none)
TIMING = {"decode_wall_s", "decode_timed_steps", "decode_timed_lane_steps",
          "decode_graph_steps", "decode_graph_captures"}
TOL = 2e-5
PROMPT = [3 + i for i in range(20)]
PROMPT2 = [7, 11, 13, 5, 2, 9, 40, 41, 42, 43, 44]
TOOL = [101, 102, 103]
N = 4                                          # decode steps per call (one JAX compile)
PAGED = dict(capacity=64, max_slots=4, page_size=8, chunk_size=8)
DENSE = dict(capacity=64, max_slots=4, paged=False, chunk_size=8)


def _configs(name):
    jfull, full = jax_config(name), get_config(name)
    periods = 2 if len(full.block_pattern) == 1 else 1
    jcfg, cfg = jfull.reduced(n_periods=periods), full.reduced(n_periods=periods)
    if cfg.n_experts:
        cf = float(cfg.n_experts) / cfg.top_k + 1
        jcfg, cfg = replace(jcfg, capacity_factor=cf), replace(cfg, capacity_factor=cf)
    return jcfg, cfg


def _models(name):
    jcfg, cfg = _configs(name)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _lanes(w) -> dict:
    """seq_id -> {leaf: numpy copy} of the lane's first min(len(tokens),
    capacity) KV positions (gathered through its pages on a paged worker)
    and its recurrent state rows."""
    out = {}
    for sid, seq in w.store.items():
        n = min(len(seq.tokens), w.capacity)
        leaves = {}
        for key, c in w.pool["blocks"].items():
            for name, leaf in c.items():
                leaf = np.array(leaf)
                if name not in ("k", "v"):             # recurrent state: one row a lane
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

    def move(src, dst, sid, checkpoint=False):
        pkg = src.checkpoint_out(sid) if checkpoint else src.migrate_out(sid)
        dst.migrate_in(pkg)
        return pkg["logical_bytes"]

    a.prefill(1, PROMPT)
    a.prefill(2, PROMPT)                       # a sibling
    a.prefill(3, PROMPT2)
    c.prefill(4, PROMPT)                       # dense-plane admission
    step("prefill")
    step("decode", {"a": a.decode([1, 2, 3], N), "c": c.decode([4], N)})
    a.extend(1, TOOL)
    c.extend(4, TOOL)
    step("extend")
    a.preempt(2)
    step("decode_preempted", a.decode([1, 3], N))
    step("resume", a.decode([2], N))
    step("migrate_paged", (move(a, b, 3), b.decode([3], N)))
    step("migrate_to_dense", (move(b, c, 3), c.decode([3, 4], N)))
    step("migrate_dense", (move(c, d, 3), d.decode([3], N)))
    step("migrate_to_paged", (move(d, a, 3), a.decode([1, 2, 3], N)))
    restored = (move(a, d, 1, checkpoint=True),   # a paged host copy on a dense worker
                move(c, b, 4, checkpoint=True))   # a dense host copy on a paged worker
    step("restore", (restored, {"d": d.decode([1], N), "a": a.decode([1], N),
                                "b": b.decode([4], N), "c": c.decode([4], N)}))
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


def _run(models, temp=1.0):
    jcfg, cfg, jparams, params = models
    logs = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            make = lambda wid, kw: JaxWorker(jcfg, jparams, worker_id=wid,      # noqa: E731
                                             sampler=JaxSampler(temp, 0.9), **kw)
        else:
            make = lambda wid, kw: RolloutWorker(cfg, params, worker_id=wid,     # noqa: E731
                                                 sampler=SamplerConfig(temp, 0.9),
                                                 device="cpu", **kw)
        workers = {"a": make(0, PAGED), "b": make(1, PAGED), "c": make(2, DENSE),
                   "d": make(3, DENSE)}
        log = []
        _script(workers, lambda label, result=None: log.append(
            (label, result, _snapshot(workers))))
        logs.append(log)
    return logs


@pytest.mark.parametrize("name", ["qwen2_moe_a2_7b", "arctic_480b", "xlstm_350m"])
def test_family_worker_matches_jax(name):
    models = _models(name)
    cfg = models[1]
    jax_log, port_log = _run(models)
    assert [s[0] for s in jax_log] == [s[0] for s in port_log]
    for (label, want, jsnap), (_, got, snap) in zip(jax_log, port_log):
        assert got == want, label
        for wname, j in jsnap.items():
            p = snap[wname]
            for field in ("stats", "pages", "slots", "kv_bytes"):
                assert p[field] == j[field], (label, wname, field)
            for sid, leaves in j["lanes"].items():
                assert leaves.keys() == p["lanes"][sid].keys()
                for leaf, want_v in leaves.items():
                    np.testing.assert_allclose(p["lanes"][sid][leaf], want_v, atol=TOL, rtol=0,
                                               err_msg=f"{label} {wname} seq {sid} {leaf}")
    for label, _, snap in port_log:
        for wname in ("a", "b"):
            assert check_block_conservation(snap[wname]["stats"]) == [], (label, wname)
    stats = port_log[-1][2]["a"]["stats"]
    assert stats["reused_tokens"] == 0                       # no radix reuse in these families
    assert stats["absorbed_tokens"] == len(TOOL)
    if cfg.n_experts:
        assert stats["prefill_dispatches"] == 0              # whole-prompt admission
    else:
        assert stats["prefill_dispatches"] > 0               # chunked recurrent admission
        assert port_log[0][2]["a"]["kv_bytes"][1] == port_log[0][2]["c"]["kv_bytes"][4]


def test_paged_readmission_starts_from_a_fresh_state():
    """The reference hazard (``ROADMAP.md`` Queue 3 item 9): the JAX paged
    worker's chunked admission into a released slot keeps the previous
    occupant's recurrent state, so its sLSTM state drifts from the JAX dense
    worker's, which starts every admission fresh.  The port's paged worker
    resets the row: its state equals the JAX dense worker's."""
    jcfg = jax_config("xlstm_350m").reduced(n_periods=1)
    cfg = get_config("xlstm_350m").reduced(n_periods=1)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    kw = dict(capacity=32, max_slots=1, page_size=8)
    workers = {"jax_paged": JaxWorker(jcfg, jparams, **kw),
               "jax_dense": JaxWorker(jcfg, jparams, paged=False, **kw),
               "port_paged": RolloutWorker(cfg, params, device="cpu", **kw)}
    tokens = {}
    for name, w in workers.items():
        w.prefill(1, [5, 7, 9, 11, 13, 17])
        w.decode([1], 20)
        w.release(1)
        w.prefill(2, [3])                      # lands in the released slot
        tokens[name] = w.decode([2], 10)[2]
    assert workers["jax_paged"].store[2].slot == workers["port_paged"].store[2].slot == 0
    state = {name: _lanes(w)[2] for name, w in workers.items()}
    slstm = [k for k in state["jax_dense"] if "slstm" in k]
    drift = max(float(np.abs(state["jax_paged"][k] - state["jax_dense"][k]).max())
                for k in slstm)
    assert drift > 1e-3, drift                 # the hazard shows in the reference
    for k, want in state["jax_dense"].items():
        np.testing.assert_allclose(state["port_paged"][k], want, atol=TOL, rtol=0, err_msg=k)
    assert tokens["port_paged"] == tokens["jax_dense"]
