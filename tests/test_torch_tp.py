"""Tensor-parallel rollout workers: a worker of MP degree d on a mesh of d
shards, every shard on the CPU, against the JAX worker and the port's
degree-1 worker.

``qwen3_1_7b.reduced(n_periods=2)`` (f32; 4 q and 4 kv heads, d_ff 512,
vocab 512: every group cut at degree 2 and 4), the same at G 2
(``n_heads=8, n_kv_heads=4``: a shard holds kv heads [r KV/d, (r+1) KV/d)
and the q heads that read them) and ``smollm_135m.reduced(n_periods=1)`` (3
heads: attention replicated at degree 2, the MLP and vocabulary cut), on the
paged and the dense plane.  Each worker runs one script (sibling admissions
with radix reuse, decode at temperature 1 / top-p 0.9, a tool extension,
preempt and resume); the tokens, block ids and dispatch counters must be
the JAX worker's, and a teacher-forced decode step's logits must lie within
``LOGIT_TOL`` of the JAX worker's and of the degree-1 worker's.

``LOGIT_TOL``: the shards' partial ``wo`` and MLP products are summed in
shard order where one product sums them in one pass, which reorders f32
sums and nothing else.  At these widths the logits reach |4|, where an f32
ulp is 4.8e-7; the reordering moves them by up to 6e-7 against the degree-1
worker, which itself differs from the JAX worker by up to 1.2e-6 (another
order of the same sums).  5e-6, about 10 ulps, is a few times both.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import runtime as JR
from repro.engine.fleet import FleetSpec as JaxFleetSpec
from repro.engine.fleet import RolloutFleet as JaxFleet
from repro.engine.sampler import SamplerConfig as JaxSampler
from repro.engine.worker import RolloutWorker as JaxWorker
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import gather_params
from repro_torch.engine import runtime as TR
from repro_torch.engine.fleet import FleetSpec, RolloutFleet
from repro_torch.engine.sampler import SamplerConfig
from repro_torch.engine.worker import RolloutWorker
from repro_torch.launch.mesh import WorkerMesh
from repro_torch.models import model as M

from _torch_parity import (ONE_THREAD_ENV, jax_and_port, one_torch_thread,  # noqa: F401
                           rcfg, same_ids, to_np, tree_paths, workbench)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TIMING = {"decode_wall_s", "decode_timed_steps", "decode_timed_lane_steps"}
LOGIT_TOL = 5e-6
KW = dict(capacity=64, max_slots=4, page_size=8, chunk_size=8)
PROMPT = [3 + i for i in range(20)]
GREEDY = SamplerConfig(temperature=0.0)
REPO = Path(__file__).resolve().parents[1]
MODELS = {"qwen3": ("qwen3_1_7b", dict(n_periods=2)),
          "qwen3-g2": ("qwen3_1_7b", dict(n_periods=2, n_heads=8, n_kv_heads=4)),
          "smollm": ("smollm_135m", dict(n_periods=1))}
CASES = [("qwen3", "paged", 2), ("qwen3", "paged", 4), ("qwen3", "dense", 2),
         ("qwen3", "dense", 4), ("qwen3-g2", "paged", 2), ("qwen3-g2", "paged", 4),
         ("qwen3-g2", "dense", 2), ("smollm", "paged", 2)]


def _mesh(d: int) -> WorkerMesh:
    return WorkerMesh((torch.device("cpu"),) * d)


def _script(w) -> dict:
    """The scenario; returns tokens, block ids and untimed counters."""
    out = {}
    w.prefill(1, PROMPT)
    w.prefill(2, PROMPT)                       # sibling: radix reuse
    w.prefill(3, [7, 11, 13, 5, 2, 9, 40, 41, 42, 43, 44])
    out["decode"] = w.decode([1, 2, 3], 6)
    w.extend(1, [101, 102, 103, 104, 105, 106])
    w.preempt(2)
    out["preempted"] = w.decode([1, 3], 4)
    out["resume"] = w.decode([2], 3)
    out["pages"] = {s: list(b) for s, b in getattr(w, "lane_pages", {}).items()}
    out["stats"] = {k: v for k, v in w.dispatch_stats().items()
                    if k not in TIMING | {"mp", "mesh_devices"}}     # the degree aside
    return out


def _tokens(w) -> np.ndarray:
    """Every lane's last token, the teacher-forced step's input (B, 1)."""
    last = np.zeros((w.max_slots, 1), np.int32)
    for seq in w.store.values():
        last[seq.slot, 0] = seq.tokens[-1]
    return last


@pytest.fixture(scope="module")
def refs():
    """(model, plane) -> (JAX script, JAX logits, port degree-1 script and
    logits, configs and params), built once each."""
    cache = {}

    def get(model, plane):
        if (model, plane) not in cache:
            name, kw = MODELS[model]
            jcfg, cfg, jparams, params = jax_and_port(name, **kw)
            paged = plane == "paged"
            jw = JaxWorker(jcfg, jparams, sampler=JaxSampler(1.0), paged=paged, **KW)
            one = RolloutWorker(cfg, params, sampler=SamplerConfig(1.0), paged=paged,
                                device="cpu", **KW)
            jout, oout = _script(jw), _script(one)
            toks = _tokens(one)
            jlogits, _ = JM.decode_step(jcfg, jparams, jw.pool, jnp.asarray(toks))
            ologits, _ = M.decode_step(cfg, one.params, one.pool, torch.from_numpy(toks))
            cache[model, plane] = (jout, to_np(jlogits), oout, to_np(ologits), cfg, params)
        return cache[model, plane]

    return get


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}-d{c[2]}")
def case(request, refs):
    model, plane, d = request.param
    jout, jlogits, oout, ologits, cfg, params = refs(model, plane)
    w = RolloutWorker(cfg, params, sampler=SamplerConfig(1.0), paged=plane == "paged",
                      mp=d, mesh=_mesh(d), **KW)
    out = _script(w)
    logits, _ = M.decode_step(cfg, w.params, w.pool, torch.from_numpy(_tokens(w)), mesh=w._tp)
    return w, out, to_np(logits), jout, jlogits, oout, ologits


def test_sharded_worker_matches_jax_worker(case):
    w, out, _, jout, _, oout, _ = case
    assert out == jout                            # tokens, block ids, counters
    assert out == oout
    stats = w.dispatch_stats()
    assert stats["mesh_devices"] == stats["mp"] == w.mp


def test_sharded_logits_within_tolerance(case):
    w, _, logits, _, jlogits, _, ologits = case
    lanes = sorted(seq.slot for seq in w.store.values())
    assert np.abs(logits[lanes] - jlogits[lanes]).max() <= LOGIT_TOL
    assert np.abs(logits[lanes] - ologits[lanes]).max() <= LOGIT_TOL


def test_shards_hold_their_part(case):
    """Each shard holds 1/d of the cut weights and of the kv heads, on its
    device; the page table and pos are the same on every shard."""
    w = case[0]
    d, cfg, split = w.mp, w.cfg, w.split
    heads = cfg.n_kv_heads // d if split.attn else cfg.n_kv_heads
    assert len(w.params) == len(w.pool) == d
    for pool in w.pool:
        for key, c in pool["blocks"].items():
            assert c["k"].shape[-2] == heads and c["v"].shape[-2] == heads, key
        for name in ("pos", "page_table"):
            if name in pool:
                assert torch.equal(pool[name], w.pool[0][name])
    assert w.params[0]["tok_embed"].shape[0] == cfg.vocab // d
    mlp = w.params[0]["blocks"]["00_attn+mlp"]["mlp"]["w_in"]
    assert mlp.shape[-1] == cfg.d_ff // d
    assert all(t.device == torch.device("cpu") for p in w.params for t in M.tree_leaves(p))


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen3_1_7b").reduced(n_periods=2)
    return cfg, M.init_params(cfg, seed=0, device="cpu")


def _worker(cfg, params, d, wid=0, **kw):
    return RolloutWorker(cfg, params, worker_id=wid, sampler=GREEDY, mp=d,
                         mesh=None if d == 1 else _mesh(d), device="cpu", **dict(KW, **kw))


def _payload(pkg) -> dict:
    return {k: v for k, v in tree_paths({n: pkg[n] for n in ("pages", "state", "cache")
                                         if n in pkg}).items()}


@pytest.mark.parametrize("plane", ["paged", "dense"])
def test_migration_crosses_degrees_bit_equal(qwen, plane):
    """A lane moves d2 -> d1 -> d4 -> d2: every package (the full-head
    layout) is bit-equal to the first, and the lane decodes on as an
    unmigrated one does."""
    cfg, params = qwen
    paged = plane == "paged"
    ref = _worker(cfg, params, 1, paged=paged)
    hops = [_worker(cfg, params, d, wid=i, paged=paged) for i, d in enumerate((2, 1, 4, 2))]
    for w in (ref, hops[0]):
        w.prefill(7, PROMPT)
    straight = ref.decode([7], 12)[7]
    first = hops[0].decode([7], 4)[7]
    pkg = hops[0].migrate_out(7)
    want = _payload(pkg)
    assert all(t.device == torch.device("cpu") for t in want.values())
    for src, dst in zip(hops, hops[1:]):
        if src is not hops[0]:
            pkg = src.migrate_out(7)
            got = _payload(pkg)
            assert got.keys() == want.keys()
            for name, t in want.items():
                assert got[name].dtype == t.dtype and torch.equal(got[name].cpu(), t), name
        dst.migrate_in(pkg)
    assert first + hops[-1].decode([7], 8)[7] == straight
    assert hops[-1].store[7].tokens == ref.store[7].tokens


def test_migration_crosses_layouts_and_degrees(qwen):
    """A paged d2 lane lands on a dense d4 worker and back on a paged d1
    one, decoding on as an unmigrated lane."""
    cfg, params = qwen
    ref = _worker(cfg, params, 1)
    src, mid, dst = (_worker(cfg, params, 2), _worker(cfg, params, 4, wid=1, paged=False),
                     _worker(cfg, params, 1, wid=2))
    for w in (ref, src):
        w.prefill(5, PROMPT)
    straight = ref.decode([5], 9)[5]
    got = src.decode([5], 3)[5]
    mid.migrate_in(src.migrate_out(5))
    got += mid.decode([5], 3)[5]
    dst.migrate_in(mid.checkpoint_out(5))
    assert got + dst.decode([5], 3)[5] == straight


def test_weight_sync_reshards(qwen):
    """Setting a sharded worker's params (the runtime's weight sync) cuts
    the new tree for its mesh."""
    cfg, params = qwen
    w = _worker(cfg, params, 2)
    new = M.tree_map(lambda t: t * 2, params)
    w.params = new
    back = gather_params(w.params, w.split)
    assert all(torch.equal(a, b) for a, b in zip(M.tree_leaves(back), M.tree_leaves(new)))


# ---------------------------------------------------------------- the fleet

def _fleet(cfg, params, degrees, devices, **kw):
    return RolloutFleet(cfg, params, FleetSpec(degrees), capacity=32, max_slots=2,
                        sampler=GREEDY, device="cpu",
                        devices=None if devices is None else ["cpu"] * devices, **kw)


def test_fleet_builds_meshes_over_its_devices(qwen):
    cfg, params = qwen
    fleet = _fleet(cfg, params, (2, 1, 1), 4)
    assert [w.mesh.degree for w in fleet.workers] == [2, 1, 1]
    assert [w.mp for w in fleet.workers] == [2, 1, 1]
    assert isinstance(fleet.workers[0].params, list) and isinstance(fleet.workers[1].params,
                                                                    dict)
    # the default device set (the fleet's one device) covers no degree above 1
    plain = _fleet(cfg, params, (2, 1, 1), None)
    assert [w.mesh for w in plain.workers] == [None] * 3
    shared = [t.data_ptr() for t in M.tree_leaves(plain.params)]
    for w in plain.workers:                       # unsharded workers share one copy
        assert [t.data_ptr() for t in M.tree_leaves(w.params)] == shared


def test_fleet_reconfigure_migrates_residents_across_degrees(qwen):
    """(2, 2) -> (2, 1, 1): slot 0 keeps its degree, mesh and block and is
    reused; slot 1 becomes a one-device worker and its resident moves from
    two shards to one, decoding on as an unmigrated lane."""
    cfg, params = qwen
    fleet = _fleet(cfg, params, (2, 2), 4)
    ref = RolloutWorker(cfg, params, capacity=32, max_slots=2, worker_id=1, sampler=GREEDY,
                        device="cpu")
    fleet.workers[1].prefill(5, PROMPT)
    ref.prefill(5, PROMPT)
    first = fleet.workers[1].decode([5], 6)[5]
    keep = fleet.workers[0]
    report = fleet.reconfigure(FleetSpec((2, 1, 1)))
    assert report["to"] == [2, 1, 1] and report["migrated_residents"] == 1
    assert report["reused"] == [0] and report["rebuilt"] == [1, 2]
    assert fleet.workers[0] is keep
    assert fleet.workers[1].mp == 1 and fleet.workers[1].mesh.degree == 1
    assert 5 in fleet.workers[1].store
    assert first + fleet.workers[1].decode([5], 6)[5] == ref.decode([5], 12)[5]


def test_fleet_reconfigure_rebuilds_on_shifted_blocks(qwen):
    """(2, 1, 1) -> (3, 1): slot 1 keeps degree 1 but its block moves from
    device 2 to device 3, so it is rebuilt and its resident moves."""
    cfg, params = qwen
    fleet = _fleet(cfg, params, (2, 1, 1), 4)
    fleet.workers[1].prefill(3, PROMPT)
    report = fleet.reconfigure(FleetSpec((3, 1)))
    assert report["reused"] == [] and report["rebuilt"] == [0, 1]
    assert report["migrated_residents"] == 1 and 3 in fleet.workers[1].store
    assert fleet.workers[0].mesh.degree == 3      # 4 heads on 3 shards: replicated attention
    assert fleet.workers[0].split.attn is False


@pytest.mark.parametrize("devices", [3, None], ids=["meshed", "one-device"])
def test_fleet_reconfigure_on_mesh_presence_matches_jax(qwen, devices):
    """(2, 1) -> (1, 1): a meshed fleet crosses out of meshes and rebuilds
    every slot; on the fleet's one device nothing was meshed and slot 1 is
    reused by degree alone, as the JAX fleet on its one CPU device does."""
    cfg, params = qwen
    fleet = _fleet(cfg, params, (2, 1), devices)
    report = fleet.reconfigure(FleetSpec((1, 1)))
    assert all(w.mesh is None for w in fleet.workers)
    if devices is None:
        jcfg, _, jparams, _ = jax_and_port("qwen3_1_7b", n_periods=2)
        jfleet = JaxFleet(jcfg, jparams, JaxFleetSpec((2, 1)), capacity=32, max_slots=2,
                          sampler=JaxSampler(0.0))
        assert report == jfleet.reconfigure(JaxFleetSpec((1, 1)))
        assert report["reused"] == [1]
    else:
        assert report["rebuilt"] == [0, 1]


def _result(r):
    stats = {w: {k: v for k, v in s.items() if k not in TIMING and k != "mesh_devices"}
             for w, s in r.worker_stats.items()}
    return (r.trace, r.makespan, r.preemptions, r.migrations, r.total_tokens, stats)


@pytest.mark.parametrize("plane", [dict(paged=None, link_bandwidth=2e9),
                                   dict(paged=False, link_bandwidth=math.inf)],
                         ids=["paged-2e9", "dense-inf"])
def test_runtime_on_a_sharded_fleet_matches_jax_trace(plane):
    """A {2, 1, 1} fleet over four CPU devices (worker 0 on two shards)
    under ``make_runtime`` gives the JAX runtime's decision trace event for
    event (its workers unsharded on its one device), and the same makespan,
    counts and counters."""
    jcfg, cfg, jparams, params = jax_and_port("qwen3_1_7b", n_periods=1)
    (jb, jp), (tb, tp) = workbench()
    with same_ids():
        want = JR.make_runtime(jcfg, jparams, jb, jp, config=rcfg(JR, **plane),
                               fleet=JaxFleetSpec((2, 1, 1))).run()
    with same_ids():
        rt = TR.make_runtime(cfg, params, tb, tp, config=rcfg(TR, **plane),
                             fleet=FleetSpec((2, 1, 1)), device="cpu", devices=["cpu"] * 4)
        assert [w.mesh.degree for w in rt.fleet.workers] == [2, 1, 1]
        got = rt.run()
    assert got.preemptions > 0 and len(got.trace) > 0
    assert _result(got) == _result(want)
    assert got.worker_stats[0]["mesh_devices"] == 2


# ---------------------------------------------------------------- refusals

@pytest.mark.parametrize("name", ["xlstm_350m"])
def test_mixers_outside_the_split_raise(name):
    """No mixer is outside the split any more: an xLSTM worker builds on a
    mesh, its shards hold their heads, and a decode step on the mesh gives
    the unsharded step's logits.  What still raises is the worker on a
    cross-attention config, at every degree (``check_servable``)."""
    cfg = get_config(name).reduced(n_periods=1)
    params = M.init_params(cfg, seed=0, device="cpu")
    w = RolloutWorker(cfg, params, mp=2, mesh=_mesh(2), **KW)
    assert w.split.xlstm and w.shard_cfg.n_heads == cfg.n_heads // 2
    one = M.init_cache(cfg, 1, 8, "cpu")
    caches = [M.init_cache(w.shard_cfg, 1, 8, "cpu") for _ in range(2)]
    tok = torch.full((1, 1), 5, dtype=torch.long)
    logits, _ = M.decode_step(cfg, w.params, caches, tok, mesh=_mesh(2))
    want, _ = M.decode_step(cfg, params, one, tok)
    assert torch.allclose(logits, want, atol=LOGIT_TOL, rtol=0)
    vlm = get_config("llama_3_2_vision_11b").reduced(n_periods=1)
    with pytest.raises(NotImplementedError, match="cross-attention"):
        RolloutWorker(vlm, M.init_params(vlm, seed=0, device="cpu"), mp=2, mesh=_mesh(2),
                      **KW)


def test_sharded_worker_guards(qwen):
    cfg, params = qwen
    with pytest.raises(ValueError, match="MP degree"):
        RolloutWorker(cfg, params, mp=4, mesh=_mesh(2), **KW)


def _serve(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **ONE_THREAD_ENV)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_serve_cli_shards_over_devices():
    out = _serve("--device", "cpu", "--devices", "cpu,cpu,cpu", "--degrees", "2,1",
                 "--requests", "8", "--steps", "2")
    assert out.returncode == 0, out.stderr
    assert "worker 0 (MP 2 over 2 devices)" in out.stdout and "worker 1 (MP 1)" in out.stdout
    assert "served 8 trajectories on cpu" in out.stdout
    refused = _serve("--device", "cpu", "--devices", "cpu", "--degrees", "2,1")
    assert refused.returncode == 2 and "MP-2 worker but only 1 device" in refused.stderr


def test_serve_cli_refuses_a_bad_device_list(capsys):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit) as err:
        serve.main(["--device", "cpu", "--devices", "cpu,bogus", "--degrees", "2"])
    assert err.value.code == 2 and "--devices" in capsys.readouterr().err
