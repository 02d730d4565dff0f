"""The port's rollout runtime (orchestrator + EngineBackend over the port's
workers) against the JAX package's, on the reference harness's workload.

``smollm_135m.reduced(n_periods=1)`` (f32) with the JAX ``init_params``
converted by ``from_jax``, the workload ``build_workbench(n_prompts=6,
group_size=4, seed=5)`` (24 trajectories, 448 planned tokens) and the
reference harness's config (``tests/test_orchestrator.py``): pps, migration,
2 active lanes a worker, quantum 8, sanitizer on.  The decision trace does
not depend on the sampled tokens (step lengths come from the plan), so it is
compared with ``==``; so are makespan, preemptions, migrations, the real
tokens decoded and each worker's ``dispatch_stats`` (the decode-timing fields
aside: the JAX worker times only calls that compiled nothing).  At the
default 2e9 link the engines price migrations from their packages'
``logical_bytes``, which must agree for the traces to.
"""

import copy
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jax_ckpt
from repro.core.faults import FaultPlan as JaxFaultPlan
from repro.configs import get_config as jax_config
from repro.engine import runtime as JR
from repro.engine.fleet import FleetSpec as JaxFleetSpec
from repro.models import model as JM
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.core.faults import FaultPlan
from repro_torch.engine import runtime as TR
from repro_torch.engine.fleet import FleetSpec
from repro_torch.engine.worker import RolloutWorker
from repro_torch.models import model as M
from repro_torch.params import from_jax

from _torch_parity import SEED, rcfg, workbench

TIMING = {"decode_wall_s", "decode_timed_steps", "decode_timed_lane_steps"}
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: its thousands of tiny ops
    gain nothing from a thread pool, and beside other test workers on the
    same cores the pool's threads wait on one another, which made a run many
    times as long.  Results do not depend on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("smollm_135m").reduced(n_periods=1)
    cfg = get_config("smollm_135m").reduced(n_periods=1)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _untimed(stats):
    return {w: {k: v for k, v in s.items() if k not in TIMING} for w, s in stats.items()}


def _result(r):
    return (r.trace, r.makespan, r.preemptions, r.migrations, r.total_tokens,
            r.worker_deaths, r.recoveries, r.tool_retries, r.injected_tool_faults,
            _untimed(r.worker_stats))


PLANES = {"paged-inf": dict(paged=None, link_bandwidth=math.inf),
          "paged-2e9": dict(paged=None, link_bandwidth=2e9),
          "dense-inf": dict(paged=False, link_bandwidth=math.inf),
          "dense-2e9": dict(paged=False, link_bandwidth=2e9)}


@pytest.fixture(scope="module", params=list(PLANES))
def engine_runs(request, models):
    """(JAX engine result, port engine result, port sim result, port batch,
    the plane's config)."""
    jcfg, jparams, cfg, params = models
    kw = PLANES[request.param]
    (jb, jp), (tb, tp) = workbench()
    twin = copy.deepcopy(tb)
    want = JR.make_runtime(jcfg, jparams, jb, jp, n_workers=2, config=rcfg(JR, **kw)).run()
    got = TR.make_runtime(cfg, params, tb, tp, n_workers=2, config=rcfg(TR, **kw),
                          device="cpu").run()
    sim = TR.run_on_sim(twin, tp, n_workers=2, config=rcfg(TR, **kw))
    return want, got, sim, tb, kw


def test_engine_matches_jax_engine(engine_runs):
    want, got, _, _, _ = engine_runs
    assert got.preemptions > 0 and got.migrations > 0        # the test must bite
    assert len(got.trace) > 0
    assert _result(got) == _result(want)


def test_engine_matches_port_sim(engine_runs):
    """At an infinite link the engine's trace is its analytic twin's; at 2e9
    the engine prices measured bytes and the sim analytic ones."""
    _, got, sim, _, kw = engine_runs
    if math.isinf(kw["link_bandwidth"]):
        assert got.trace == sim.trace and got.makespan == sim.makespan
        assert (got.preemptions, got.migrations) == (sim.preemptions, sim.migrations)
    else:
        assert len(got.trace) == len(sim.trace) and got.migrations == sim.migrations


def test_engine_run_is_sane(engine_runs):
    _, got, _, batch, _ = engine_runs
    assert got.sanitizer["violations"] == 0
    assert got.sanitizer["block_conservation"] == "ok"
    assert all(t.finished for t in batch)
    assert got.total_tokens == sum(t.payload.total_tokens for t in batch) == 448


def test_chaos_engine_matches_jax_and_sim_and_checkpoints_load(models, tmp_path):
    """Under the chaos plan of tests/test_faults.py (one worker death and
    revival, injected tool faults) every trajectory finishes; the port's
    engine gives the JAX engine's trace exactly; every persisted checkpoint
    loads back, through the port's restore and the JAX package's, equal to
    the package the engine held when it wrote it.

    Against the sim the trace agrees but for the order of ``restore_done``
    events: a trajectory that died before its first tool boundary is
    re-prefilled from its prompt, which the engine prices as an admission and
    the sim as a transfer (the JAX package does the same; the makespan is
    equal)."""
    jcfg, jparams, cfg, params = models
    (jb, jp), (batch, pred) = workbench()
    base = TR.run_on_sim(copy.deepcopy(batch), pred, n_workers=2, config=rcfg(TR))
    faults = FaultPlan.chaos(seed=SEED, n_workers=2, horizon=base.makespan)
    sim = TR.run_on_sim(copy.deepcopy(batch), pred, n_workers=2, config=rcfg(TR),
                        faults=faults)
    want = JR.make_runtime(jcfg, jparams, jb, jp, n_workers=2, config=rcfg(JR),
                           faults=JaxFaultPlan(**vars(faults))).run()
    rt = TR.make_runtime(cfg, params, batch, pred, n_workers=2, faults=faults,
                         config=rcfg(TR, checkpoint_dir=str(tmp_path)), device="cpu")
    written = {}
    checkpoint = rt.backend.checkpoint

    def recording(traj):
        checkpoint(traj)
        if traj.traj_id in rt.backend.ckpts:
            written[traj.traj_id] = rt.backend.ckpts[traj.traj_id]

    rt.backend.checkpoint = recording
    got = rt.run()
    assert got.worker_deaths == 1 and got.recoveries > 0 and got.injected_tool_faults > 0
    assert all(t.finished for t in batch)
    assert got.sanitizer["violations"] == 0
    assert _result(got) == _result(want)
    assert TR.split_restores(got.trace) == TR.split_restores(sim.trace)
    assert got.makespan == sim.makespan and got.recoveries == sim.recoveries
    assert written and sorted(os.listdir(tmp_path)) == [f"traj_{t:05d}" for t in sorted(written)]
    for tid, pkg in written.items():
        path = str(tmp_path / f"traj_{tid:05d}")
        tree = {"pages": pkg["pages"], "state": pkg["state"], "key": np.asarray(pkg["key"])}
        back = ckpt.restore(path, tree)
        for a, b in zip(ckpt._flatten(back), ckpt._flatten(tree)):
            assert torch.equal(a, b) if torch.is_tensor(b) else np.array_equal(a, b)
        host = _numpy(tree)
        for a, b in zip(jax.tree.leaves(jax_ckpt.restore(path, host)), jax.tree.leaves(host)):
            np.testing.assert_array_equal(np.asarray(a), b)
        assert ckpt.load_step(path) == jax_ckpt.load_step(path) > 0


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)


@pytest.mark.parametrize("paged", [None, False], ids=["paged", "dense"])
def test_checkpoint_written_by_port_restores_in_jax(models, tmp_path, paged):
    """``EngineBackend.checkpoint`` with ``checkpoint_dir`` persists a lane that
    the JAX package's ``restore`` reads with the JAX worker's own package as the
    template: its leaves equal the port's package exactly and the JAX
    package's within f32 rounding."""
    jcfg, jparams, cfg, params = models
    (jb, jp), (tb, tp) = workbench()
    config = dict(paged=paged, checkpoint_dir=str(tmp_path / "port"))
    jrt = JR.make_runtime(jcfg, jparams, jb[:4], jp, n_workers=2, config=rcfg(JR, **config))
    trt = TR.make_runtime(cfg, params, tb[:4], tp, n_workers=2, config=rcfg(TR, **config),
                          device="cpu")
    for rt, batch in ((jrt, jb[:4]), (trt, tb[:4])):
        for t in batch:
            t.worker_id = 0
        rt.backend.admit(batch)
    tid = tb[1].traj_id
    trt.backend.checkpoint(tb[1])
    pkg = trt.backend.ckpts[tid]
    jpkg = jrt.workers[0].engine.checkpoint_out(tid)
    kv = ("cache",) if paged is False else ("pages", "state")
    template = {**{k: jpkg[k] for k in kv}, "key": np.asarray(jpkg["key"])}
    back = jax_ckpt.restore(str(tmp_path / "port" / f"traj_{tid:05d}"), template)
    port_leaves = ckpt._flatten({**{k: pkg[k] for k in kv}, "key": pkg["key"]})
    jax_leaves = jax.tree.leaves(template)
    assert len(jax.tree.leaves(back)) == len(port_leaves) == len(jax_leaves) > 1
    for got, mine, ref in zip(jax.tree.leaves(back), port_leaves, jax_leaves):
        np.testing.assert_array_equal(np.asarray(got), _numpy(mine))
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-5, rtol=0)
    assert pkg["logical_bytes"] == jpkg["logical_bytes"]


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _to_jax(leaf):
    if leaf.dtype == torch.bfloat16:
        return jax.lax.bitcast_convert_type(jax.numpy.asarray(_bits(leaf).numpy()),
                                            jax.numpy.bfloat16)
    return jax.numpy.asarray(leaf.numpy())


def test_bf16_checkpoint_across_packages(tmp_path):
    """A bf16 lane (qwen3 reduced in bf16): the port's ``restore`` gives its
    bits back from a checkpoint of either package; the JAX ``restore``
    refuses the port's bf16 checkpoint, as it refuses its own, and never
    reads the stored bit patterns as numbers."""
    cfg = get_config("qwen3_1_7b").reduced(n_periods=1, dtype="bfloat16")
    worker = RolloutWorker(cfg, M.init_params(cfg, seed=0, device="cpu"), capacity=64,
                           max_slots=1, device="cpu")
    worker.prefill(1, [3 + i for i in range(20)])
    worker.decode([1], 2)
    pkg = worker.checkpoint_out(1)
    tree = {"pages": pkg["pages"], "state": pkg["state"]}
    leaves = ckpt._flatten(tree)
    assert sum(t.dtype == torch.bfloat16 for t in leaves) >= 2
    jtree = jax.tree.map(_to_jax, tree)
    for pkg_name, save in (("port", ckpt.save), ("jax", jax_ckpt.save)):
        path = str(tmp_path / pkg_name)
        save(path, tree if pkg_name == "port" else jtree, step=3)
        back = ckpt._flatten(ckpt.restore(path, tree))
        assert len(back) == len(leaves)
        for a, b in zip(back, leaves):
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    with pytest.raises(ValueError):
        jax_ckpt.restore(str(tmp_path / "port"), jtree)
    with pytest.raises(ValueError):
        jax_ckpt.restore(str(tmp_path / "jax"), jtree)


def test_weight_sync_keeps_the_trace(models):
    """``sync_weights`` swaps the staged params in (onto the worker's device)
    and drops every cached lane: synced before the run, the trace is the
    sim's; synced after it, the retired lanes are gone."""
    _, _, cfg, params = models
    _, (batch, pred) = workbench()
    sim = TR.run_on_sim(copy.deepcopy(batch), pred, n_workers=2, config=rcfg(TR))
    rt = TR.make_runtime(cfg, params, batch, pred, n_workers=2, config=rcfg(TR),
                         device="cpu")
    for epoch in (1, 2):
        fresh = _clone(params)
        rt.backend.stage_weights(fresh, epoch)
        for view in rt.workers:
            rt.backend.sync_weights(view.wid, epoch)
            assert not view.engine.store and not view.engine.retired
            for a, b in zip(M.tree_leaves(view.engine.params), M.tree_leaves(fresh)):
                assert a.data_ptr() == b.data_ptr()
        if epoch == 1:
            got = rt.run()
            assert got.trace == sim.trace and got.makespan == sim.makespan
            assert any(view.engine.retired for view in rt.workers)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def test_decisions_read_no_timing_field(models):
    """No decision inside ``run()`` reads ``decode_wall_s`` or
    ``decode_timed_*``: scrambling them in every stats snapshot the
    orchestrator records leaves the trace as it was."""
    _, _, cfg, params = models
    _, (batch, pred) = workbench()
    sim = TR.run_on_sim(copy.deepcopy(batch), pred, n_workers=2, config=rcfg(TR))
    rt = TR.make_runtime(cfg, params, batch, pred, n_workers=2, config=rcfg(TR),
                         device="cpu")
    rng = np.random.default_rng(0)
    stats = rt.backend.stats

    def scrambled(wid):
        out = dict(stats(wid))
        out.update(decode_wall_s=float(rng.uniform(0, 100)),
                   decode_timed_steps=int(rng.integers(1, 1000)),
                   decode_timed_lane_steps=int(rng.integers(1, 1000)))
        return out

    rt.backend.stats = scrambled
    got = rt.run()
    assert got.trace == sim.trace and got.makespan == sim.makespan


def test_reconfigure_matches_jax(models):
    """``RolloutRuntime.reconfigure(calibrate=False)`` gives the JAX report:
    a shrink with residents to move, a heterogeneous split, and Algorithm 2
    under a budget override.  (``calibrate=True`` differs by design: the
    workers' decode timings are measured, and differ.)"""
    jcfg, jparams, cfg, params = models
    (jb, jp), (tb, tp) = workbench(n_prompts=4, group_size=2)
    jrt = JR.make_runtime(jcfg, jparams, jb, jp, n_workers=3, config=rcfg(JR, migration=False))
    trt = TR.make_runtime(cfg, params, tb, tp, n_workers=3, config=rcfg(TR, migration=False),
                          device="cpu")
    for rt, batch in ((jrt, jb), (trt, tb)):
        for i, t in enumerate(batch):
            t.worker_id = i % 3
        rt.backend.admit(batch)
    keys = ("from", "to", "reused", "rebuilt", "migrated_residents", "moves")
    reports = []
    for jspec, spec in ((JaxFleetSpec.homogeneous(2), FleetSpec.homogeneous(2)),
                        (JaxFleetSpec((2, 1)), FleetSpec((2, 1))), (None, None)):
        want = jrt.reconfigure(jspec, calibrate=False, budget=2)
        got = trt.reconfigure(spec, calibrate=False, budget=2)
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
        assert [t.worker_id for t in tb] == [t.worker_id for t in jb]
        reports.append(got)
    assert reports[0]["migrated_residents"] > 0 and reports[1]["rebuilt"] == [0]
    assert trt.controller.degrees == list(trt.spec.degrees) == jrt.controller.degrees
    shared = [t.data_ptr() for t in M.tree_leaves(trt.fleet.params)]
    for view in trt.workers:                 # workers on one device share one copy
        assert [t.data_ptr() for t in M.tree_leaves(view.engine.params)] == shared


def _serve(*args, **env):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **env)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_serve_cli_runs_on_the_cpu_when_asked():
    out = _serve("--device", "cpu", "--requests", "8", "--steps", "2")
    assert out.returncode == 0, out.stderr
    assert "served 8 trajectories on cpu" in out.stdout
    assert "virtual makespan" in out.stdout and "preemptions" in out.stdout


def test_serve_cli_degrees_drive_the_control_plane_on_one_device():
    """``--degrees`` shapes the fleet the controller plans for; every worker
    runs unsharded on the one device, so an MP-2 worker needs no second one."""
    out = _serve("--device", "cpu", "--degrees", "2,1", "--requests", "8", "--steps", "2")
    assert out.returncode == 0, out.stderr
    assert "served 8 trajectories on cpu" in out.stdout and "across 2 workers" in out.stdout


def test_serve_cli_refuses_the_cpu_by_default():
    """With no CUDA device visible and no ``--device``, the CLI stops."""
    out = _serve("--requests", "8", "--steps", "2", CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "served" not in out.stdout


@pytest.mark.parametrize("flag", [["--stream", "4"], ["--dry-run"]])
def test_serve_cli_refuses_unported_modes(flag, capsys):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit) as err:
        serve.main(["--device", "cpu", *flag])
    assert err.value.code == 2
    assert ("not ported" if flag[0] == "--stream" else "no GPU counterpart") in \
        capsys.readouterr().err


def test_make_runtime_runs_on_the_card_by_default(models, monkeypatch):
    _, _, cfg, params = models
    _, (batch, pred) = workbench()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.make_runtime(cfg, params, batch, pred, n_workers=2, config=rcfg(TR))
