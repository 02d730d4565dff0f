"""The port's rollout-as-a-service plane: the replay buffer's discipline, the
streaming service on the analytic twin against the JAX package's (stamps,
staleness, decision trace and makespan equal, ``==``), the port's engine
backend against its own twin, the sanitizer's invariants for harvest and
weight-sync events, the async trainer's staleness bound, and the serve CLI's
``--stream`` demo (tests/test_service.py's cases, in the port).
"""

import copy
import math
import os
import subprocess
import sys

import pytest

from _torch_parity import ONE_THREAD_ENV, SEED, copy_predictor_state, same_ids
from _torch_parity import one_torch_thread  # noqa: F401
from repro.engine import runtime as JR
from repro.rl import service as JS
from repro_torch.analysis.sanitize import TraceSanitizer
from repro_torch.configs import get_config
from repro_torch.core.faults import FaultPlan
from repro_torch.core.trajectory import Trajectory
from repro_torch.engine import runtime as TR
from repro_torch.models import model as M
from repro_torch.rl import service as TS
from repro_torch.rl.service import ReplayBuffer, RolloutService

pytestmark = pytest.mark.usefixtures("one_torch_thread")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _traj(pid: int, sid: int, epoch: int = 0) -> Trajectory:
    t = Trajectory(prompt_id=pid, sample_id=sid, prompt_tokens=4, context_tokens=4)
    t.weight_epoch = epoch
    return t


# ------------------------------------------------------------- replay buffer

def test_replay_buffer_group_ready_only_when_complete():
    buf = ReplayBuffer(capacity=64, group_size=2)
    buf.add(_traj(0, 0))
    assert buf.ready_groups == 0
    assert buf.take(1, epoch=0, max_staleness=0) == []
    buf.add(_traj(0, 1))
    assert buf.ready_groups == 1
    (group,) = buf.take(1, epoch=0, max_staleness=0)
    assert [t.prompt_id for t in group] == [0, 0]
    assert len(buf) == 0 and buf.ready_groups == 0


def test_replay_buffer_takes_groups_in_completion_order():
    buf = ReplayBuffer(capacity=64, group_size=2)
    for pid, sid in ((0, 0), (1, 0), (1, 1), (0, 1)):     # group 1 completes first
        buf.add(_traj(pid, sid))
    assert [g[0].prompt_id for g in buf.take(2, epoch=0, max_staleness=0)] == [1, 0]


def test_replay_buffer_staleness_discards_the_whole_group():
    buf = ReplayBuffer(capacity=64, group_size=2)
    for pid, sid, epoch in ((0, 0, 0), (0, 1, 2), (1, 0, 2), (1, 1, 3)):
        buf.add(_traj(pid, sid, epoch=epoch))
    taken = buf.take(2, epoch=3, max_staleness=1)
    assert len(taken) == 1 and taken[0][0].prompt_id == 1
    assert buf.stale_discards == 2 and len(buf) == 0


def test_replay_buffer_capacity_evicts_oldest_ready_never_partial():
    buf = ReplayBuffer(capacity=3, group_size=2)
    for pid, sid in ((0, 0), (0, 1), (1, 0), (2, 0)):     # overflow evicts group 0
        buf.add(_traj(pid, sid))
    assert buf.evicted == 2 and buf.ready_groups == 0 and len(buf) == 2
    buf.add(_traj(1, 1))
    assert buf.ready_groups == 1
    with pytest.raises(ValueError):
        ReplayBuffer(capacity=3, group_size=0)


# ----------------------------------------------- service consumption harness

def _consume(R, S, batch, predictor, seed, *, engine=None, n_updates=3, gpu=2, gsz=4,
             max_staleness=2, train_s=1.0):
    """tests/test_service.py's harness in package (runtime ``R``, service
    ``S``): seed waves of groups, consume complete groups FIFO, publish a
    weight epoch per update, inject a replacement wave.  On the twin unless
    ``engine`` gives (cfg, params) for the port's engine backend.  Returns
    (staleness, stamps by batch position, buffer, service, result, trace
    with ids rewritten to batch positions)."""
    by_pid = {}
    for t in batch:
        by_pid.setdefault(t.prompt_id, []).append(t)
    groups = list(by_pid.values())
    order = {t.traj_id: i for i, t in enumerate(batch)}
    rcfg = R.RuntimeConfig(scheduler="pps", migration=True, max_active=2, quantum=8,
                           seed=seed, link_bandwidth=math.inf, trace=True, sanitize=True)
    if engine is None:
        lens = {tid: len(p) for tid, p in R.synth_prompts(batch, seed=seed).items()}
        svc = S.service_on_sim(predictor, 2, rcfg, prompt_lens=lens)
    else:
        rt = R.make_runtime(*engine, batch, predictor, n_workers=2, config=rcfg, device="cpu")
        svc = S.RolloutService(rt.backend, rt.controller, rcfg)
    svc.submit([t for g in groups[:gpu] for t in g])
    next_wave = gpu
    buf = S.ReplayBuffer(capacity=256, group_size=gsz)
    staleness, stamps = [], {}
    updates, free = 0, 0.0
    for traj in svc.stream():
        stamps[order[traj.traj_id]] = traj.weight_epoch
        buf.add(traj)
        while updates < n_updates and buf.ready_groups >= gpu:
            taken = buf.take(gpu, epoch=svc.epoch, max_staleness=max_staleness)
            if not taken:
                break
            free = max(svc.now, free) + train_s
            updates += 1
            staleness.extend(svc.epoch - t.weight_epoch for g in taken for t in g)
            if updates < n_updates:
                svc.sync_weights(at=free)
                wave = groups[next_wave:next_wave + len(taken)]
                next_wave += len(taken)
                if wave:
                    svc.submit([t for g in wave for t in g])
        if updates >= n_updates:
            break
    res = svc.close()
    for t in res.trajectories:
        stamps.setdefault(order[t.traj_id], t.weight_epoch)
    trace = [(k, order.get(tid, tid), wid) for k, tid, wid in res.trace]
    return staleness, stamps, buf, svc, res, trace


def _both(seed, n_prompts=6, gsz=4):
    """One workbench in both packages (the JAX predictor's fit in the port's)."""
    with same_ids():
        jb, jp = JR.build_workbench(n_prompts=n_prompts, group_size=gsz, seed=seed)
        tb, tp = TR.build_workbench(n_prompts=n_prompts, group_size=gsz, seed=seed)
    return (jb, jp), (tb, copy_predictor_state(jp, tp))


@pytest.mark.parametrize("seed,max_staleness", [(3, 2), (5, 2), (9, 2), (5, 0)])
def test_service_on_sim_matches_jax(seed, max_staleness):
    """The same workload and sync schedule on both packages' twins: every
    stamp, every consumed trajectory's staleness, the applied epochs, the
    decision trace and the makespan are equal; the bound holds, and bites
    (epochs advance; at max_staleness 0 groups are discarded)."""
    (jb, jp), (tb, tp) = _both(seed)
    want = _consume(JR, JS, jb, jp, seed, max_staleness=max_staleness)
    got = _consume(TR, TS, tb, tp, seed, max_staleness=max_staleness)
    staleness, stamps, buf, svc, res, trace = got
    assert staleness == want[0] and stamps == want[1]
    assert (buf.stale_discards, buf.evicted) == (want[2].stale_discards, want[2].evicted)
    assert svc.applied_epochs == want[3].applied_epochs and svc.epoch == want[3].epoch
    assert trace == want[5] and res.makespan == want[4].makespan
    assert res.sanitizer["violations"] == 0 and res.sanitizer["weight_syncs"] > 0
    assert staleness and max(staleness) <= max_staleness
    assert svc.epoch >= (2 if max_staleness else 1)        # epochs advance
    if max_staleness == 0:
        assert buf.stale_discards > 0


@pytest.fixture(scope="module")
def smollm():
    cfg = get_config("smollm_135m").reduced(n_periods=1)
    return cfg, M.init_params(cfg, seed=0, device="cpu")


def test_engine_service_stamps_equal_its_twin(smollm):
    """The port's engine backend under the streaming service stamps every
    trajectory with its twin's weight epoch and makes the same decisions."""
    (_, _), (tb, tp) = _both(SEED)
    sim = _consume(TR, TS, copy.deepcopy(tb), tp, SEED)
    eng = _consume(TR, TS, tb, tp, SEED, engine=smollm)
    assert eng[1] == sim[1] and eng[0] == sim[0]
    assert eng[3].applied_epochs == sim[3].applied_epochs
    assert eng[5] == sim[5] and eng[4].makespan == sim[4].makespan
    assert eng[4].sanitizer["violations"] == 0 and eng[4].sanitizer["weight_syncs"] > 0


def test_engine_service_stamps_survive_chaos(smollm):
    """A seeded worker death and revival with one in-flight sync: the
    engine's stamps, recoveries and trace equal its twin's."""
    (_, _), (master, pred) = _both(SEED, n_prompts=4)

    def run(engine):
        batch = copy.deepcopy(master)
        order = {t.traj_id: i for i, t in enumerate(batch)}
        rcfg = TR.RuntimeConfig(scheduler="pps", migration=True, max_active=2, quantum=8,
                                seed=SEED, link_bandwidth=math.inf, trace=True,
                                sanitize=True)
        faults = FaultPlan.chaos(seed=SEED, n_workers=2, horizon=2.0)
        if engine:
            rt = TR.make_runtime(*smollm, batch, pred, n_workers=2, config=rcfg,
                                 faults=faults, device="cpu")
            svc = RolloutService(rt.backend, rt.controller, rcfg, faults=faults)
        else:
            lens = {tid: len(p) for tid, p in TR.synth_prompts(batch, seed=SEED).items()}
            svc = TS.service_on_sim(pred, 2, rcfg, prompt_lens=lens, faults=faults)
        svc.submit(batch)
        stamps = {}
        for k, traj in enumerate(svc.stream()):
            stamps[order[traj.traj_id]] = traj.weight_epoch
            if k == 2:
                svc.sync_weights()
        res = svc.close()
        return stamps, res, [(k, order.get(tid, tid), wid) for k, tid, wid in res.trace]

    s_stamps, s_res, s_trace = run(False)
    e_stamps, e_res, e_trace = run(True)
    assert s_res.worker_deaths == e_res.worker_deaths == 1
    assert e_stamps == s_stamps and e_res.recoveries == s_res.recoveries
    assert e_trace == s_trace and e_res.makespan == s_res.makespan
    assert e_res.sanitizer["violations"] == s_res.sanitizer["violations"] == 0


# ------------------------------------------------------ sanitizer invariants

def _violations(events, trajs=()):
    san = TraceSanitizer(list(trajs), 2, 2)
    for kind, tid, wid in events:
        san.observe(kind, tid, wid)
    return san.report()


@pytest.mark.parametrize("events,violations", [
    ([("harvest", 7, 0)], 1),                                     # harvest before finish
    ([("start", 7, 0), ("finish", 7, 0), ("harvest", 7, 0), ("harvest", 7, 0)], 1),
    ([("start", 7, 0), ("weight_sync", 1, 0)], 1),                # a step in progress
    ([("admit", 7, 0), ("weight_sync", 1, 0)], 1),                # residents held
    ([("weight_sync", 2, 0), ("weight_sync", 1, 0)], 1),          # epoch goes back
    ([("weight_sync", 1, 1), ("weight_sync", 1, 1)], 1),          # epoch repeats
    ([("admit", 7, 0), ("start", 7, 0), ("step", 7, 0), ("finish", 7, 0),
      ("harvest", 7, 0), ("weight_sync", 1, 0), ("weight_sync", 2, 0)], 0),
])
def test_sanitizer_harvest_and_weight_sync_invariants(events, violations):
    rep = _violations(events)
    assert rep["violations"] == violations
    if violations == 0:
        assert rep["harvests"] == 1 and rep["weight_syncs"] == 2


def test_sanitizer_flags_midflight_stamp_change():
    t = _traj(0, 0, epoch=0)
    san = TraceSanitizer([t], 2, 2)
    san.observe("start", t.traj_id, 0)
    san.observe("step", t.traj_id, 0)
    t.weight_epoch = 3                         # illegal in-flight restamp
    san.observe("start", t.traj_id, 0)
    assert san.report()["violations"] >= 1


# ----------------------------------------------------------- async trainer

def test_train_async_staleness_bounded_partial_batches(smollm):
    from repro_torch.rl.loop import HeddleTrainer, TrainerConfig

    cfg, _ = smollm
    tr = HeddleTrainer(cfg, TrainerConfig(group_size=2, n_workers=2, seed=0,
                                          max_steps_per_traj=2), device="cpu")
    history = tr.train_async(n_updates=3, groups_per_update=2, max_staleness=2,
                             backlog_groups=4, seed=0)
    assert len(history) == 3
    for m in history:
        assert m["groups_consumed"] >= 1 and m["staleness"] <= 2
    assert any(m["staleness"] > 0 for m in history)
    assert [m["weight_epoch"] for m in history[:-1]] == [1.0, 2.0]


# ----------------------------------------------------------- the serve CLI

def test_serve_cli_stream_on_the_cpu():
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                          "--requests", "8", "--steps", "2", "--stream", "3"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
                              **ONE_THREAD_ENV})
    assert out.returncode == 0, out.stderr
    assert out.stdout.count(" harvest ") == 8
    assert "published weight epoch 1" in out.stdout and "streamed 8 harvests" in out.stdout
