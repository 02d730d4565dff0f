"""The port's tracer (``engine/tracing.py``) and what the engine records on it.

Spans nest and ``leaves`` cut them into disjoint pieces that cover each
span's subtree exactly; off, the tracer reads no clock and records nothing
on any call into a worker; on, it changes no token, page or counter, and the
engine runtime's decision trace is still its analytic twin's.  The backend's
wait samples give one ``wait.step`` a step served, and the radix index's
prune counters match its drop in nodes.  CPU only.
"""

import copy
import math
import random

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.faults import FaultPlan
from repro_torch.engine import runtime as TR
from repro_torch.engine import tracing
from repro_torch.engine.fleet import FleetSpec, RolloutFleet
from repro_torch.engine.tracing import Tracer
from repro_torch.engine.worker import PrefixCacheIndex, RolloutWorker
from repro_torch.models.model import init_params

TIMING = {"decode_wall_s"}
WORKER_CALLS = ("worker.admit", "worker.absorb", "worker.decode", "worker.release",
                "worker.migrate_out", "worker.migrate_in", "worker.checkpoint")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tiny ops gain nothing from a pool beside other
    test workers.  Results do not depend on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    cfg = get_config("smollm_135m").reduced(n_periods=1)
    return cfg, init_params(cfg, seed=0, device="cpu")


class _Clock:
    """A clock that counts its reads and ticks one second a read."""

    def __init__(self):
        self.reads = 0

    def __call__(self):
        self.reads += 1
        return float(self.reads)


# ---------------------------------------------------------------- the tracer

def test_now_is_the_perf_counter():
    import time
    assert tracing.now is time.perf_counter


def _nest(tr, shape):
    """Open spans as ``shape`` says: (name, [children]) entries, in order."""
    for name, children in shape:
        with tr.span(name):
            _nest(tr, children)


SHAPES = {
    "flat": [("a", []), ("b", []), ("c", [])],
    "deep": [("a", [("b", [("c", [("d", [])])])])],
    "siblings": [("a", [("b", []), ("c", [("d", [])]), ("e", [])]), ("f", [])],
    "decode": [("worker.decode", [("decode.prep", []), ("decode.enqueue", []),
                                  ("decode.wait", []), ("decode.emit", []),
                                  ("radix.insert", [("radix.prune", [])]),
                                  ("radix.insert", [])])],
}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_spans_nest_and_leaves_cover_their_parents(shape, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(tracing, "now", clock)
    tr = Tracer(on=True)
    _nest(tr, SHAPES[shape])
    out = tr.export()
    spans = out["spans"]
    assert [s[1] for s in spans] == sorted(s[1] for s in spans)
    for name, t0, t1, depth in spans:
        # a span's parent is the latest-starting shallower span open over it
        parents = [p for p in spans if p[3] == depth - 1 and p[1] < t0 and t1 < p[2]]
        assert bool(parents) == (depth > 0)
        inside = [piece for piece in out["leaves"] if t0 <= piece[1] and piece[2] <= t1]
        assert sum(b - a for _, a, b in inside) == t1 - t0      # covered exactly
    pieces = out["leaves"]
    assert all(a < b for _, a, b in pieces)
    assert all(p[2] <= q[1] for p, q in zip(pieces, pieces[1:]))   # disjoint, in order
    assert sum(t["count"] for t in out["totals"].values()) == len(spans)
    assert clock.reads == 2 * len(spans)


def _brute_leaves(spans):
    """Each unit interval named by the deepest span covering it, merged."""
    out = []
    lo = min(s[1] for s in spans)
    hi = max(s[2] for s in spans)
    for t in range(int(lo), int(hi)):
        cover = [s for s in spans if s[1] <= t and t + 1 <= s[2]]
        if not cover:
            continue
        name = max(cover, key=lambda s: s[3])[0]
        if out and out[-1][0] == name and out[-1][2] == t:
            out[-1] = (name, out[-1][1], t + 1)
        else:
            out.append((name, t, t + 1))
    return out


def _merged(pieces):
    out = []
    for name, a, b in pieces:
        if out and out[-1][0] == name and out[-1][2] == a:
            out[-1] = (name, out[-1][1], b)
        else:
            out.append((name, a, b))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_leaves_match_a_brute_force_cut(seed, monkeypatch):
    """Random nestings, unit ticks: ``leaves`` names each tick by its
    innermost span, as a tick-by-tick search does."""
    rng = random.Random(seed)

    def tree(depth):
        return [(f"s{rng.randrange(5)}", tree(depth + 1) if depth < 4 and rng.random() < 0.5
                 else []) for _ in range(rng.randrange(1, 4))]

    monkeypatch.setattr(tracing, "now", _Clock())
    tr = Tracer(on=True)
    _nest(tr, tree(0))
    out = tr.export()
    assert _merged(out["leaves"]) == _brute_leaves(out["spans"])


def test_counters_gauges_samples_and_clear():
    tr = Tracer(on=True)
    tr.add("n")
    tr.add("n", 4)
    for v in (3, 9, 2):
        tr.gauge("g", v)
    tr.sample("s", 0.5)
    tr.sample("s", 1.5)
    out = tr.export()
    assert out["counters"] == {"n": 5, "g": 9}
    assert out["samples"] == {"s": [0.5, 1.5]}
    assert out["device"] == {}                  # no device span on the CPU
    with tr.device_span("absorb", "cpu"):
        pass
    assert tr.export()["device"] == {}
    tr.clear()
    assert tr.export() == {"spans": [], "totals": {}, "counters": {}, "samples": {},
                           "device": {}, "leaves": []}


def test_export_since_keeps_later_spans():
    tr = Tracer(on=True)
    with tr.span("before"):
        pass
    cut = tracing.now()
    with tr.span("after"):
        pass
    assert [s[0] for s in tr.export(cut)["spans"]] == ["after"]
    assert list(tr.export(cut)["totals"]) == ["after"]


def test_off_is_one_null_context_and_records_nothing(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(tracing, "now", clock)
    tr = Tracer()
    assert tr.span("a") is tr.span("b") is tr.device_span("c", "cpu")
    with tr.span("a"):
        tr.add("n")
        tr.gauge("g", 1)
        tr.sample("s", 1.0)
    assert clock.reads == 0
    assert tr.export() == Tracer(on=True).export()


# ---------------------------------------------------------------- the worker

PLANES = {"paged": dict(),
          "dense": dict(paged=False),
          "ring": dict(paged=False, capacity=16, window=16)}   # per-token absorption


def _scenario(cfg, params, tracer=None, **plane):
    """Admission with a shared prompt, decodes with and without a stop token,
    absorption, preemption, migration, a checkpoint and release, on two
    workers sharing ``tracer``."""
    window = plane.pop("window", 0)
    if window:
        cfg = cfg.with_sliding_window(window)
    kw = dict(capacity=64, max_slots=4, page_size=8, chunk_size=8, device="cpu")
    kw.update(plane)
    w0, w1 = (RolloutWorker(cfg, params, worker_id=i, tracer=tracer, **kw) for i in (0, 1))
    prompt = [3 + i for i in range(10)]
    out = []
    w0.prefill(1, prompt)
    w0.prefill(2, prompt)
    out.append(w0.decode([1, 2], 3))
    w0.extend(1, [101, 102, 103])
    w0.preempt(2)
    out.append(w0.decode([1], 2, stop_token=7))
    out.append(w0.decode([2], 2))
    w1.migrate_in(w0.migrate_out(2))
    out.append(w1.decode([2], 2))
    w1.migrate_in(w0.checkpoint_out(1))
    out.append((w1.decode([1], 2), w0.decode([1], 2)))
    w0.release(1)
    w1.release(2)
    stats = [{k: v for k, v in w.dispatch_stats().items() if k not in TIMING}
             for w in (w0, w1)]
    pages = [dict(w.lane_pages) for w in (w0, w1)]
    return out, stats, pages, (w0, w1)


@pytest.mark.parametrize("plane", list(PLANES))
def test_off_a_worker_reads_no_clock_and_records_nothing(plane, model, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(tracing, "now", clock)
    *_, workers = _scenario(*model, **PLANES[plane])
    assert clock.reads == 0
    for w in workers:
        assert not w.tracer.on and w.tracer.export() == Tracer(on=True).export()


@pytest.mark.parametrize("plane", list(PLANES))
def test_on_a_worker_changes_no_token_page_or_counter(plane, model):
    off = _scenario(*model, **PLANES[plane])
    tr = Tracer(on=True)
    on = _scenario(*model, tracer=tr, **PLANES[plane])
    assert on[:3] == off[:3]
    out = tr.export()
    names = set(out["totals"])
    assert set(WORKER_CALLS) <= names
    assert {"decode.prep", "decode.enqueue", "decode.wait", "decode.emit",
            "radix.insert", "radix.match", "admit.forward", "absorb.forward"} <= names
    assert out["totals"]["worker.decode"]["count"] == 6
    assert out["device"] == {}
    for name, t0, t1, depth in out["spans"]:
        outer = name in WORKER_CALLS
        assert (depth == 0) == outer, name     # every other span lies in a worker call
    assert out["counters"]["radix.nodes"] > 0


# ---------------------------------------------------------------- the radix index

@pytest.mark.parametrize("max_nodes", [8, 20, 64])
def test_prune_counters_match_the_drop_in_nodes(max_nodes):
    tr = Tracer(on=True)
    idx = PrefixCacheIndex(max_nodes=max_nodes, tracer=tr)
    drops = []
    prune = idx._prune

    def counted():
        before = idx.node_count
        prune()
        drops.append(before - idx.node_count)

    idx._prune = counted
    rng = np.random.default_rng(max_nodes)
    walked = peak = 0
    for i in range(40):
        toks = [int(t) for t in rng.integers(0, 6, size=int(rng.integers(1, 12)))]
        idx.insert(toks, slot=i % 3)
        peak = max(peak, idx.node_count)
        idx.match_lane(toks[:3])
        walked += len(toks) + len(toks[:3])
    c = tr.export()["counters"]
    assert len(drops) > 0 and sum(drops) > 0
    assert c["radix.prunes"] == len(drops)
    assert c["radix.pruned_nodes"] == sum(drops)
    assert c["radix.nodes"] == peak <= max_nodes
    assert c["radix.tokens_walked"] == walked
    totals = tr.export()["totals"]
    assert totals["radix.prune"]["count"] == len(drops)
    assert totals["radix.insert"]["count"] == totals["radix.match"]["count"] == 40


# ---------------------------------------------------------------- ownership

def test_the_fleet_owns_one_tracer_for_every_worker(model):
    cfg, params = model
    fleet = RolloutFleet(cfg, params, FleetSpec((1, 1)), capacity=64, max_slots=2,
                         device="cpu", page_size=8, chunk_size=8)
    tr = fleet.tracer
    assert not tr.on
    assert all(w.tracer is tr and w.prefix_index.tracer is tr for w in fleet.workers)
    fleet.workers[0].reset_cache()
    assert fleet.workers[0].prefix_index.tracer is tr
    fleet.reconfigure(FleetSpec((2,)))             # a rebuilt worker
    assert fleet.workers[0].tracer is tr and fleet.workers[0].prefix_index.tracer is tr
    alone = RolloutWorker(cfg, params, capacity=64, max_slots=2, device="cpu")
    assert alone.tracer is not tr and not alone.tracer.on


# ---------------------------------------------------------------- the runtime

def _rcfg():
    return TR.RuntimeConfig(scheduler="pps", migration=True, max_active=2, quantum=8,
                            link_bandwidth=math.inf, trace=True, seed=5, sanitize=True)


@pytest.fixture(scope="module")
def traced_run(model):
    """The engine runtime over two workers, 2 decode slots each for 24
    trajectories, with the fleet's tracer on; and its analytic twin."""
    cfg, params = model
    batch, pred = TR.build_workbench(n_prompts=6, group_size=4, seed=5)
    twin = copy.deepcopy(batch)
    rt = TR.make_runtime(cfg, params, batch, pred, n_workers=2, config=_rcfg(),
                         device="cpu")
    rt.fleet.tracer.on = True
    res = rt.run()
    sim = TR.run_on_sim(twin, pred, n_workers=2, config=_rcfg())
    return rt, res, sim, batch


def test_the_decision_trace_equals_the_sims_with_the_tracer_on(traced_run):
    rt, res, sim, _ = traced_run
    assert rt.backend.tracer is rt.fleet.tracer
    assert res.preemptions > 0 and res.migrations > 0        # the test must bite
    assert res.trace == sim.trace and res.makespan == sim.makespan


def test_each_step_served_gives_one_wait_sample(traced_run):
    rt, res, _, batch = traced_run
    samples = rt.fleet.tracer.export()["samples"]
    steps = sum(t.num_steps for t in batch)
    assert all(t.finished for t in batch)
    assert len(samples["wait.step"]) == steps
    assert 0 < len(samples.get("wait.preempted", [])) <= res.preemptions
    assert min(samples["wait.step"] + samples["wait.preempted"]) >= 0
    assert not rt.backend._waiting                 # every stamp was read or dropped


def _step_starts(rt):
    """Count, on each worker's decode calls, the lanes that start (or restart)
    a step there: the backend has no token of their step yet."""
    starts = []

    def counting(decode):
        def call(ids, *args, **kwargs):
            starts.append(sum(not rt.backend._step_gen.get(tid) for tid in ids))
            return decode(ids, *args, **kwargs)
        return call

    for w in rt.fleet.workers:
        w.decode = counting(w.decode)
    return starts


def test_a_step_restarted_after_a_worker_died_gives_one_wait_sample_more(traced_run, model):
    """Worker 0 dies mid-run: each lane it held restarts its step elsewhere,
    admitted again or restored from its checkpoint, and waits for a slot
    once more."""
    cfg, params = model
    horizon = traced_run[1].makespan
    batch, pred = TR.build_workbench(n_prompts=6, group_size=4, seed=5)
    faults = FaultPlan(seed=5, deaths=((0.3 * horizon, 0),), revivals=((0.5 * horizon, 0),))
    rt = TR.make_runtime(cfg, params, batch, pred, n_workers=2, config=_rcfg(),
                         device="cpu", faults=faults)
    starts = _step_starts(rt)
    rt.tracer.on = True
    res = rt.run()
    assert res.worker_deaths == 1 and res.recoveries > 0
    assert all(t.finished for t in batch)
    samples = rt.tracer.export()["samples"]
    steps = sum(t.num_steps for t in batch)
    assert len(samples["wait.step"]) == sum(starts) > steps      # restarted steps wait again
    assert min(samples["wait.step"]) >= 0
    assert not rt.backend._waiting


def test_a_runtime_over_a_list_of_workers_needs_one_tracer(model):
    """Workers built apart hold tracers of their own, which a runtime over
    them refuses; built with one, it reads every worker's calls."""
    cfg, params = model
    batch, pred = TR.build_workbench(n_prompts=2, group_size=2, seed=5)
    rt = TR.make_runtime(cfg, params, batch, pred, n_workers=2, config=_rcfg(), device="cpu")
    kw = dict(capacity=rt.fleet.workers[0].capacity, max_slots=len(batch), device="cpu")
    apart = [RolloutWorker(cfg, params, worker_id=i, **kw) for i in (0, 1)]
    with pytest.raises(ValueError, match="different tracers"):
        TR.RolloutRuntime(apart, rt.controller, batch, rt.env, _rcfg())
    tr = Tracer()
    shared = [RolloutWorker(cfg, params, worker_id=i, tracer=tr, **kw) for i in (0, 1)]
    run = TR.RolloutRuntime(shared, rt.controller, batch, rt.env, _rcfg())
    run.tracer.on = True
    run.run()
    calls = [w.dispatch_stats()["decode_calls"] for w in shared]
    assert min(calls) > 0
    assert tr.export()["totals"]["worker.decode"]["count"] == sum(calls)


def test_the_trainers_workers_share_one_tracer(model):
    from repro_torch.rl.loop import HeddleTrainer, TrainerConfig
    cfg, _ = model
    trainer = HeddleTrainer(cfg, TrainerConfig(group_size=2, n_workers=2, seed=0),
                            device="cpu")
    assert all(w.tracer is trainer.tracer for w in trainer.workers)
    assert not trainer.tracer.on


def test_worker_calls_lie_inside_the_run(traced_run):
    rt, *_ = traced_run
    out = rt.fleet.tracer.export()
    tot = out["totals"]
    assert tot["runtime.run"]["count"] == 1
    run = next(s for s in out["spans"] if s[0] == "runtime.run")
    calls = [s for s in out["spans"] if s[0] in WORKER_CALLS]
    assert calls and all(run[1] <= s[1] and s[2] <= run[2] and s[3] == 1 for s in calls)
    inside = sum(tot[n]["seconds"] for n in WORKER_CALLS if n in tot)
    assert 0 < inside <= tot["runtime.run"]["seconds"]
    assert tot["worker.decode"]["count"] == sum(
        w.dispatch_stats()["decode_calls"] for w in rt.fleet.workers)
