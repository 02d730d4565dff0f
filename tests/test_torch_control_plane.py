"""The port's control plane against the JAX package's, with no model.

Workload generation, the predictor, the simulator and ``run_on_sim`` (the
orchestrator driving the engine-parity ``SimBackend``) are host code on both
sides, so the port must reproduce the JAX decision trace exactly (``==``, no
tolerance) under every policy, under chaos and under open-loop admission.

The predictor's fit differs by design; the parity runs hold the JAX fit
(``_torch_parity.workbench``).
"""

import copy

import numpy as np
import pytest

from repro.core.faults import FaultPlan as JaxFaultPlan
from repro.core.tenancy import ServingConfig as JaxServing
from repro.core.tenancy import TenantClass as JaxTenant
from repro.core.tenancy import assign_tenants as jax_assign_tenants
from repro.engine import runtime as JR
from repro.engine import simulator as JS
from repro.engine import workload as JW
from repro_torch.analysis.protocol import check_backend
from repro_torch.core.faults import FaultPlan
from repro_torch.core.predictor import ModelPredictor, ProgressivePredictor, harvest
from repro_torch.core.tenancy import ServingConfig, TenantClass, assign_tenants
from repro_torch.engine import runtime as TR
from repro_torch.engine import simulator as TS
from repro_torch.engine import workload as TW
from repro_torch.engine.backends import EngineBackend, SimBackend

from _torch_parity import SEED, rcfg, same_ids, workbench


def _traj_fields(t):
    p = t.payload
    return (t.traj_id, t.prompt_id, t.sample_id, t.prompt_tokens, t.context_tokens,
            t.true_total_tokens, t.true_num_steps, t.submit_time, t.tenant,
            t.slo_deadline, list(p.gen_tokens), [float(x) for x in p.tool_latency],
            [bool(x) for x in p.tool_failed], list(p.tool_output_tokens))


def _result_fields(r):
    return (r.trace, r.makespan, r.preemptions, r.migrations,
            r.queue_delay_mean, r.queue_delay_p99, r.worker_deaths, r.recoveries,
            r.tool_retries, r.injected_tool_faults, r.arrivals, r.admitted, r.shed,
            r.deferred, r.degraded, r.peak_live_global, r.peak_live_worker)


# ------------------------------------------------------------ workload + predictor

@pytest.mark.parametrize("task", ["coding", "search", "math"])
def test_workload_generation_identical(task):
    cfg = dict(task=task, n_prompts=5, group_size=3, seed=11)
    with same_ids(1_000):
        want = JW.generate(JW.WorkloadConfig(**cfg))
        got = TW.generate(TW.WorkloadConfig(**cfg))
    assert [_traj_fields(t) for t in got] == [_traj_fields(t) for t in want]


def test_workbench_identical_and_arrivals():
    (jb, _), (tb, _) = workbench()
    assert [_traj_fields(t) for t in tb] == [_traj_fields(t) for t in jb]
    assert len(tb) == 24 and TR.required_capacity(tb) == JR.required_capacity(jb)
    for kind in ("poisson", "bursty", "diurnal"):
        JW.assign_arrivals(jb, JW.make_arrivals(kind, rate=30.0, seed=SEED))
        TW.assign_arrivals(tb, TW.make_arrivals(kind, rate=30.0, seed=SEED))
        assert [t.submit_time for t in tb] == [t.submit_time for t in jb], kind
    assert TR.synth_prompts(tb, seed=SEED) == JR.synth_prompts(jb, seed=SEED)


def test_predictor_fit_is_float64_ridge_solve():
    (_, _), (tb, _) = workbench()
    feats, remaining = harvest(tb)
    pred = ProgressivePredictor().fit(feats, remaining)
    x = feats / np.maximum(np.abs(feats).max(axis=0), 1.0)
    y = np.log1p(np.maximum(remaining, 0.0))
    want = np.linalg.solve(x.T @ x + pred.reg * np.eye(x.shape[1]), x.T @ y)
    assert pred.weights.dtype == np.float64
    np.testing.assert_array_equal(pred.weights, want)
    assert pred._resid_var == float(np.var(y - x @ want))
    base = ModelPredictor().fit_trajectories(tb)
    f0, r0 = harvest(tb, first_step_only=True)
    f0 = f0[:, [0, 1]]                       # bias + prompt tokens
    x0 = f0 / np.maximum(np.abs(f0).max(axis=0), 1.0)
    np.testing.assert_array_equal(
        base.weights, np.linalg.solve(x0.T @ x0 + base.reg * np.eye(2), x0.T @ r0))


def test_predictor_copied_state_predicts_identically():
    (jb, jp), (tb, tp) = workbench()
    assert tp.weights is not jp.weights
    for jt, tt in zip(jb, tb):
        assert tp.predict(tt) == jp.predict(jt)
    # the features of every replayed step boundary agree too
    np.testing.assert_array_equal(harvest(tb)[0], harvest(jb)[0])


# ------------------------------------------------------------ run_on_sim parity

@pytest.mark.parametrize("scheduler", ["pps", "fcfs"])
@pytest.mark.parametrize("migration", [True, False], ids=["migration", "no_migration"])
def test_run_on_sim_matches_jax(scheduler, migration):
    (jb, jp), (tb, tp) = workbench()
    kw = dict(scheduler=scheduler, migration=migration)
    want = JR.run_on_sim(jb, jp, n_workers=2, config=rcfg(JR, **kw))
    got = TR.run_on_sim(tb, tp, n_workers=2, config=rcfg(TR, **kw))
    assert len(got.trace) > 0 and got.sanitizer["violations"] == 0
    if migration:
        assert got.migrations > 0
    assert _result_fields(got) == _result_fields(want)
    assert [t.finish_time for t in tb] == [t.finish_time for t in jb]


def test_run_on_sim_matches_jax_finite_link_and_dense_pricing():
    """At the default 2e9 link the sim prices migrations from analytic KV
    bytes, on the page grid (paged) or at full lanes (``paged=False``)."""
    for paged in (None, False):
        (jb, jp), (tb, tp) = workbench()
        kw = dict(link_bandwidth=2e9, paged=paged)
        want = JR.run_on_sim(jb, jp, n_workers=2, config=rcfg(JR, **kw))
        got = TR.run_on_sim(tb, tp, n_workers=2, config=rcfg(TR, **kw))
        assert got.migrations > 0
        assert _result_fields(got) == _result_fields(want)


def test_run_on_sim_matches_jax_under_chaos():
    (jb, jp), (tb, tp) = workbench()
    base = TR.run_on_sim(copy.deepcopy(tb), tp, n_workers=2, config=rcfg(TR))
    jplan = JaxFaultPlan.chaos(seed=SEED, n_workers=2, horizon=base.makespan)
    plan = FaultPlan.chaos(seed=SEED, n_workers=2, horizon=base.makespan)
    assert plan == FaultPlan(**vars(jplan)) and plan.deaths
    want = JR.run_on_sim(jb, jp, n_workers=2, config=rcfg(JR), faults=jplan)
    got = TR.run_on_sim(tb, tp, n_workers=2, config=rcfg(TR), faults=plan)
    assert got.worker_deaths == 1 and got.recoveries > 0 and got.injected_tool_faults > 0
    assert all(t.finished for t in tb)
    assert _result_fields(got) == _result_fields(want)


def test_run_on_sim_matches_jax_open_loop_with_tenants():
    """Open-loop ingress, two tenant classes and admission control under
    overload: arrivals, admissions, deferrals and sheds all match."""
    (jb, jp), (tb, tp) = workbench(n_prompts=8)
    tenants = dict(gold=dict(tier=0, deadline_s=30.0, weight=2.0, sheddable=False, share=0.3),
                   best=dict(tier=1, deadline_s=1.0, weight=0.5, sheddable=True, share=0.7))
    serving = dict(admission_control=True, queue_bound_per_worker=3, queue_bound_global=5,
                   shed_pressure=1.2, degrade_pressure=1.6, defer_seconds=0.5)
    JW.assign_arrivals(jb, JW.make_arrivals("bursty", rate=60.0, seed=SEED))
    TW.assign_arrivals(tb, TW.make_arrivals("bursty", rate=60.0, seed=SEED))
    jax_assign_tenants(jb, tuple(JaxTenant(n, **c) for n, c in tenants.items()), seed=SEED)
    assign_tenants(tb, tuple(TenantClass(n, **c) for n, c in tenants.items()), seed=SEED)
    want = JR.run_on_sim(jb, jp, n_workers=2, config=rcfg(JR, open_loop=True),
                         serving=JaxServing(**serving))
    got = TR.run_on_sim(tb, tp, n_workers=2, config=rcfg(TR, open_loop=True),
                        serving=ServingConfig(**serving))
    assert got.shed > 0 and got.admitted > 0
    assert {"arrival", "admit", "shed"} <= {k for k, _, _ in got.trace}
    assert _result_fields(got) == _result_fields(want)
    assert got.tenant_report == want.tenant_report
    assert [(t.shed, t.shed_reason, t.degraded) for t in tb] == \
        [(t.shed, t.shed_reason, t.degraded) for t in jb]


@pytest.mark.parametrize("placement", ["heddle", "least_load"])
def test_simulate_matches_jax(placement):
    """``engine.simulator.simulate``: adaptive MP provisioning (Algorithm 2),
    placement and the processor-sharing cost model, at a small budget."""
    (jb, jp), (tb, tp) = workbench()
    kw = dict(placement=placement, gpu_budget=4, max_batch=8, seed=SEED)
    want = JS.simulate(jb, jp, **kw)
    got = TS.simulate(tb, tp, **kw)
    fields = ("makespan", "total_tokens", "throughput", "queue_delay_p100",
              "queue_delay_mean", "migrations", "preemptions", "cache_miss_prefill_tokens",
              "timeline")
    assert got.total_tokens > 0
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]


# ------------------------------------------------------------ backend contract

@pytest.mark.parametrize("cls", [SimBackend, EngineBackend], ids=lambda c: c.__name__)
def test_backends_conform_to_protocol(cls):
    assert check_backend(cls) == []


def test_core_exports_orchestrator_api():
    import repro_torch.core as core

    for name in ("Orchestrator", "OrchestratorConfig", "OrchestratorResult",
                 "ExecutionBackend", "StepOutcome", "HeddleController",
                 "ProgressivePredictor", "FaultPlan"):
        assert hasattr(core, name), name
        assert name in core.__all__
