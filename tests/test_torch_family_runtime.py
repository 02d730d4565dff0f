"""The rollout runtime on one MoE and one recurrent family, against the JAX
package's engine and the port's own sim.

The configs and workload of tests/test_runtime_configs.py:
``qwen2_moe_a2_7b.reduced(n_periods=2)`` with the no-drop capacity and
``xlstm_350m.reduced(n_periods=1)``, float32, the JAX ``init_params``
carried across by ``from_jax``; ``build_workbench(n_prompts=2,
group_size=2, seed=11, max_total_tokens=24, max_steps=3)``; pps, migration,
2 active lanes a worker, quantum 8, an infinite link.  qwen2-moe admits
whole prompts and absorbs tool output one decode step a token; xLSTM admits
by chunked recurrent prefill into a pool of pure per-lane state.  The
decision trace does not depend on the sampled tokens, so the port's trace,
makespan and counts equal the JAX engine's (``==``) fault-free and under
``FaultPlan.chaos`` (a worker death forces checkpoint_out / migrate_in of
the family's lanes onto the survivor), and the fault-free trace equals the
port's sim.  Then the serve CLI on both configs, on the CPU.
"""

import copy
import math
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.core.faults import FaultPlan as JaxFaultPlan
from repro.engine import runtime as JR
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.core.faults import FaultPlan
from repro_torch.engine import runtime as TR
from repro_torch.params import from_jax

from _torch_parity import ONE_THREAD_ENV, one_torch_thread, rcfg, workbench  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TIMING = {"decode_wall_s", "decode_timed_steps", "decode_timed_lane_steps"}
WORKLOAD = dict(n_prompts=2, group_size=2, seed=11, max_total_tokens=24, max_steps=3)
CONFIG = dict(link_bandwidth=math.inf, seed=11)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", params=["qwen2_moe_a2_7b", "xlstm_350m"])
def models(request):
    name = request.param
    jfull, full = jax_config(name), get_config(name)
    periods = 2 if len(full.block_pattern) == 1 else 1
    jcfg, cfg = jfull.reduced(n_periods=periods), full.reduced(n_periods=periods)
    if cfg.n_experts:             # no-drop capacity, as tests/test_runtime_configs.py
        cf = float(cfg.n_experts) / cfg.top_k + 1
        jcfg, cfg = replace(jcfg, capacity_factor=cf), replace(cfg, capacity_factor=cf)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _result(r):
    stats = {w: {k: v for k, v in s.items() if k not in TIMING}
             for w, s in r.worker_stats.items()}
    return (r.trace, r.makespan, r.preemptions, r.migrations, r.total_tokens,
            r.worker_deaths, r.recoveries, r.tool_retries, r.injected_tool_faults, stats)


def test_runtime_matches_jax_engine_and_port_sim(models):
    jcfg, jparams, cfg, params = models
    (jb, jp), (tb, tp) = workbench(**WORKLOAD)
    twin = copy.deepcopy(tb)
    want = JR.make_runtime(jcfg, jparams, jb, jp, n_workers=2, config=rcfg(JR, **CONFIG)).run()
    got = TR.make_runtime(cfg, params, tb, tp, n_workers=2, config=rcfg(TR, **CONFIG),
                          device="cpu").run()
    sim = TR.run_on_sim(twin, tp, n_workers=2, config=rcfg(TR, **CONFIG))
    assert len(got.trace) > 0 and all(t.finished for t in tb)
    assert got.worker_deaths == 0 and got.sanitizer["violations"] == 0
    assert got.total_tokens == sum(t.tokens_generated for t in got.trajectories)
    assert _result(got) == _result(want)
    assert got.trace == sim.trace and got.makespan == sim.makespan
    assert (got.preemptions, got.migrations) == (sim.preemptions, sim.migrations)


def test_chaos_runtime_matches_jax_engine(models):
    jcfg, jparams, cfg, params = models
    (jb, jp), (tb, tp) = workbench(**WORKLOAD)
    base = TR.run_on_sim(copy.deepcopy(tb), tp, n_workers=2, config=rcfg(TR, **CONFIG))
    faults = FaultPlan.chaos(seed=11, n_workers=2, horizon=base.makespan)
    want = JR.make_runtime(jcfg, jparams, jb, jp, n_workers=2, config=rcfg(JR, **CONFIG),
                           faults=JaxFaultPlan(**vars(faults))).run()
    got = TR.make_runtime(cfg, params, tb, tp, n_workers=2, config=rcfg(TR, **CONFIG),
                          faults=faults, device="cpu").run()
    assert all(t.finished for t in tb)
    assert got.worker_deaths == 1 and got.recoveries > 0
    for t in got.trajectories:
        assert t.tokens_generated == sum(s.gen_tokens for s in t.steps)
    assert _result(got) == _result(want)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "xlstm-350m"])
def test_serve_cli_runs_the_family(arch):
    """The serve CLI reduces ``--arch`` to two periods, as the JAX CLI does,
    and prints the JAX CLI's summary fields."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **ONE_THREAD_ENV)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
                          "--device", "cpu", "--requests", "8", "--steps", "2"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 8 trajectories on cpu" in out.stdout
    for field in ("decode steps", "prefix reuse", "virtual makespan", "queue delay mean",
                  "preemptions", "tool-interval migrations", "measured prefix reuse rate"):
        assert field in out.stdout, field
