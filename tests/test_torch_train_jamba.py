"""The port's trainer on jamba (Mamba + attention + MoE) against the JAX
package's, and the train CLI on jamba.

The JAX trainer differentiates its chunked scan; the port's update runs the
scan's autograd Function (its plain backward on the CPU).  Config
``jamba_v0_1_52b.reduced()`` (one period, f32), weights the JAX trainer's
carried across with ``from_jax``.  Tolerances as ``tests/test_torch_train.py``'s
whole-update ones: metrics 1e-5; parameters within 2 x lr, and 99.9% of
elements within 1e-5.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from _torch_parity import ONE_THREAD_ENV, hold_params, spread_records, to_np, tree_paths
from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import get_config as jax_config
from repro.rl import loop as JL
from repro_torch.configs import get_config
from repro_torch.params import from_jax
from repro_torch.rl import data as D
from repro_torch.rl import loop as TLoop

pytestmark = pytest.mark.usefixtures("one_torch_thread")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCFG = dict(group_size=2, n_workers=2, seed=0, max_steps_per_traj=2)
NAME = "jamba_v0_1_52b"


@pytest.fixture(scope="module")
def trainers():
    """Both trainers through one rollout, an update on its records and an
    update on records with a reward spread."""
    jcfg, cfg = jax_config(NAME).reduced(), get_config(NAME).reduced()
    jtr = JL.HeddleTrainer(jcfg, JL.TrainerConfig(**TCFG))
    ttr = TLoop.HeddleTrainer(cfg, TLoop.TrainerConfig(**TCFG),
                              params=from_jax(jax.tree.map(np.asarray, jtr.params),
                                              device="cpu"), device="cpu")
    out = {}
    for tag, tr, rec_cls in (("jax", jtr, JL.RolloutRecord),
                             ("port", ttr, TLoop.RolloutRecord)):
        tasks = D.sample_tasks(2, seed=0)
        records = tr.rollout(tasks)
        m1 = tr.update(records)
        p1 = {k: to_np(v) for k, v in tree_paths(tr.params).items()}
        m2 = tr.update(spread_records(tasks[0], rec_cls, D))
        p2 = {k: to_np(v) for k, v in tree_paths(tr.params).items()}
        out[tag] = dict(records=records, m1=m1, p1=p1, m2=m2, p2=p2)
    return out


def test_jamba_rollout_records_equal_jax(trainers):
    j, t = trainers["jax"]["records"], trainers["port"]["records"]
    assert len(t) == len(j) == 4
    for a, b in zip(t, j):
        assert (a.tokens, a.prompt_len, a.reward, a.steps) == \
            (b.tokens, b.prompt_len, b.reward, b.steps)


@pytest.mark.parametrize("which", ["m1", "m2"])
def test_jamba_update_metrics_and_params_match_jax(trainers, which):
    """Each update's metrics, and every parameter after it (the Mamba
    leaves among them, moved through the scan's backward)."""
    j, t = trainers["jax"], trainers["port"]
    lr = TLoop.TrainerConfig().lr
    assert t[which].keys() == j[which].keys()
    for k, v in j[which].items():
        assert abs(t[which][k] - v) <= 1e-5, k
    got, want = t["p" + which[1]], j["p" + which[1]]
    assert got.keys() == want.keys()
    hold_params(got, want, lr)
    if which == "m2":
        assert abs(t["m2"]["pg_loss"]) > 1e-8
        moved = {k for k in got if np.abs(t["p2"][k] - t["p1"][k]).max() > 0}
        assert {k for k in got if "/m_" in k} <= moved        # every Mamba leaf moved


def test_train_cli_trains_jamba_on_the_cpu_when_asked():
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                          "jamba-v0.1-52b", "--device", "cpu", "--iters", "1",
                          "--group-size", "2", "--tasks-per-iter", "2"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
                              **ONE_THREAD_ENV})
    assert out.returncode == 0, out.stderr
    assert "training jamba-v0.1-52b" in out.stdout and "on cpu" in out.stdout
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("iter    1"))
    assert "nan" not in line
