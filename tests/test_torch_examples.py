"""The port's four examples (``examples/torch_*.py``) on the CPU.

The control-plane steps are host code on both sides, so the examples give
the JAX library's numbers exactly (``==``, as ``test_torch_control_plane.py``
holds ``simulate``) on the same inputs, with the JAX predictor's fitted
state copied in (the port fits in float64, the JAX package in f32).  The
engine steps run at reduced size with ``--device cpu``; without a device
argument the examples need the card and raise where there is none.
"""

import copy
import math

import numpy as np
import pytest
import torch

from repro.core.placement import InterferenceModel as JaxInterference
from repro.core.placement import presorted_dp as jax_presorted_dp
from repro.core.predictor import ProgressivePredictor as JaxPredictor
from repro.core.resource_manager import WorkerLatencyModel as JaxLatency
from repro.core.resource_manager import sort_initialized_sa as jax_sa
from repro.engine import simulator as JS
from repro.engine import workload as JW
from repro.engine.sampler import SamplerConfig as JaxSampler
from repro.engine.worker import RolloutWorker as JaxWorker
from repro_torch.core.predictor import ProgressivePredictor

from _torch_hold import load_example
from _torch_parity import copy_predictor_state, jax_and_port, same_ids
from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jax_fit(n_prompts):
    """The JAX predictor fitted on the examples' history (seed 1, groups of 8)."""
    return JaxPredictor().fit_trajectories(JW.replay_finished(JW.generate(
        JW.WorkloadConfig(task="coding", n_prompts=n_prompts, group_size=8, seed=1))))


def _sim(r):
    return dict(makespan=r.makespan, throughput=r.throughput, migrations=r.migrations,
                preemptions=r.preemptions)


def test_quickstart_matches_the_jax_control_plane():
    """Degrees, SA makespan and evaluations, DP group sizes, and the three
    systems' makespans, throughputs, migrations and preemptions, ``==``."""
    P, G = 6, 8
    with same_ids():
        jp = _jax_fit(P)
        batch = JW.generate(JW.WorkloadConfig(task="coding", n_prompts=P, group_size=G,
                                              seed=2))
        got = load_example("quickstart").main(
            ["--device", "cpu", "--prompts", str(P), "--group-size", str(G)],
            predictor=copy_predictor_state(jp, ProgressivePredictor()))
    lengths = np.array([t.true_total_tokens for t in batch])
    interference = JaxInterference.analytic(0.01)
    alloc = jax_sa(lengths, budget=64, interference=interference,
                   latency=JaxLatency(t1=0.02), seed=0)
    res = jax_presorted_dp(lengths, len(alloc.degrees), interference,
                           base_token_time=JaxLatency(t1=0.02).token_times(alloc.degrees))
    sims = {}
    for name, kw in [("heddle", dict(scheduler="pps", placement="heddle")),
                     ("verl", dict(scheduler="rr", placement="cache_aware",
                                   degrees=(1,) * 64)),
                     ("slime", dict(scheduler="rr", placement="least_load",
                                    degrees=(1,) * 64))]:
        sims[name] = _sim(JS.simulate(copy.deepcopy(batch), jp, gpu_budget=64,
                                      max_batch=100, seed=0, **kw))
    assert got["degrees"] == list(alloc.degrees)
    assert (got["sa_makespan"], got["sa_evaluations"]) == (alloc.makespan, alloc.evaluations)
    assert got["group_sizes"] == [len(g) for g in res.groups]
    assert got["sim"] == sims
    assert sims["heddle"]["migrations"] > 0
    # the engine step: 3 lanes x 8 steps, then 2 live lanes x 4, one layer
    assert got["engine"] == dict(device="cpu", tokens=32, lanes=3, decode_steps=12,
                                 n_layers=1)


def test_orchestration_at_scale_small_matches_the_jax_simulator():
    """Figure 12 at quarter scale: each system's makespan, throughput and
    active-trajectory timeline, ``==``."""
    with same_ids():
        jp = _jax_fit(64)
        batch = JW.generate(JW.WorkloadConfig(task="coding", n_prompts=32, group_size=16,
                                              seed=2))
        mod = load_example("orchestration_at_scale")
        got = mod.main(["--small"], predictor=copy_predictor_state(jp, ProgressivePredictor()))
    assert list(got) == list(mod.SYSTEMS)
    for name, kw in mod.SYSTEMS.items():
        r = JS.simulate(copy.deepcopy(batch), jp, gpu_budget=64, max_batch=100, seed=0, **kw)
        assert got[name] == dict(makespan=r.makespan, throughput=r.throughput,
                                 timeline=r.timeline), name
    assert got["heddle"]["makespan"] < got["slime"]["makespan"]


def _jax_serve_rollout(jcfg, jparams):
    """The steps of ``examples/serve_rollout.py`` on the JAX workers."""
    w0, w1 = (JaxWorker(jcfg, jparams, capacity=128, max_slots=8, worker_id=wid,
                        sampler=JaxSampler(temperature=0.8, top_p=0.9)) for wid in (0, 1))
    for rid in range(6):
        w0.prefill(rid, [5 + rid, 7, 9, 11 + rid])
    out = w0.decode(list(range(6)), 12)
    w0.extend(0, [201, 202, 203])
    w0.preempt(5)
    w1.migrate_in(w0.migrate_out(0))
    return dict(tokens=out, w1_tokens=w1.decode([0], 6)[0], resumed=w0.decode([5], 6)[5],
                context=len(w1.store[0].tokens))


def test_serve_rollout_matches_the_jax_demo():
    """On the JAX demo's weights (``PRNGKey(0)``), every token the example
    samples (w0's batch, request 0 on w1 after its migration, the resumed
    request 5) is the JAX workers' ``==``; request 0 moved w0 -> w1 with its
    context."""
    jcfg, _, jparams, params = jax_and_port("qwen3_1_7b", n_periods=2)
    want = _jax_serve_rollout(jcfg, jparams)
    got = load_example("serve_rollout").main(["--device", "cpu"], params=params)
    assert {k: got[k] for k in want} == want
    assert got["device"] == "cpu"
    assert got["decoded"] == 6 * 12
    assert got["migrated"]
    assert got["context"] == 4 + 12 + 3 + 6        # prompt, decode, tool output, w1's decode
    assert len(got["w1_tokens"]) == 6 and len(got["resumed"]) == 6
    assert (got["decode_steps"], got["n_layers"]) == (12 + 6 + 6, 2)


def test_train_agentic_grpo_one_iteration():
    got = load_example("train_agentic_grpo").main(["--device", "cpu", "--iters", "1",
                                                   "--group-size", "4", "--tasks-per-iter", "2"])
    assert got["device"] == "cpu"
    assert len(got["rewards"]) == len(got["losses"]) == 1
    assert math.isfinite(got["losses"][0]) and 0.0 <= got["rewards"][0] <= 1.0
    assert got["decode_steps"] > 0 and got["n_layers"] == 2


@pytest.mark.parametrize("name, argv", [
    ("quickstart", []), ("serve_rollout", []), ("train_agentic_grpo", ["--iters", "1"])])
def test_examples_default_to_the_card(name, argv, monkeypatch):
    """No ``--device`` means the card, and no card raises (before any work)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_example(name).main(argv)
