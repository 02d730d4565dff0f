"""Quickstart on the PyTorch port: Heddle's three orchestration decisions in one minute.

Generates an agentic workload with the paper's long-tail statistics, trains the
progressive predictor on historical rollouts, then shows the control plane deciding
  HOW   — Algorithm 2 simulated annealing picks heterogeneous MP degrees (64 chips),
  WHERE — the presorted DP partitions trajectories across workers,
  WHEN  — progressive-priority scheduling orders (and preempts) execution,
compares end-to-end rollout throughput against the Verl/Slime baselines in the
cluster simulator, and closes with the real data plane: a few requests served by the
slot-pool continuous-batching engine on an actual (reduced) model, on the card
through the paged decode kernel.

Run:  PYTHONPATH=src python examples/torch_quickstart.py              # on the card
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import copy

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.placement import InterferenceModel, presorted_dp
from repro_torch.core.predictor import ProgressivePredictor
from repro_torch.core.resource_manager import WorkerLatencyModel, sort_initialized_sa
from repro_torch.device import resolve_device
from repro_torch.engine.sampler import SamplerConfig
from repro_torch.engine.simulator import simulate
from repro_torch.engine.worker import RolloutWorker
from repro_torch.engine.workload import WorkloadConfig, generate, replay_finished
from repro_torch.models import model as M

SYSTEMS = [
    ("heddle", dict(scheduler="pps", placement="heddle")),
    ("verl  (cache-aware, RR)", dict(scheduler="rr", placement="cache_aware",
                                     degrees=(1,) * 64)),
    ("slime (least-load, RR)", dict(scheduler="rr", placement="least_load",
                                    degrees=(1,) * 64)),
]


def main(argv=None, predictor=None) -> dict:
    """Run the quickstart; returns its numbers.  ``predictor`` (a fitted
    ``ProgressivePredictor``) replaces the one fitted on the history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the engine step (default: the card)")
    ap.add_argument("--prompts", type=int, default=48,
                    help="prompts of the history and of the batch")
    ap.add_argument("--group-size", type=int, default=16, help="GRPO samples per prompt")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)     # before a minute of control plane
    out = {}

    # 1. historical rollouts -> progressive predictor (paper §4.1)
    history = replay_finished(generate(WorkloadConfig(
        task="coding", n_prompts=args.prompts, group_size=8, seed=1)))
    if predictor is None:
        predictor = ProgressivePredictor().fit_trajectories(history)
    print(f"predictor trained on {len(history)} historical trajectories "
          f"(longest: {int(predictor.hist_max_tokens)} tokens)")

    # 2. a fresh rollout batch (16 GRPO samples per prompt)
    batch = generate(WorkloadConfig(task="coding", n_prompts=args.prompts,
                                    group_size=args.group_size, seed=2))
    lengths = np.array([t.true_total_tokens for t in batch])
    print(f"batch: {len(batch)} trajectories, median {int(np.median(lengths))} tokens, "
          f"max {int(lengths.max())} (long-tail ratio {lengths.max()/np.median(lengths):.1f}x)")

    # 3. HOW — Algorithm 2: heterogeneous model-parallel degrees
    interference = InterferenceModel.analytic(0.01)
    alloc = sort_initialized_sa(lengths, budget=64, interference=interference,
                                latency=WorkerLatencyModel(t1=0.02), seed=0)
    print(f"resource manager: degrees={alloc.degrees} "
          f"(predicted makespan {alloc.makespan:.0f}s, {alloc.evaluations} SA evals)")
    out.update(degrees=list(alloc.degrees), sa_makespan=alloc.makespan,
               sa_evaluations=alloc.evaluations)

    # 4. WHERE — presorted dynamic programming (Lemma 5.1 + Formula 3)
    res = presorted_dp(lengths, len(alloc.degrees), interference,
                       base_token_time=WorkerLatencyModel(t1=0.02).token_times(alloc.degrees))
    sizes = [len(g) for g in res.groups]
    print(f"placement DP: group sizes {sizes} (longest trajectories get the "
          f"high-MP, low-interference workers)")
    out["group_sizes"] = sizes

    # 5. WHEN + end-to-end: the full system vs the paper's baselines
    print("\nrollout simulation (64 chips):")
    out["sim"] = {}
    for name, kw in SYSTEMS:
        r = simulate(copy.deepcopy(batch), predictor, gpu_budget=64, max_batch=100,
                     seed=0, **kw)
        print(f"  {name:26s} makespan {r.makespan:7.1f}s  "
              f"throughput {r.throughput:8.0f} tok/s  "
              f"(migrations {r.migrations}, preemptions {r.preemptions})")
        out["sim"][name.split()[0]] = dict(makespan=r.makespan, throughput=r.throughput,
                                           migrations=r.migrations,
                                           preemptions=r.preemptions)

    # 6. the real data plane: slot-pool continuous batching on a reduced model —
    #    trajectories join and leave one resident decode batch, a tool result is
    #    absorbed in place, and a preemption is just a mask flip
    cfg = get_config("qwen3_1_7b").reduced(n_periods=1)
    params = M.init_params(cfg, 0, device)
    w = RolloutWorker(cfg, params, capacity=32, max_slots=4,
                      sampler=SamplerConfig(temperature=0.8), device=device)
    for rid in range(3):
        w.prefill(rid, [5 + rid, 7, 9, 11])           # each prefill lands in a lane
    first = w.decode([0, 1, 2], 8)                     # one fused masked decode loop
    w.extend(0, [201, 202])                            # tool output, no prefix recompute
    w.preempt(1)                                       # mask flip, KV stays resident
    more = w.decode([0, 2], 4)                         # lane 1 rides along frozen
    n = sum(map(len, first.values())) + sum(map(len, more.values()))
    print(f"\nreal engine: {n} tokens across {len(w.store)} resident lanes "
          f"(pool {w.max_slots} slots, {w.kv_bytes(0) / 2**20:.1f} MiB/lane)")
    out["engine"] = dict(device=str(device), tokens=n, lanes=len(w.store),
                         decode_steps=w.decode_steps, n_layers=cfg.n_layers)
    return out


if __name__ == "__main__":
    main()
