"""Paper-scale orchestration study on the PyTorch port: 64 chips, 6400 trajectories
(the §7 setup).

Reproduces Figure 12 (system comparison) and Figure 16(b) (active-trajectory
timeline) in the port's calibrated cluster simulator, printing an ASCII timeline.
The simulator is host code: this example does no device work, so it takes no
``--device``.

Run:  PYTHONPATH=src python examples/torch_orchestration_at_scale.py [--small]
"""

import argparse
import copy

from repro_torch.core.predictor import ProgressivePredictor
from repro_torch.engine.simulator import simulate
from repro_torch.engine.workload import WorkloadConfig, generate, replay_finished

SYSTEMS = {
    "heddle": dict(scheduler="pps", placement="heddle"),
    "verl": dict(scheduler="rr", placement="cache_aware", degrees=(1,) * 64),
    "verl*": dict(scheduler="rr", placement="hybrid", degrees=(1,) * 64),
    "slime": dict(scheduler="rr", placement="least_load", degrees=(1,) * 64),
}


def ascii_timeline(timeline, width=60, label=""):
    if not timeline:
        return
    tmax = timeline[-1][0]
    nmax = max(n for _, n in timeline) or 1
    buckets = [0] * width
    for t, n in timeline:
        buckets[min(int(t / tmax * (width - 1)), width - 1)] = n
    bars = "".join(" .:-=+*#%@"[min(int(b / nmax * 9), 9)] for b in buckets)
    print(f"  {label:10s} |{bars}| {tmax:6.0f}s")


def main(argv=None, predictor=None) -> dict:
    """Run the study; returns each system's makespan and throughput.
    ``predictor`` (a fitted ``ProgressivePredictor``) replaces the one fitted
    on the history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="quarter-scale (fast)")
    args = ap.parse_args(argv)
    n_prompts = 32 if args.small else 400

    history = replay_finished(generate(WorkloadConfig(
        task="coding", n_prompts=64, group_size=8, seed=1)))
    if predictor is None:
        predictor = ProgressivePredictor().fit_trajectories(history)
    batch = generate(WorkloadConfig(task="coding", n_prompts=n_prompts,
                                    group_size=16, seed=2))
    print(f"{len(batch)} trajectories on 64 chips "
          f"({sum(t.true_total_tokens for t in batch)/1e6:.1f}M tokens to generate)\n")

    results = {}
    for name, kw in SYSTEMS.items():
        r = simulate(copy.deepcopy(batch), predictor, gpu_budget=64, max_batch=100,
                     seed=0, **kw)
        results[name] = r
        print(f"{name:8s} makespan {r.makespan:8.1f}s   throughput {r.throughput:9.0f} tok/s"
              f"   (x{results['heddle'].makespan and r.makespan/results['heddle'].makespan:.2f} vs heddle)")

    print("\nactive trajectories over time (Fig 16b):")
    for name in ("heddle", "verl", "slime"):
        ascii_timeline(results[name].timeline, label=name)
    return {name: dict(makespan=r.makespan, throughput=r.throughput,
                       timeline=r.timeline) for name, r in results.items()}


if __name__ == "__main__":
    main()
