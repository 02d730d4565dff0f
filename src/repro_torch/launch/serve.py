"""Serving launcher: event-driven Heddle rollout over the port's workers.

Runs the full trajectory-centric runtime (``repro_torch.engine.runtime``) on a seeded
long-tail agentic workload: real multi-step trajectories (generate → tool call →
absorb → repeat) across multiple ``RolloutWorker``s, with per-worker scheduler
queues, preemptive execution, progressive prediction refresh, and tool-interval
KV migration.  The model is ``--arch`` reduced to two periods, with random
params from ``--seed``.  Every worker runs on ``--device`` (default: the card;
with no CUDA device the launcher exits with an error unless given
``--device cpu``).

On the card:
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 --steps 3 \
        --scheduler pps [--migration on|off] [--tool-latency 1.0]

On the CPU:
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 8 --steps 2

Open-loop serving (Poisson ingress, tenant SLOs, admission control):
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 24 --arrival poisson \
        --qps 4 --tenants 'gold:0.25:30,best:0.75:10' [--admission on|off]

``--stream`` (rollout-as-a-service) needs the RL service plane, which the port
does not have yet; ``--dry-run`` compiles for a TPU pod and has no GPU
counterpart.  Both stop with an error.
"""

from __future__ import annotations

import argparse
import sys
import time


def _validate_args(ap, args):
    """Reject nonsensical flag combinations up front with one-line errors."""
    for flag, value in (("--requests", args.requests), ("--workers", args.workers),
                        ("--group-size", args.group_size),
                        ("--max-active", args.max_active),
                        ("--quantum", args.quantum),
                        ("--max-tokens", args.max_tokens),
                        ("--capacity", args.capacity)):
        if value < 1:
            ap.error(f"{flag} must be >= 1 (got {value})")
    if args.steps < 0:
        ap.error(f"--steps must be >= 0 (got {args.steps})")
    if args.stream:
        ap.error("--stream needs the rollout service (rl/service.py), which is "
                 "not ported yet")
    if args.dry_run:
        ap.error("--dry-run lowers for a TPU pod mesh; it has no GPU counterpart")
    if args.tool_latency <= 0:
        ap.error(f"--tool-latency must be > 0 (got {args.tool_latency})")
    if args.degrees:
        try:
            degrees = [int(d) for d in args.degrees.split(",")]
        except ValueError:
            ap.error(f"--degrees must be comma-separated integers "
                     f"(got {args.degrees!r})")
        if not degrees or any(d < 1 for d in degrees):
            ap.error(f"--degrees entries must be >= 1 (got {args.degrees!r})")
    if args.checkpoint_dir and args.chaos_seed is None:
        ap.error("--checkpoint-dir is the chaos-recovery store; it needs "
                 "--chaos-seed (nothing restores without a fault plan)")
    open_loop = args.arrival != "closed"
    if open_loop and args.qps <= 0:
        ap.error(f"--arrival {args.arrival} is open-loop and needs --qps > 0")
    if not open_loop and args.qps > 0:
        ap.error("--qps only applies to open-loop ingress; pick an --arrival "
                 "policy (poisson|bursty|diurnal)")
    if args.tenants and not open_loop:
        ap.error("--tenants only applies to open-loop ingress; pick an "
                 "--arrival policy (poisson|bursty|diurnal)")
    if args.tenants:
        from repro_torch.core.tenancy import parse_tenants
        try:
            parse_tenants(args.tenants)
        except ValueError as e:
            ap.error(f"--tenants: {e}")


def build_runtime(args, cfg, params):
    """Workload + predictor + controller + worker fleet + runtime for one run,
    on ``args.device``."""
    from repro_torch.engine.fleet import FleetSpec
    from repro_torch.engine.runtime import (RuntimeConfig, build_workbench,
                                            make_runtime)

    gsz = max(1, args.group_size)
    max_steps = args.steps if args.steps > 0 else None
    batch, predictor = build_workbench(
        task=args.task, n_prompts=-(-args.requests // gsz), group_size=gsz,
        seed=args.seed, base_steps=1.5 if max_steps is not None else 3.0,
        max_steps=max_steps, max_total_tokens=args.max_tokens)
    batch = batch[:args.requests]
    open_loop = args.arrival != "closed"
    serving = None
    if open_loop:
        from repro_torch.core.tenancy import (DEFAULT_TENANTS, ServingConfig,
                                              assign_tenants, parse_tenants)
        from repro_torch.engine.workload import assign_arrivals, make_arrivals

        # arrivals first (tenant deadlines are absolute: submit + deadline_s)
        assign_arrivals(batch, make_arrivals(args.arrival, rate=args.qps,
                                             seed=args.seed))
        tenants = parse_tenants(args.tenants) if args.tenants else DEFAULT_TENANTS
        assign_tenants(batch, tenants, seed=args.seed)
        per_worker = 4 * args.max_active
        serving = ServingConfig(admission_control=args.admission == "on",
                                queue_bound_per_worker=per_worker,
                                queue_bound_global=per_worker * args.workers,
                                shed_pressure=2.0, degrade_pressure=3.0)
    rcfg = RuntimeConfig(scheduler=args.scheduler,
                         migration=args.migration == "on",
                         max_active=args.max_active, quantum=args.quantum,
                         tool_latency_scale=args.tool_latency,
                         trace=args.trace > 0, seed=args.seed,
                         checkpoint_dir=args.checkpoint_dir or None,
                         open_loop=open_loop)
    fleet = None
    if args.degrees:
        fleet = FleetSpec.from_degrees(
            [int(d) for d in args.degrees.split(",")])
    faults = None
    if args.chaos_seed is not None:
        from repro_torch.core.faults import FaultPlan
        n_workers = fleet.n_workers if fleet is not None else args.workers
        # horizon estimate for scheduling the death: serial decode work split
        # across the fleet (an upper-ish bound is fine — kill_frac lands the
        # death mid-run for any reasonable workload)
        horizon = (sum(t.payload.total_tokens for t in batch)
                   * rcfg.token_time / max(1, n_workers))
        faults = FaultPlan.chaos(seed=args.chaos_seed, n_workers=n_workers,
                                 horizon=horizon)
    return make_runtime(cfg, params, batch, predictor,
                        n_workers=args.workers, config=rcfg,
                        capacity=args.capacity, fleet=fleet, faults=faults,
                        serving=serving, device=args.device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--group-size", type=int, default=4,
                    help="GRPO group size: requests per shared prompt (prefix-"
                         "affine placement keeps a group together so the radix "
                         "cache implants the shared prompt for siblings)")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--degrees", default="",
                    help="heterogeneous fleet: comma-separated per-worker MP "
                         "degrees, e.g. '4,2,1,1' (§6; overrides --workers; "
                         "the degrees drive the control plane, every worker "
                         "runs unsharded on --device)")
    ap.add_argument("--steps", type=int, default=3,
                    help="agentic steps per trajectory (plans truncated here; "
                         "easy samples finish earlier; 0 = no cap, keeping the "
                         "workload's full step-count tail)")
    ap.add_argument("--scheduler", default="pps",
                    choices=["pps", "fcfs", "rr", "sjf"])
    ap.add_argument("--migration", default="on", choices=["on", "off"],
                    help="tool-interval KV migration (§5.3)")
    ap.add_argument("--tool-latency", type=float, default=1.0,
                    help="scale on the workload's sampled tool latencies")
    ap.add_argument("--task", default="coding", choices=["coding", "search", "math"])
    ap.add_argument("--max-active", type=int, default=3,
                    help="decode-concurrency slots per worker")
    ap.add_argument("--quantum", type=int, default=8,
                    help="decode tokens per scheduling quantum")
    ap.add_argument("--max-tokens", type=int, default=48,
                    help="longest trajectory's total generated tokens")
    ap.add_argument("--capacity", type=int, default=160)
    ap.add_argument("--trace", type=int, default=0,
                    help="print the first N entries of the orchestrator's "
                         "(event, traj, worker) decision trace — the sequence "
                         "the sim/engine parity harness compares")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrival", default="closed",
                    choices=["closed", "poisson", "bursty", "diurnal"],
                    help="ingress mode: 'closed' submits the whole batch at "
                         "t=0 (training-style); the rest generate open-loop "
                         "arrival times at --qps (serving-style)")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="offered load for open-loop --arrival policies "
                         "(mean trajectory arrivals per virtual second)")
    ap.add_argument("--tenants", default="",
                    help="tenant classes as 'name:share[:deadline_s],...' "
                         "(e.g. 'gold:0.25:30,silver:0.35:60,best:0.4:15'); "
                         "tiers follow list order, the last class is sheddable; "
                         "empty = built-in gold/silver/best_effort mix")
    ap.add_argument("--admission", default="on", choices=["on", "off"],
                    help="deadline-aware admission control for open-loop "
                         "ingress (off = admit everything, queue bounds and "
                         "the degradation ladder still apply)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="run under a seeded FaultPlan.chaos schedule: one "
                         "mid-run worker death + revival and injected tool "
                         "timeouts/errors absorbed by capped-backoff retries "
                         "(trajectories recover from tool-boundary checkpoints)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="also persist tool-boundary checkpoints to this "
                         "directory (crash-atomic npz, one per trajectory)")
    ap.add_argument("--stream", type=int, default=0,
                    help="rollout-as-a-service; not ported yet (an error)")
    ap.add_argument("--dry-run", action="store_true",
                    help="TPU pod compile; no GPU counterpart (an error)")
    ap.add_argument("--device", default=None,
                    help="torch device of every worker (default: cuda; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    _validate_args(ap, args)

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    cfg = get_config(args.arch).reduced(n_periods=2)
    params = M.init_params(cfg, seed=args.seed, device=device)
    runtime = build_runtime(args, cfg, params)
    controller = runtime.controller

    t0 = time.time()
    res = runtime.run()
    dt = time.time() - t0

    for ws in runtime.workers:
        stats = ws.engine.dispatch_stats()
        served = sum(1 for t in res.trajectories
                     if t.worker_id == ws.wid and t.finished)
        print(f"worker {ws.wid}: finished {served} trajectories, "
              f"{stats['decode_steps']} decode steps, "
              f"prefix reuse {stats['reused_tokens']}/"
              f"{stats['reused_tokens'] + stats['prefilled_tokens']} admit tokens, "
              f"{stats['retired_lanes']} retired lanes")
        if "blocks_total" in stats:                   # paged KV pool occupancy
            print(f"  pages: {stats['blocks_resident']}/{stats['blocks_total']}"
                  f" blocks resident (peak {stats['blocks_used_high_watermark']}"
                  f", {stats['blocks_shared']} shared refs, page size "
                  f"{stats['page_size']}), alloc/free "
                  f"{stats['blocks_allocated_total']}/"
                  f"{stats['blocks_freed_total']}, {stats['block_grows']} grows")
    steps = sum(t.num_steps for t in res.trajectories)
    multi = sum(1 for t in res.trajectories if t.num_steps > 1)
    rate = controller.measured_reuse_rate
    print(f"\nserved {len(res.trajectories)} trajectories on {device} "
          f"({steps} agentic steps, {multi} multi-step) across "
          f"{len(runtime.workers)} workers: {res.total_tokens} real tokens "
          f"in {dt:.1f}s wall")
    print(f"virtual makespan {res.makespan:.2f}s "
          f"({res.throughput:.1f} tok/s), queue delay mean {res.queue_delay_mean:.3f}s "
          f"p99 {res.queue_delay_p99:.3f}s")
    print(f"preemptions {res.preemptions}, tool-interval migrations "
          f"{res.migrations}, tool invocations {runtime.env.invocations}, "
          f"measured prefix reuse rate {0.0 if rate is None else rate:.2f}")
    if args.arrival != "closed":
        print(f"open-loop ingress ({args.arrival} @ {args.qps:g} qps, "
              f"admission {args.admission}): {res.arrivals} arrivals, "
              f"{res.admitted} admitted, {res.deferred} deferred, "
              f"{res.shed} shed, {res.degraded} degraded")
        for name, st in res.tenant_report.items():
            print(f"  tenant {name:12s} arrived {st['arrived']:3d}  "
                  f"attainment {st['attainment']:.2f}  "
                  f"shed rate {st['shed_rate']:.2f}  "
                  f"latency p50 {st['latency_p50_s']:.2f}s "
                  f"p99 {st['latency_p99_s']:.2f}s")
    if args.chaos_seed is not None:
        print(f"chaos (seed {args.chaos_seed}): worker deaths "
              f"{res.worker_deaths}, checkpoint recoveries {res.recoveries}, "
              f"tool retries {res.tool_retries}, injected tool faults "
              f"{res.injected_tool_faults}")
    if args.trace > 0:
        print(f"\ndecision trace (first {args.trace} of {len(res.trace)}):")
        for kind, tid, wid in res.trace[:args.trace]:
            print(f"  {kind:12s} traj {tid:4d}  worker {wid}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
