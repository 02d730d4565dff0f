"""Discrete-event rollout-cluster simulation = orchestrator + analytic backend.

Evaluates orchestration policies at paper scale (64 accelerators, thousands of
trajectories, 40K-token tails) where real 8B-32B decoding is impossible in this
container.  The performance model follows the paper's own profiler-based
methodology (§5.2): a worker running b concurrent trajectories advances each at
per-token time ``T_w * F(b)`` where ``T_w`` is the worker's MP-dependent base
per-token time and F the profiled interference factor.  Prefill recompute on
cache miss, preemption, migration during tool calls and the transmission
scheduler are all modeled explicitly.

Since the control-plane unification there is no simulator-private event loop:
``RolloutSimulator.run()`` wires the analytic cost models
(``engine.backends.SimBackend``) into the one canonical
``core.orchestrator.Orchestrator`` — the same loop that drives the real
``RolloutWorker`` data plane — so every scheduling/preemption/migration
decision here is made by exactly the code the engine runs.

Everything policy-like is pluggable so Heddle and the §7 baselines run on
identical substrate:
  scheduler:  pps | fcfs | rr | sjf                     (core.scheduler)
  placement:  heddle | cache_aware | least_load | hybrid (core.controller)
  resources:  adaptive (Algorithm 2) | fixed MP list
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.core.controller import HeddleConfig, HeddleController, ROUTING_POLICIES
from repro_torch.core.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.core.placement import InterferenceModel
from repro_torch.core.predictor import ProgressivePredictor
from repro_torch.core.resource_manager import WorkerLatencyModel
from repro_torch.core.trajectory import Trajectory
from repro_torch.engine.backends import SimBackend


@dataclass(frozen=True)
class SimConfig:
    scheduler: str = "pps"
    placement: str = "heddle"            # heddle | cache_aware | least_load | hybrid
    degrees: tuple[int, ...] = ()        # worker MP degrees; () -> adaptive (Alg. 2)
    gpu_budget: int = 64                 # paper testbed: 64 GPUs
    mp_degrees: tuple[int, ...] = (1, 2, 4, 8)
    max_batch: int = 100                 # paper: batch 100 per rollout worker
    migration: bool = True
    work_aware_dp: bool = True           # beyond-paper DP cost; False = Formula 2
    # performance model
    base_token_time: float = 0.02        # s/token at MP=1, batch=1 (Qwen3-14B-ish)
    kv_weight_ratio: float = 0.010       # F(b) = 1 + r*b: the paper's group-size
    # interference premise (§5.1 "determined exclusively by the size of the group",
    # which the paper reports holds empirically on its workloads).  The default data
    # plane honors the premise so control-plane model and simulated hardware agree —
    # the paper-faithful configuration.
    # Beyond-paper robustness regime (EXPERIMENTS.md §Beyond): batched decode time can
    # instead scale with the *total KV context* resident in the batch (weights read
    # once, every sequence's KV streamed) — co-locating two 40K-context tails is then
    # expensive even at batch size 2.  Calibration: 40K-token KV ~ 3.3GB vs ~28GB
    # weights => coef ~ 3e-6.  Enabled by setting ctx_interference > 0.
    ctx_interference: float = 0.0        # F_worker += coef * sum(context_tokens)
    # Tensor-parallel communication: the per-step all-reduce moves activations whose
    # volume scales with the batch, so the comm fraction is o*(1 + gamma*b).  This is
    # the physics behind the paper's Fig 7 latency-throughput trade-off: high MP wins
    # per-token latency at small batch but loses per-chip throughput at saturation
    # (calibrated to ~0.5x per-chip throughput at MP=8, batch ~96 — vLLM/TGI-class TP
    # scaling).
    comm_overlap: float = 0.22
    comm_batch_coef: float = 0.087
    # Prefill is compute-bound while bs=1 decode is weight-read-bound, so one prefill
    # token costs ~1/100 of a decode token (14B bf16: ~0.1ms vs ~14ms on Hopper-class).
    prefill_speedup: float = 100.0
    # Measured radix-cache reuse (engine dispatch_stats -> controller
    # measured_reuse_rate): the fraction of a shared prompt a sibling arrival
    # actually implants instead of re-prefilling.  None keeps the paper's
    # assumption of full prompt reuse at a prompt-home worker (rate = 1.0).
    measured_reuse_rate: float | None = None
    link_bandwidth: float = 50e9         # migration link (GPU-Direct RDMA / ICI)
    model_layers: int = 40               # KV bytes model (Qwen3-14B-ish)
    model_kv_heads: int = 8
    model_head_dim: int = 128
    seed: int = 0
    sanitize: bool = False               # TraceSanitizer over the decision stream


@dataclass
class SimResult:
    makespan: float
    total_tokens: int
    throughput: float                     # tokens / s
    queue_delay_p100: float               # queueing delay of the longest trajectory
    queue_delay_mean: float
    migrations: int
    preemptions: int
    cache_miss_prefill_tokens: int
    trajectories: list[Trajectory] = field(default_factory=list)
    timeline: list[tuple[float, int]] = field(default_factory=list)  # (t, active count)


class RolloutSimulator:
    """Paper-scale policy studies on the unified orchestrator (SimBackend)."""

    def __init__(self, trajectories: Sequence[Trajectory], predictor: ProgressivePredictor,
                 config: SimConfig):
        self.cfg = config
        self.trajs = list(trajectories)
        self.predictor = predictor
        self.interference = InterferenceModel.analytic(config.kv_weight_ratio,
                                                       max_batch=max(4096, config.max_batch * 4))
        self.latency = WorkerLatencyModel(t1=config.base_token_time)
        self.controller = HeddleController(
            predictor, self.interference, self.latency, config.gpu_budget,
            HeddleConfig(scheduler=config.scheduler,
                         adaptive_resources=not config.degrees,
                         migration=config.migration and config.placement == "heddle",
                         mp_degrees=config.mp_degrees, sa_seed=config.seed,
                         max_group_count=4 * config.max_batch,
                         work_aware_dp=config.work_aware_dp),
            max_workers=config.gpu_budget)
        self.routing = None
        if config.placement != "heddle":
            self.routing = ROUTING_POLICIES[config.placement]()

    # ------------------------------------------------------------------ run
    def run(self) -> SimResult:
        cfg = self.cfg
        degrees = list(cfg.degrees) if cfg.degrees else self.controller.provision(self.trajs)
        heddle = cfg.placement == "heddle"
        if heddle:
            self.controller.degrees = degrees
        backend = SimBackend(
            degrees, [self.latency.base_token_time(mp) for mp in degrees],
            self.interference,
            t1=self.latency.t1,
            comm_overlap=cfg.comm_overlap, comm_batch_coef=cfg.comm_batch_coef,
            ctx_interference=cfg.ctx_interference,
            prefill_speedup=cfg.prefill_speedup,
            measured_reuse_rate=cfg.measured_reuse_rate,
            link_bandwidth=cfg.link_bandwidth,
            kv_layers=cfg.model_layers, kv_heads=cfg.model_kv_heads,
            kv_head_dim=cfg.model_head_dim)
        orch = Orchestrator(
            backend, self.trajs,
            OrchestratorConfig(scheduler=cfg.scheduler, max_active=cfg.max_batch,
                               migration=cfg.migration and heddle,
                               max_events=5_000_000, timeline_every=256,
                               sanitize=cfg.sanitize),
            controller=self.controller if heddle else None,
            routing=self.routing, predictor=self.predictor)
        res = orch.run()

        assert all(t.finished for t in self.trajs), "simulation ended with live trajectories"
        total_tokens = sum(t.tokens_generated for t in self.trajs)
        delays = np.asarray([t.total_queue_delay for t in self.trajs])
        longest = max(self.trajs, key=lambda t: t.true_total_tokens)
        return SimResult(
            makespan=res.makespan,
            total_tokens=total_tokens,
            throughput=total_tokens / res.makespan,
            queue_delay_p100=longest.total_queue_delay,
            queue_delay_mean=float(delays.mean()),
            migrations=res.migrations,
            preemptions=res.preemptions,
            cache_miss_prefill_tokens=backend.miss_tokens,
            trajectories=self.trajs,
            timeline=res.timeline,
        )


def simulate(trajectories, predictor, **kw) -> SimResult:
    return RolloutSimulator(trajectories, predictor, SimConfig(**kw)).run()
