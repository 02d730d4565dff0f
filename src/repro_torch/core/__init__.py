"""Heddle core: the paper's control-plane contribution.

  trajectory        — trajectory-centric metadata & lifecycle
  predictor         — progressive trajectory prediction (§4.1)
  scheduler         — progressive priority scheduling, Algorithm 1 (§4.2)
  placement         — presorted dynamic programming, Lemma 5.1 + Formula 3 (§5.2)
  migration         — scaled-capacity re-placement + transmission scheduler (§5.3)
  resource_manager  — sort-initialized simulated annealing, Algorithm 2 (§6.2)
  controller        — control plane + baseline routing policies (§3, §7)
  faults            — deterministic chaos schedules + tool retry discipline
                      (worker death/revival, injected tool timeouts/errors)
  tenancy           — tenant/SLA classes + serving-time overload policy
                      (admission control, backpressure, degradation ladder)
  orchestrator      — THE event loop: one lifecycle state machine driving a
                      pluggable ExecutionBackend (engine.backends: the analytic
                      SimBackend and the real-worker EngineBackend), so every
                      scheduling/preemption/migration decision is made by
                      exactly one code path on either substrate.  Runs closed
                      loop (whole batch at t=0, barrier on makespan) or open
                      loop (arrival events, admission, shedding), and under
                      ``stream_harvest`` yields each FINISHED trajectory the
                      moment it completes — the streaming mode the async
                      training plane (rl.service.RolloutService, in-flight
                      weight syncs, docs/training.md) is built on
"""

from repro_torch.core.faults import (FaultPlan, RetryPolicy, ToolCallTrace,
                                     resolve_tool_call)
from repro_torch.core.migration import (MigrationRequest, ScaledCapacityRouter,
                                        TransmissionScheduler, kv_cache_bytes)
from repro_torch.core.orchestrator import (ExecutionBackend, Orchestrator,
                                           OrchestratorConfig, OrchestratorResult,
                                           StepOutcome)
from repro_torch.core.placement import (InterferenceModel, PlacementResult,
                                        aggregate_short, brute_force_partition,
                                        evaluate_partition, place, presorted_dp)
from repro_torch.core.predictor import (HistoryPredictor, ModelPredictor,
                                        ProgressivePredictor, harvest, long_tail_recall,
                                        pearson)
from repro_torch.core.resource_manager import (AllocationResult, WorkerLatencyModel,
                                               homogeneous_allocation, sort_initialized_sa)
from repro_torch.core.scheduler import (FCFSScheduler, PPSScheduler, RoundRobinScheduler,
                                        SJFScheduler, make_scheduler)
from repro_torch.core.tenancy import (DEFAULT_TENANTS, ServingConfig, TenantClass,
                                      assign_tenants, parse_tenants)
from repro_torch.core.trajectory import StepRecord, Trajectory, TrajectoryPhase, make_group
from repro_torch.core.controller import (AdmissionDecision, CacheAffinityRouting,
                                         HeddleConfig, HeddleController, HybridRouting,
                                         LeastLoadRouting)

__all__ = [name for name in dir() if not name.startswith("_")]
