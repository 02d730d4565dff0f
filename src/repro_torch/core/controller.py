"""Heddle control plane (paper §3) and baseline routing policies (§7 baselines).

The control plane maintains the global view (cluster resources + trajectory states) and
makes the three orchestration decisions:

  when  — scheduler (core/scheduler.py), refreshed by the progressive predictor;
  where — placement (core/placement.py DP) + runtime migration (core/migration.py);
  how   — resource manager (core/resource_manager.py simulated annealing).

Baseline policies reproduce the paper's comparison systems on identical substrate:
  * ``CacheAffinityRouting`` — Verl: statically pin each trajectory to a worker
    (max prefix-cache hits, no load rebalancing).
  * ``LeastLoadRouting`` — Slime: route every step to the least-loaded worker.
  * ``HybridRouting`` — Verl*: least-load when load skew (max/min) exceeds a threshold,
    else cache-affine.
  * ``HeddleRouting`` — presorted-DP partition + rank-scaled migration.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Protocol, Sequence

import numpy as np

from repro_torch.core.migration import (MigrationRequest, ScaledCapacityRouter,
                                        TransmissionScheduler)
from repro_torch.core.placement import InterferenceModel
from repro_torch.core.predictor import ProgressivePredictor
from repro_torch.core.resource_manager import (WorkerLatencyModel, homogeneous_allocation,
                                               sort_initialized_sa)
from repro_torch.core.tenancy import ServingConfig
from repro_torch.core.trajectory import Trajectory


class RoutingPolicy(Protocol):
    def initial_worker(self, traj: Trajectory, loads: np.ndarray) -> int: ...
    def step_worker(self, traj: Trajectory, loads: np.ndarray) -> int: ...


class CacheAffinityRouting:
    """Verl-style: pin each GRPO group (all samples of one prompt) to one worker.

    Group pinning maximizes prefix-cache hits (the 16 samples share the prompt), which
    is exactly why it suffers the paper's load-imbalance pathology: a hard prompt's
    entire group of correlated-long trajectories lands on a single worker."""

    def initial_worker(self, traj: Trajectory, loads: np.ndarray) -> int:
        return traj.prompt_id % len(loads)

    def step_worker(self, traj: Trajectory, loads: np.ndarray) -> int:
        return traj.worker_id


class LeastLoadRouting:
    """Slime-style: every step goes to the least-loaded worker (cache be damned)."""

    def initial_worker(self, traj: Trajectory, loads: np.ndarray) -> int:
        return int(np.argmin(loads))

    def step_worker(self, traj: Trajectory, loads: np.ndarray) -> int:
        return int(np.argmin(loads))


class HybridRouting:
    """Verl*-style: least-load if max/min skew > threshold else cache-affine."""

    def __init__(self, skew_threshold: float = 32.0) -> None:
        self.skew_threshold = skew_threshold

    def initial_worker(self, traj: Trajectory, loads: np.ndarray) -> int:
        return traj.prompt_id % len(loads)

    def step_worker(self, traj: Trajectory, loads: np.ndarray) -> int:
        lo = max(float(loads.min()), 1.0)
        if float(loads.max()) / lo > self.skew_threshold:
            return int(np.argmin(loads))
        return traj.worker_id


@dataclass
class HeddleConfig:
    scheduler: str = "pps"
    adaptive_resources: bool = True
    migration: bool = True
    agg_threshold_quantile: float = 0.5   # aggregate trajectories below this length quantile
    agg_block: int = 8
    mp_degrees: tuple[int, ...] = (1, 2, 4, 8)
    sa_cooling: float = 0.95
    sa_seed: int = 0
    rank_hysteresis: float = 0.50         # migrate only on a material prediction change
    migration_cooldown_steps: int = 2     # steps between migrations of one trajectory
    max_migrations_per_traj: int = 2
    migration_load_gap: int = 4           # min live-count gap before migrating (material
                                          # benefit: KV transfer + re-warm are not free)
    max_group_count: float | None = None  # worker batch-slot capacity (DP group cap)
    work_aware_dp: bool = True            # beyond-paper DP cost (EXPERIMENTS.md §Perf);
                                          # False = paper-faithful Formula 2
    # open-loop serving policy (admission control, backpressure, degradation
    # ladder); the default ServingConfig disables all of it
    serving: ServingConfig = field(default_factory=ServingConfig)


@dataclass(frozen=True)
class AdmissionDecision:
    """Admission gate verdict for one open-loop arrival."""

    action: str                 # "admit" | "shed" | "defer"
    worker: int = -1            # placement when admitted
    reason: str = ""            # gate that fired ("queue_full", "deadline", ...)
    eta: float = 0.0            # predicted completion time (deadline gate only)


class HeddleController:
    """Trajectory-centric control plane for one rollout batch."""

    def __init__(
        self,
        predictor: ProgressivePredictor,
        interference: InterferenceModel,
        latency: WorkerLatencyModel,
        gpu_budget: int,
        config: HeddleConfig | None = None,
        max_workers: int | None = None,
    ) -> None:
        self.predictor = predictor
        self.interference = interference
        self.latency = latency
        self.gpu_budget = gpu_budget
        self.config = config or HeddleConfig()
        self.max_workers = max_workers
        self.transmission = TransmissionScheduler()
        self.capacity_router: Optional[ScaledCapacityRouter] = None
        self.degrees: list[int] = []
        self.groups: list[list[int]] = []
        self._traj_index: dict[int, Trajectory] = {}
        self.worker_stats: dict[int, dict] = {}   # wid -> engine dispatch_stats()
        self._finished_ids: set[int] = set()      # on_finish idempotency guard
        # migrations emitted but not yet executed: load accounting moves only when
        # the transfer actually launches (commit_migration) — emitting a request the
        # transmission scheduler later drops must not leak worker counts
        self._pending_migration: dict[int, MigrationRequest] = {}
        self._dead_workers: set[int] = set()  # fault layer: no placements here
        # ---- open-loop serving state (inert until begin_serving) ----------
        self._serving = False
        self._max_active = 1                      # decode slots per worker
        self.tenant_stats: dict[str, dict] = {}   # per-tenant latency accounting
        self._arrived_ids: set[int] = set()       # first-arrival dedup (deferrals re-enter)
        self.shed_log: list[tuple[int, str]] = [] # (traj_id, reason), decision order
        self.peak_global_count = 0                # queue-bound property-test watermarks
        self.peak_worker_count = 0

    # ------------------------------------------------------------ telemetry (measured)
    def record_worker_stats(self, worker_id: int, stats: dict) -> None:
        """Ingest a data-plane worker's ``dispatch_stats()`` snapshot.

        The engine reports *measured* prefix reuse (tokens implanted from the radix
        cache vs tokens actually prefilled), which replaces the control plane's
        assumed hit rates in placement and simulation."""
        self.worker_stats[worker_id] = dict(stats)

    @property
    def measured_reuse_rate(self) -> Optional[float]:
        """Fraction of admission tokens served from cached prefixes, cluster-wide.

        Admission tokens only — tool absorption (``absorbed_tokens``) is excluded,
        it has its own cache-hit path.  Cold first-of-group admissions ARE in the
        denominator, so this is a conservative lower bound on the per-sibling
        implant fraction the simulator's cache model applies.  ``None`` until any
        worker has reported — callers fall back to the paper's assumed full-prompt
        reuse in that case."""
        reused = sum(s.get("reused_tokens", 0) for s in self.worker_stats.values())
        total = reused + sum(s.get("prefilled_tokens", 0)
                             for s in self.worker_stats.values())
        if total == 0:
            return None
        return reused / total

    def calibration_observations(self) -> list[tuple[int, float, float]]:
        """Measured ``(mp, mean_batch, per_step_seconds)`` per reporting worker.

        Derived from the engine's decode telemetry (warm, compile-free calls
        only): ``decode_wall_s / decode_timed_steps`` is the observed per-STEP
        decode time at the worker's declared MP degree — the quantity the
        latency model prices, since the full-pool masked kernel costs the same
        whether 1 or 8 lanes are live and one step advances every live lane one
        token.  ``decode_timed_lane_steps / decode_timed_steps`` is the mean
        live batch the model's comm/interference term regresses on.  Feeds
        ``WorkerLatencyModel.fit`` (§6 calibration — t1/overlap from
        observations instead of Fig. 7 constants).
        """
        obs: list[tuple[int, float, float]] = []
        for stats in self.worker_stats.values():
            steps = stats.get("decode_timed_steps", 0)
            lane_steps = stats.get("decode_timed_lane_steps", 0)
            wall = stats.get("decode_wall_s", 0.0)
            if steps > 0 and wall > 0.0:
                obs.append((int(stats.get("mp", 1)),
                            lane_steps / steps, wall / steps))
        return obs

    def calibrate_latency(self, observations=None) -> Optional[WorkerLatencyModel]:
        """Refit the worker latency model from measured decode timing.

        Swaps ``self.latency`` so the next provisioning / placement round prices
        MP degrees from observed behavior.  Returns the fitted model, or None
        when no worker has reported timing yet (model unchanged)."""
        obs = (observations if observations is not None
               else self.calibration_observations())
        if not obs:
            return None
        self.latency = WorkerLatencyModel.fit(
            obs, comm_batch_coef=self.latency.comm_batch_coef)
        return self.latency

    # ------------------------------------------------------------ provisioning (how)
    def provision(self, trajectories: Sequence[Trajectory]) -> list[int]:
        """Run Algorithm 2 (or homogeneous fallback) to pick worker MP degrees.

        Lengths are pre-aggregated (§5.2 short-trajectory heuristic) so every SA
        evaluation's DP runs on a few hundred items instead of thousands.
        """
        lengths = self._predicted_lengths(trajectories)
        # Provisioning runs periodically and is amortized across training steps
        # (paper §7.5), so it plans on the *historical length distribution* — which is
        # stable across steps — rather than on this batch's prompt-time point
        # predictions (which are intra-group-variance-blind, Fig. 5).  Resample the
        # historical distribution to this batch's size.
        hist = getattr(self.predictor, "hist_lengths", None)
        if hist is not None and len(hist) > 8 and len(lengths):
            q = np.linspace(0.0, 1.0, len(lengths))
            lengths = np.quantile(hist, q)
        if self.config.adaptive_resources:
            from repro_torch.core.placement import aggregate_short
            n = len(lengths)
            if n > 192:
                # keep the long tail at full resolution, bundle the rest aggressively:
                # the SA only needs coarse makespans to rank allocations
                thresh = float(np.quantile(lengths, max(0.0, 1.0 - 64.0 / n)))
                block = max(self.config.agg_block, -(-n // 128))
                ilen, icnt, _ = aggregate_short(lengths, thresh, block)
            else:
                ilen, icnt = lengths, None
            res = sort_initialized_sa(
                ilen, self.gpu_budget, self.interference, self.latency,
                degrees=self.config.mp_degrees, cooling=self.config.sa_cooling,
                max_workers=self.max_workers, counts=icnt, seed=self.config.sa_seed,
                work_aware=self.config.work_aware_dp,
                max_group_count=self.config.max_group_count)
            self.degrees = res.degrees
        else:
            self.degrees = homogeneous_allocation(self.gpu_budget, self.config.mp_degrees[0])
        return self.degrees

    # ------------------------------------------------------------ placement (where)
    def initial_placement(self, trajectories: Sequence[Trajectory]) -> list[list[int]]:
        """Presorted DP over prompt-stage predictions; returns per-worker traj lists."""
        self._traj_index = {t.traj_id: t for t in trajectories}
        lengths = self._predicted_lengths(trajectories)
        m = len(self.degrees) if self.degrees else (self.max_workers or 1)
        thresh = float(np.quantile(lengths, self.config.agg_threshold_quantile)) \
            if len(lengths) else None
        token_times = (self.latency.token_times(self.degrees)
                       if self.degrees else 1.0)
        # heterogeneous DP via per-worker token times, aggregation for speed
        from repro_torch.core.placement import aggregate_short, presorted_dp
        cap = self.config.max_group_count
        wa = self.config.work_aware_dp
        if thresh is not None and len(lengths) > 4 * m:
            ilen, icnt, members = aggregate_short(lengths, thresh, self.config.agg_block)
            res = presorted_dp(ilen, m, self.interference, token_times, counts=icnt,
                               max_group_count=cap, work_aware=wa)
            groups = [[orig for item in g for orig in members[item]] for g in res.groups]
        else:
            res = presorted_dp(lengths, m, self.interference, token_times,
                               max_group_count=cap, work_aware=wa)
            groups = res.groups
        self.groups = groups
        self.capacity_router = ScaledCapacityRouter([len(g) for g in groups])
        for w, group in enumerate(groups):
            for idx in group:
                trajectories[idx].worker_id = w
        # incremental rank-tracking state (see on_step_complete)
        self._slots = {t.traj_id: i for i, t in enumerate(trajectories)}
        self._n_slots = len(trajectories)
        self._pred_totals = np.asarray([t.predicted_total for t in trajectories])
        self._live = np.ones(len(trajectories), dtype=bool)
        # per-worker live-trajectory counts (migration load feedback)
        self._worker_count = np.array([len(g) for g in groups], dtype=np.int64)
        # heterogeneity-aware load weights: a resident trajectory on a slow
        # (low-MP) worker represents more drain time than one on a fast worker,
        # so the migration gate compares counts in fast-worker equivalents —
        # count * token_time / min(token_time).  Homogeneous fleets reduce to
        # the plain counts this replaces.
        if self.degrees and len(self.degrees) == m:
            tts = np.asarray(self.latency.token_times(self.degrees), dtype=float)
            self._load_weight = tts / tts.min()
        else:
            self._load_weight = np.ones(m, dtype=float)
        self._finished_ids.clear()
        self._pending_migration.clear()
        for t in trajectories:
            t._last_migration_pred = t.predicted_total    # hysteresis anchor
        return groups

    # ------------------------------------------------------------ runtime (telemetry)
    def on_step_complete(self, traj: Trajectory, active: Sequence[Trajectory]) -> Optional[MigrationRequest]:
        """Telemetry hook: refresh prediction, maybe emit a migration request (§5.3).

        Rank computation is incremental: a dense array of predicted totals (indexed by a
        per-batch slot id) is kept up to date one entry at a time, so each telemetry
        event costs O(n) vector ops instead of an O(n log n) sort.
        """
        traj.predicted_remaining = self.predictor.predict(traj)
        traj.priority = traj.predicted_total
        if not (self.config.migration and self.capacity_router is not None):
            return None
        slot = self._slots.get(traj.traj_id)
        if slot is None or traj.finished:
            return None
        # refresh the rank state even when no new request may be emitted, so
        # other trajectories never rank against a stale priority
        self._pred_totals[slot] = traj.priority
        self._live[slot] = not traj.finished
        if traj.traj_id in self._pending_migration:
            return None                   # one in-flight migration per trajectory
        live_preds = self._pred_totals[self._live]
        n_active = int(self._live.sum())
        if n_active == 0:
            return None
        rank = int((live_preds > traj.priority).sum())
        target = self.capacity_router.worker_for_rank(rank, n_active)
        # load feedback (beyond-paper, EXPERIMENTS.md §Perf): the paper's open-loop
        # scaled-capacity mapping over-concentrates late-discovered tails on the few
        # original "long" workers; pick the least-loaded worker within a
        # +/-2-group window of the capacity target instead.  Loads are in
        # fast-worker equivalents (count * relative token time): on a
        # heterogeneous fleet an "idle" mp=1 worker is NOT a good home for a
        # tail that a busy mp=4 worker would still drain sooner.
        loads = (self._worker_count * self._load_weight).astype(float)
        if self._dead_workers:
            # a dead worker must never win the window argmin (inf on the loads
            # array, NOT an inf load weight: inf * 0 residents would be nan)
            loads[list(self._dead_workers)] = np.inf
        lo, hi = max(0, target - 2), min(len(self._worker_count), target + 3)
        target = lo + int(np.argmin(loads[lo:hi]))
        # material-benefit gate: a migration must buy a real interference reduction
        # (KV transfer + re-warm are not free), so require a clear load gap
        if loads[target] + self.config.migration_load_gap \
                > loads[traj.worker_id]:
            return None
        # backpressure: a migration must not push the target over its queue
        # bound (unbounded by default, so closed-loop behavior is unchanged)
        if float(self._worker_count[target]) + 1.0 \
                > self.config.serving.queue_bound_per_worker:
            return None
        if target != traj.worker_id:
            # hysteresis: only migrate when the prediction moved materially since the
            # last migration decision — rank jitter at group boundaries otherwise
            # ping-pongs trajectories between adjacent workers
            last = getattr(traj, "_last_migration_pred", None)
            if last is not None and abs(traj.priority - last) < \
                    self.config.rank_hysteresis * max(last, 1.0) \
                    and abs(target - traj.worker_id) < 2:
                return None
            if traj.migrations >= self.config.max_migrations_per_traj:
                return None
            if traj.num_steps - getattr(traj, "_last_mig_step", -99) < \
                    self.config.migration_cooldown_steps:
                return None
            traj._last_mig_step = traj.num_steps
            traj._last_migration_pred = traj.priority
            req = MigrationRequest(traj.traj_id, traj.worker_id, target,
                                   length=traj.predicted_total)
            self._pending_migration[traj.traj_id] = req
            self.transmission.submit(req)
            return req
        return None

    def commit_migration(self, traj_id: int) -> Optional[MigrationRequest]:
        """The KV transfer for ``traj_id`` actually launched: move load accounting.

        Idempotent — a second commit (or a commit for a request that was never
        emitted) is a no-op, so runtimes can call it from completion paths without
        tracking which requests they already acknowledged."""
        req = self._pending_migration.pop(traj_id, None)
        if req is not None:
            self._worker_count[req.src] -= 1
            self._worker_count[req.dst] += 1
        return req

    def abort_migration(self, traj_id: int) -> None:
        """Drop an emitted-but-unexecuted migration (trajectory resumed/finished).

        No load accounting to undo — counts move only at commit."""
        if self._pending_migration.pop(traj_id, None) is not None:
            self.transmission.cancel(traj_id)

    def on_finish(self, traj: Trajectory) -> None:
        if traj.traj_id in self._finished_ids:
            return                        # idempotent: double-finish must not
        self._finished_ids.add(traj.traj_id)  # double-decrement worker counts
        self.abort_migration(traj.traj_id)
        slot = self._slots.get(traj.traj_id)
        if slot is not None:
            self._live[slot] = False
        if getattr(self, "_worker_count", None) is not None and traj.worker_id is not None \
                and traj.worker_id < len(self._worker_count):
            self._worker_count[traj.worker_id] -= 1
        if self._serving:
            ts = self._tstat(traj.tenant)
            ts["finished"] += 1
            ts["latencies"].append(traj.completion_time())
            if traj.finish_time <= traj.slo_deadline:
                ts["deadline_met"] += 1

    def on_degrade(self, traj: Trajectory) -> None:
        """Tenant accounting for a ladder level-2 step-budget tightening."""
        self._tstat(traj.tenant)["degraded"] += 1

    # ------------------------------------------------------------ faults (elasticity)
    def mark_worker_dead(self, worker_id: int) -> None:
        """Worker died: exclude it from every future placement decision.

        Its residents are recovered one by one via :meth:`on_recover`, which
        moves the load accounting; the count left here is whatever the
        orchestrator has not yet re-admitted."""
        self._dead_workers.add(worker_id)

    def mark_worker_alive(self, worker_id: int) -> None:
        """Replacement capacity joined for slot ``worker_id`` (cold cache)."""
        self._dead_workers.discard(worker_id)

    def on_recover(self, traj: Trajectory, dst: int) -> None:
        """A checkpoint restore re-admitted ``traj`` on ``dst``: move its load.

        Mirrors ``commit_migration``'s accounting for the recovery path; any
        pending migration for the trajectory is stale (its src is gone)."""
        self.abort_migration(traj.traj_id)
        if getattr(self, "_worker_count", None) is None:
            return
        src = traj.worker_id
        if src is not None and src < len(self._worker_count):
            self._worker_count[src] -= 1
        if dst < len(self._worker_count):
            self._worker_count[dst] += 1

    # ------------------------------------------------------- serving (open loop)
    def begin_serving(self, max_active: int) -> None:
        """Enter open-loop mode: empty rank state, arrivals admitted one by one.

        The closed-loop path sizes its rank-tracking arrays in
        :meth:`initial_placement` from the whole batch; a serving front door
        sees trajectories only as they arrive, so the dense arrays start empty
        and grow geometrically (padding slots stay ``live=False`` so every
        closed-loop vector op still works unchanged).
        """
        m = len(self.degrees) if self.degrees else (self.max_workers or 1)
        self._serving = True
        self._max_active = max(int(max_active), 1)
        self.groups = [[] for _ in range(m)]
        # equal nominal capacities: open loop has no batch presort to derive
        # group sizes from, so rank-scaled migration maps ranks uniformly
        self.capacity_router = ScaledCapacityRouter([1.0] * m)
        self._traj_index = {}
        self._slots: dict[int, int] = {}
        self._n_slots = 0
        self._pred_totals = np.zeros(0, dtype=float)
        self._live = np.zeros(0, dtype=bool)
        self._worker_count = np.zeros(m, dtype=np.int64)
        if self.degrees and len(self.degrees) == m:
            tts = np.asarray(self.latency.token_times(self.degrees), dtype=float)
            self._load_weight = tts / tts.min()
        else:
            self._load_weight = np.ones(m, dtype=float)
        self._finished_ids.clear()
        self._pending_migration.clear()
        self.tenant_stats.clear()
        self._arrived_ids.clear()
        self.shed_log.clear()
        self.peak_global_count = 0
        self.peak_worker_count = 0

    def _tstat(self, tenant: str) -> dict:
        return self.tenant_stats.setdefault(tenant, {
            "arrived": 0, "admitted": 0, "deferred": 0, "shed": 0,
            "finished": 0, "deadline_met": 0, "degraded": 0, "latencies": [],
        })

    def _abs_token_time(self, worker_id: int) -> float:
        """Absolute per-token seconds on one worker (admission-gate pricing)."""
        if self.degrees and worker_id < len(self.degrees):
            return float(self.latency.base_token_time(self.degrees[worker_id]))
        return float(self.latency.t1)

    def service_estimate(self, traj: Trajectory, worker_id: int) -> float:
        """Predicted seconds to drain ``traj`` on ``worker_id`` at current load.

        Processor-sharing approximation: predicted remaining tokens priced at
        the worker's token time, stretched by the residents it would share the
        worker with.  Deliberately deterministic and cheap — this is the
        admission gate's completion-time oracle, not a simulator.
        """
        tokens = max(float(traj.predicted_remaining), 1.0)
        sharing = 1.0 + float(self._worker_count[worker_id])
        return tokens * self._abs_token_time(worker_id) * sharing

    def edf_boost(self, traj: Trajectory, now: float) -> float:
        """EDF urgency term blended into the PPS priority at submit time.

        urgency = predicted service time / remaining slack (capped): a request
        whose slack is shrinking toward its service demand outranks peers of
        equal predicted length, so deadlines shape preemption without
        abandoning the paper's LPT core.  Scale-matched to predicted_total so
        the boost competes in the same units as the base priority.
        """
        cfg = self.config.serving
        if cfg.edf_weight <= 0.0 or not math.isfinite(traj.slo_deadline):
            return 0.0
        fastest = min((self._abs_token_time(w)
                       for w in range(len(self._worker_count))
                       if w not in self._dead_workers),
                      default=self._abs_token_time(0))
        service = max(float(traj.predicted_remaining), 1.0) * fastest
        slack = traj.slo_deadline - now
        urgency = cfg.edf_urgency_cap if slack <= 0.0 else \
            min(service / slack, cfg.edf_urgency_cap)
        return cfg.edf_weight * urgency * max(traj.predicted_total, 1.0)

    def pressure(self) -> float:
        """Live work vs decode capacity: 1.0 = every slot on every alive worker
        is spoken for; the degradation ladder triggers on this."""
        alive = len(self._worker_count) - len(self._dead_workers)
        capacity = max(alive, 1) * self._max_active
        return float(self._live.sum()) / capacity

    def admit_arrival(self, traj: Trajectory, now: float) -> AdmissionDecision:
        """Admission gate for one open-loop arrival (possibly a deferred retry).

        Order of gates: (1) backpressure — bounded global/per-worker queues;
        a full queue sheds sheddable work and defers the rest.  (2) deadline
        gate — predict completion from the progressive predictor + current
        fast-worker-equivalent loads; a sheddable arrival that cannot meet its
        SLO is rejected at the door (finishing it late helps nobody and its
        service time would push *other* tenants over).  Gold-tier work is
        never shed here, whatever the prediction says.
        """
        cfg = self.config.serving
        ts = self._tstat(traj.tenant)
        if traj.traj_id not in self._arrived_ids:
            self._arrived_ids.add(traj.traj_id)
            ts["arrived"] += 1
        traj.predicted_remaining = self.predictor.predict(traj)
        traj.priority = traj.predicted_total
        alive = [w for w in range(len(self._worker_count))
                 if w not in self._dead_workers]
        if not alive:
            ts["deferred"] += 1
            return AdmissionDecision("defer", reason="no_alive_worker")
        loads = (self._worker_count * self._load_weight).astype(float)
        if self._dead_workers:
            loads[list(self._dead_workers)] = np.inf
        worker = int(np.argmin(loads))
        full = (float(self._live.sum()) >= cfg.queue_bound_global
                or float(self._worker_count[worker]) >= cfg.queue_bound_per_worker)
        if full:
            if traj.sheddable:
                return AdmissionDecision("shed", reason="queue_full")
            ts["deferred"] += 1
            return AdmissionDecision("defer", reason="queue_full")
        if cfg.admission_control and traj.sheddable \
                and math.isfinite(traj.slo_deadline):
            eta = now + self.service_estimate(traj, worker)
            if eta > traj.slo_deadline:
                return AdmissionDecision("shed", reason="deadline", eta=eta)
        self._register_arrival(traj, worker)
        ts["admitted"] += 1
        return AdmissionDecision("admit", worker=worker)

    def _register_arrival(self, traj: Trajectory, worker: int) -> None:
        """Adopt an admitted arrival into the incremental rank/load state."""
        if self._n_slots >= len(self._pred_totals):
            grow = max(64, 2 * len(self._pred_totals))
            self._pred_totals = np.concatenate(
                [self._pred_totals, np.zeros(grow, dtype=float)])
            self._live = np.concatenate(
                [self._live, np.zeros(grow, dtype=bool)])
        slot = self._n_slots
        self._n_slots += 1
        self._slots[traj.traj_id] = slot
        self._pred_totals[slot] = traj.predicted_total
        self._live[slot] = True
        self._traj_index[traj.traj_id] = traj
        self._worker_count[worker] += 1
        traj.worker_id = worker
        traj._last_migration_pred = traj.predicted_total
        self.peak_worker_count = max(self.peak_worker_count,
                                     int(self._worker_count.max()))
        self.peak_global_count = max(self.peak_global_count,
                                     int(self._live.sum()))

    def on_shed(self, traj: Trajectory, now: float, reason: str,
                admitted: bool) -> None:
        """Load + tenant accounting for a shed decision (gate or ladder)."""
        self.shed_log.append((traj.traj_id, reason))
        self._tstat(traj.tenant)["shed"] += 1
        if not admitted:
            return
        self.abort_migration(traj.traj_id)
        slot = self._slots.get(traj.traj_id)
        if slot is not None:
            self._live[slot] = False
        if traj.worker_id is not None and traj.worker_id < len(self._worker_count):
            self._worker_count[traj.worker_id] -= 1

    def select_shed_victims(self, candidates: Sequence[Trajectory]
                            ) -> list[Trajectory]:
        """Ladder level 1: pick queued sheddable work to drop, enough to bring
        pressure back under the shed threshold.  Deterministic order — lowest
        tier last (shed highest tier first), largest predicted remaining work
        first within a tier, traj_id as the final tiebreak.  Gold (tier 0)
        and non-sheddable work are never candidates."""
        cfg = self.config.serving
        pool = sorted((t for t in candidates
                       if t.sheddable and t.tenant_tier > 0
                       and not t.finished and not t.shed),
                      key=lambda t: (-t.tenant_tier, -t.predicted_remaining,
                                     t.traj_id))
        alive = len(self._worker_count) - len(self._dead_workers)
        capacity = max(alive, 1) * self._max_active
        excess = float(self._live.sum()) - cfg.shed_pressure * capacity
        n = min(len(pool), max(int(math.ceil(excess)), 0))
        return pool[:n]

    def select_degrade_victims(self, candidates: Sequence[Trajectory]
                               ) -> list[Trajectory]:
        """Ladder level 2: live non-gold trajectories whose step budget the
        orchestrator should tighten.  Gold (tier 0) is untouchable."""
        return [t for t in candidates
                if t.tenant_tier > 0 and not t.degraded
                and not t.finished and not t.shed]

    def tenant_report(self) -> dict[str, dict]:
        """Per-tenant serving metrics: completion-latency percentiles, deadline
        attainment (a shed request counts as a missed deadline), and the
        admit/defer/shed/degrade counters."""
        report: dict[str, dict] = {}
        for tenant, ts in sorted(self.tenant_stats.items()):
            lat = np.asarray(ts["latencies"], dtype=float)
            arrived = max(ts["arrived"], 1)
            report[tenant] = {
                "arrived": ts["arrived"], "admitted": ts["admitted"],
                "deferred": ts["deferred"], "shed": ts["shed"],
                "finished": ts["finished"], "degraded": ts["degraded"],
                "deadline_met": ts["deadline_met"],
                "attainment": ts["deadline_met"] / arrived,
                "shed_rate": ts["shed"] / arrived,
                "latency_p50_s": float(np.percentile(lat, 50)) if len(lat) else 0.0,
                "latency_p99_s": float(np.percentile(lat, 99)) if len(lat) else 0.0,
                "latency_mean_s": float(lat.mean()) if len(lat) else 0.0,
            }
        return report

    def _predicted_lengths(self, trajectories: Sequence[Trajectory]) -> np.ndarray:
        for t in trajectories:
            t.predicted_remaining = self.predictor.predict(t)
            t.priority = t.predicted_total
        return np.asarray([t.predicted_total for t in trajectories])


ROUTING_POLICIES = {
    "cache_aware": CacheAffinityRouting,
    "least_load": LeastLoadRouting,
    "hybrid": HybridRouting,
}
