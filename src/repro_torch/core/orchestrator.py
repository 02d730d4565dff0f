"""The one event-driven orchestration core (control plane, backend-agnostic).

Heddle's trajectory-centric decisions — *when* (progressive priority scheduling
with preemptive execution, Algorithm 1), *where* (placement + tool-interval
migration, §5.3), *how fast* (per-worker MP pricing, §6) — used to be executed
by two hand-rolled twin event loops: one inside the discrete-event simulator and
one inside the real-engine runtime.  Every policy change had to land twice and
the loops drifted.  ``Orchestrator`` is the single canonical lifecycle machine

    PENDING → GENERATING ⇄ PREEMPTED
                  │
                  ▼
              TOOL_CALL → MIGRATING → (PENDING …) → FINISHED

driving a pluggable :class:`ExecutionBackend` that supplies only *mechanics and
cost*: how a generation step advances, what it costs in virtual seconds, how a
lane is preempted or migrated, and what the step's tool call returns.  Two
backends ship in ``repro_torch.engine.backends``:

* ``SimBackend`` — the analytic processor-sharing cost model (paper-scale
  studies: 64 workers, thousands of trajectories, 40K-token tails);
* ``EngineBackend`` — the real ``RolloutWorker`` slot-pool data plane on a
  deterministic virtual clock (real tokens, real KV lanes, real migrations).

Because both backends run under this one loop, the scheduling/migration
*decision sequence* is a property of the policy, not of the substrate — the
decision-trace parity harness (``tests/test_orchestrator.py``) asserts the two
backends produce identical ``(event, traj, worker)`` traces on the same
workload.  All policy hooks flow through ``HeddleController`` exactly once:
``initial_placement``, ``on_step_complete`` (progressive refresh + migration
emission), ``commit_migration``/``abort_migration``, ``on_finish``,
``record_worker_stats``.

The loop also carries the asynchronous rollout-as-a-service plane (the JAX
package's ``rl.service``, not ported yet; docs/training.md): with
``stream_harvest`` on, ``run_stream()`` yields each FINISHED trajectory through a
``harvest`` event instead of barriering on the makespan, ``inject()`` admits new
work mid-run,
and ``publish_weights()`` schedules an in-flight weight sync — each worker
cuts over to the new policy epoch only once its resident lanes drain, so every
trajectory finishes on the weights that admitted it (the ``weight_epoch``
stamp, enforced by the sanitizer).
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Iterable, Optional, Protocol, Sequence

import numpy as np

from repro_torch.core.faults import FaultPlan
from repro_torch.core.scheduler import make_scheduler
from repro_torch.core.trajectory import StepRecord, Trajectory, TrajectoryPhase


@dataclass(frozen=True)
class StepOutcome:
    """What one completed generation step looked like, backend-reported.

    ``gen_tokens`` is the step's actual generation length (plan tokens for the
    simulator, decoded tokens for the engine), ``terminal`` ends the episode,
    and the ``tool_*`` fields describe the tool call the step triggered (for a
    terminal step they are recorded but no tool interval is waited out).
    ``tool_failed`` is the *plan-driven* task-level failure (rectification
    signal); ``tool_attempts``/``tool_injected_faults`` account the chaos
    layer's injected timeouts/errors separately — the two channels must never
    be conflated (the predictor's features consume only the former).
    """

    gen_tokens: int
    terminal: bool
    tool_latency: float
    tool_failed: bool
    tool_output_tokens: int
    gen_time: float = 0.0
    tool_attempts: int = 1
    tool_injected_faults: int = 0


class ExecutionBackend(Protocol):
    """Mechanics-and-cost contract the orchestrator drives (see docs/runtime.md).

    The orchestrator owns lifecycle, queues, preemption policy, migration
    policy and all controller traffic; the backend owns *how work advances and
    what it costs*.  A backend is either **interruptible** (``advance`` can
    settle partial progress at any instant — analytic cost models) or not
    (work is quantized; new arrivals wait for the current quantum — real
    engines).  The orchestrator adapts its event discipline accordingly.
    """

    interruptible: bool

    @property
    def n_workers(self) -> int: ...

    def admit(self, trajectories: Sequence[Trajectory], now: float = 0.0) -> None:
        """Admission (e.g. prompt prefill) charged to clocks: the whole batch
        at t=0 closed loop, or one arrival at a time (at ``now``) open loop."""
        ...

    def ready_time(self, wid: int, now: float) -> float:
        """Earliest instant worker ``wid`` can start newly queued work."""
        ...

    def dispatch(self, wid: int, traj: Trajectory, fresh: bool) -> float:
        """Start (``fresh``) or resume a step on ``wid``; returns its token-work."""
        ...

    def preempt(self, wid: int, traj: Trajectory) -> None:
        """Evict ``traj`` mid-step, persisting its remaining work and state."""
        ...

    def advance(self, wid: int, now: float) -> Iterable[int]:
        """Progress ``wid`` to ``now``; returns traj_ids whose step completed."""
        ...

    def next_completion(self, wid: int, now: float) -> Optional[float]:
        """Time of ``wid``'s next step completion (None if idle)."""
        ...

    def tool_submit(self, traj: Trajectory) -> StepOutcome:
        """Roll the completed step's tool call; returns the step's outcome."""
        ...

    def tool_absorb(self, traj: Trajectory) -> None:
        """Fold the pending tool output into the trajectory's context."""
        ...

    def can_migrate(self, traj: Trajectory) -> bool: ...

    def migrate_out(self, traj: Trajectory, dst: int) -> float:
        """Extract the trajectory's state for transfer; returns link seconds."""
        ...

    def migrate_in(self, traj: Trajectory, dst: int) -> None:
        """Land the in-flight state on worker ``dst``."""
        ...

    def release(self, traj: Trajectory) -> None:
        """The trajectory finished; free (or retire) its resources."""
        ...

    def stats(self, wid: int) -> dict:
        """Measured telemetry snapshot for ``wid`` ({} when nothing measured)."""
        ...

    # ---- failure realism (fault injection / recovery; see docs/runtime.md) ----

    def checkpoint(self, traj: Trajectory) -> None:
        """Snapshot the trajectory's state at a tool boundary (restore source)."""
        ...

    def restore(self, traj: Trajectory, dst: int) -> float:
        """Re-admit the trajectory on ``dst`` from its last tool-boundary
        checkpoint (the prompt when it never completed a step); returns the
        virtual seconds the re-admission transfer costs."""
        ...

    def kill(self, wid: int) -> None:
        """Worker ``wid`` died: drop every resident lane and all mid-step state."""
        ...

    def revive(self, wid: int) -> None:
        """Replacement capacity for slot ``wid`` joined (cold cache)."""
        ...

    # ---- in-flight weight sync (async rollout-as-a-service; docs/training.md) ----

    def stage_weights(self, params, epoch: int) -> None:
        """Publish new policy weights as ``epoch``; staged, not applied — each
        worker cuts over via ``sync_weights`` once its residents drain.
        ``params=None`` advances the epoch without new tensors (modeled runs)."""
        ...

    def sync_weights(self, wid: int, epoch: int) -> None:
        """Cut worker ``wid`` over to the staged ``epoch``: swap weights in and
        drop every cached stale-weight prefix (the orchestrator's drain fence
        guarantees the worker holds no resident lanes at this instant)."""
        ...


@dataclass(frozen=True)
class OrchestratorConfig:
    scheduler: str = "pps"  # pps | fcfs | rr | sjf (per-worker queues)
    migration: bool = True  # tool-interval migration (§5.3)
    max_active: int = 4  # concurrent generation slots per worker
    open_loop: bool = False  # serve an arrival process instead of a t=0 batch
    preemption_margin: float = 1.0  # PPS hysteresis (multiplicative)
    preemption_floor: float = 1.0  # PPS hysteresis (additive)
    max_events: int = 2_000_000  # runaway-loop guard
    timeline_every: int = 0  # sample (t, live) every N events (0 = off)
    trace: bool = False  # record the (event, traj, worker) decision trace
    sanitize: bool = False  # validate the decision stream (TraceSanitizer)
    stream_harvest: bool = False  # emit harvest events; run_stream() yields them


@dataclass
class OrchestratorResult:
    makespan: float
    preemptions: int
    migrations: int
    queue_delay_mean: float  # over per-step queue delays
    queue_delay_p99: float
    trajectories: list[Trajectory] = field(default_factory=list)
    events: int = 0
    trace: list[tuple[str, int, int]] = field(default_factory=list)
    timeline: list[tuple[float, int]] = field(default_factory=list)
    # chaos telemetry (all zero on a fault-free run)
    worker_deaths: int = 0
    recoveries: int = 0  # trajectory re-admissions from a checkpoint
    tool_retries: int = 0  # injected-fault retry attempts across the batch
    injected_tool_faults: int = 0  # injected timeouts + transient errors
    # serving telemetry (all zero/empty on a closed-loop run)
    arrivals: int = 0  # open-loop arrival events handled (deferrals excluded)
    admitted: int = 0
    shed: int = 0  # dropped by the admission gate or the ladder
    deferred: int = 0  # admissions pushed back by backpressure
    degraded: int = 0  # step budgets tightened by ladder level 2
    peak_live_global: int = 0  # high-water mark of concurrently live trajs
    peak_live_worker: int = 0  # high-water mark on any single worker
    tenant_report: dict = field(default_factory=dict)
    sanitizer: dict = field(default_factory=dict)  # TraceSanitizer report ({} = off)


class _WorkerLane:
    """One worker's control-plane view: queue + active set + event bookkeeping."""

    def __init__(self, wid: int, scheduler_name: str):
        self.wid = wid
        self.scheduler = make_scheduler(scheduler_name)
        self.active: set[int] = set()  # traj_ids with a step in progress
        self.version = 0  # event-staleness guard
        self.sleeping = True  # no worker event in flight
        self.alive = True  # dead lanes accept no work (fault injection)
        self.incoming = 0  # checkpoint restores headed here (placement spread)


class Orchestrator:
    """The canonical rollout event loop over a pluggable execution backend.

    The caller supplies the backend, the trajectory batch and exactly one
    placement/policy source: a ``HeddleController`` (full Heddle stack —
    placement DP, progressive refresh, migration) or a baseline ``routing``
    policy plus a bare ``predictor`` (§7 comparison systems).  ``run()``
    executes the batch to completion and returns substrate-independent metrics
    plus (optionally) the decision trace.
    """

    def __init__(
        self,
        backend: ExecutionBackend,
        trajectories: Sequence[Trajectory],
        config: OrchestratorConfig = OrchestratorConfig(),
        *,
        controller=None,
        routing=None,
        predictor=None,
        faults: Optional[FaultPlan] = None,
    ):
        if controller is None and predictor is None:
            raise ValueError("need a controller or a bare predictor")
        if controller is None and routing is None:
            raise ValueError("need a controller or a routing policy for placement")
        self.backend = backend
        self.cfg = config
        self.controller = controller
        self.routing = routing
        self.predictor = predictor if predictor is not None else controller.predictor
        self.trajs = list(trajectories)
        self.by_id = {t.traj_id: t for t in self.trajs}
        self.lanes = [_WorkerLane(w, config.scheduler) for w in range(backend.n_workers)]
        for lane in self.lanes:
            if hasattr(lane.scheduler, "preemption_margin"):
                lane.scheduler.preemption_margin = config.preemption_margin
                lane.scheduler.preemption_floor = config.preemption_floor
        self._mid_step: set[int] = set()  # step in progress (resume ≠ fresh)
        self.in_flight: dict[int, tuple[int, int]] = {}  # traj -> (dst, transfer token)
        self.tool_arrived: set[int] = set()  # tool done while state in flight
        self.faults = faults
        # tool-boundary checkpoints are only worth their cost when a death can
        # actually orphan a lane; fault-free runs skip them entirely (parity)
        self._checkpointing = faults is not None and bool(faults.deaths)
        self.restoring: dict[int, tuple[int, bool]] = {}  # traj -> (token, resubmit)
        self._xfer_seq = itertools.count()  # staleness tokens for transfers/restores
        # async service plane: per-worker weight epochs + residency fence
        self.now = 0.0  # virtual instant of the event being handled
        self.published_epoch = 0  # latest epoch handed to publish_weights
        self.weight_epoch = 0  # latest epoch whose sync event has popped
        self.applied_epoch = [0] * backend.n_workers  # per-worker applied epoch
        self._resident: list[set[int]] = [set() for _ in range(backend.n_workers)]
        self._started = False
        self._result: Optional[OrchestratorResult] = None
        self.preemptions = 0
        self.migrations = 0
        self.worker_deaths = 0
        self.recoveries = 0
        self.arrivals = 0
        self.admitted = 0
        self.shed_count = 0
        self.deferred = 0
        self.degraded = 0
        self.events = 0
        self.trace: list[tuple[str, int, int]] = []
        self.timeline: list[tuple[float, int]] = []
        self._evq: list[tuple[float, int, str, object]] = []
        self._seq = itertools.count()
        self._sanitizer = None
        if config.sanitize:
            # lazy: core must not import analysis (which imports core) eagerly
            from repro_torch.analysis.sanitize import TraceSanitizer

            self._sanitizer = TraceSanitizer(
                self.trajs, backend.n_workers, config.max_active
            )

    # ------------------------------------------------------------ event plumbing
    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self._evq, (t, next(self._seq), kind, payload))

    def _note(self, kind: str, tid: int, wid: int) -> None:
        if self.cfg.trace:
            self.trace.append((kind, tid, wid))
        if self._sanitizer is not None:
            self._sanitizer.observe(kind, tid, wid)

    def _loads(self) -> np.ndarray:
        return np.asarray(
            [
                len(ln.active) + len(ln.scheduler) if ln.alive else np.inf
                for ln in self.lanes
            ],
            float,
        )

    def _plan(self, lane: _WorkerLane, now: float) -> None:
        """Re-derive the worker's next completion event; stale events die."""
        lane.version += 1
        nc = self.backend.next_completion(lane.wid, now)
        if nc is None:
            lane.sleeping = True
        else:
            lane.sleeping = False
            self._push(nc, "worker", (lane.wid, lane.version))

    def _worker_pass(self, lane: _WorkerLane, now: float) -> None:
        """Settle work, handle completed steps, refill, replan — one pass."""
        for tid in self.backend.advance(lane.wid, now):
            lane.active.discard(tid)
            self._mid_step.discard(tid)
            self._complete_step(self.by_id[tid], lane, now)
        self._dispatch(lane, now)
        self._plan(lane, now)

    def _submit(self, traj: Trajectory, now: float) -> None:
        """Queue the trajectory's next generation step on its current worker."""
        lane = self.lanes[traj.worker_id]
        traj._queued_at = now
        if self.cfg.open_loop and self.controller is not None:
            # EDF blend: refresh the urgency boost each time the trajectory
            # (re-)enters a queue, so shrinking slack steadily raises priority
            traj.slo_boost = self.controller.edf_boost(traj, now)
        lane.scheduler.submit(traj, now)
        if self.backend.interruptible:
            self._worker_pass(lane, now)
        elif lane.sleeping:
            lane.sleeping = False
            lane.version += 1
            self._push(
                self.backend.ready_time(lane.wid, now),
                "worker",
                (lane.wid, lane.version),
            )

    # ------------------------------------------------------------ dispatch / preempt
    def _start(self, lane: _WorkerLane, traj: Trajectory, now: float) -> None:
        tid = traj.traj_id
        traj._step_queue_delay = getattr(traj, "_step_queue_delay", 0.0) + max(
            0.0, now - getattr(traj, "_queued_at", now)
        )
        fresh = tid not in self._mid_step
        self._mid_step.add(tid)
        traj.phase = TrajectoryPhase.GENERATING
        lane.active.add(tid)
        self.backend.dispatch(lane.wid, traj, fresh)
        self._note("start", tid, lane.wid)

    def _preempt(self, lane: _WorkerLane, victim: Trajectory, now: float) -> None:
        """Algorithm 1 lines 5-10: evict, persist state, requeue."""
        tid = victim.traj_id
        self.backend.preempt(lane.wid, victim)
        lane.active.discard(tid)  # _mid_step persists: next start is a resume
        victim.preemptions += 1
        self.preemptions += 1
        victim.phase = TrajectoryPhase.PREEMPTED
        victim._queued_at = now
        lane.scheduler.submit(victim, now)
        self._note("preempt", tid, lane.wid)

    def _dispatch(self, lane: _WorkerLane, now: float) -> None:
        while len(lane.active) < self.cfg.max_active and len(lane.scheduler):
            traj = lane.scheduler.pop(now)
            if traj is None:
                break
            self._start(lane, traj, now)
        if lane.scheduler.preemptive and len(lane.scheduler):
            for _ in range(len(lane.active)):
                # canonical candidate order: preempt_victim breaks priority
                # ties by position, so set order would leak into the trace
                active = [self.by_id[t] for t in sorted(lane.active)]
                victim = lane.scheduler.preempt_victim(active)
                if victim is None:
                    break
                self._preempt(lane, victim, now)
                nxt = lane.scheduler.pop(now)
                if nxt is not None:
                    self._start(lane, nxt, now)

    # ------------------------------------------------------------ step lifecycle
    def _complete_step(self, traj: Trajectory, lane: _WorkerLane, now: float) -> None:
        out = self.backend.tool_submit(traj)
        rec = StepRecord(
            traj.num_steps,
            int(out.gen_tokens),
            out.tool_latency,
            tool_failed=out.tool_failed,
            tool_output_tokens=out.tool_output_tokens,
            queue_delay=getattr(traj, "_step_queue_delay", 0.0),
            gen_time=out.gen_time,
            tool_attempts=out.tool_attempts,
            tool_injected_faults=out.tool_injected_faults,
        )
        traj.record_step(rec)
        traj._step_queue_delay = 0.0
        traj.record_tool_output(out.tool_output_tokens)
        stats = self.backend.stats(lane.wid)
        if stats and self.controller is not None:
            self.controller.record_worker_stats(lane.wid, stats)
        self._note("step", traj.traj_id, lane.wid)
        if out.terminal:
            traj.finished = True
            traj.finish_time = now
            traj.phase = TrajectoryPhase.FINISHED
            if self.controller is not None:
                self.controller.on_finish(traj)
            self.backend.release(traj)
            self._note("finish", traj.traj_id, lane.wid)
            self._unbind(traj.traj_id, now)
            if self.cfg.stream_harvest:
                # no makespan barrier: the consumer sees this trajectory now
                self._push(now, "harvest", traj.traj_id)
            return
        traj.phase = TrajectoryPhase.TOOL_CALL
        if self._checkpointing:
            # tool boundary = the recovery point: a later worker death loses at
            # most the tokens decoded since this snapshot
            self.backend.checkpoint(traj)
        self._push(now + out.tool_latency, "tool_done", traj.traj_id)
        # progressive refresh + migration decision, masked by the tool interval
        if self.controller is not None:
            req = self.controller.on_step_complete(traj, ())
            if req is not None and self.cfg.migration:
                for r in self.controller.transmission.next_batch():
                    self._launch_migration(r, now)
        else:
            traj.predicted_remaining = self.predictor.predict(traj)
            traj.priority = traj.predicted_total

    # ------------------------------------------------------------ migration (§5.3)
    def _launch_migration(self, req, now: float) -> None:
        traj = self.by_id.get(req.traj_id)
        if (
            traj is None
            or traj.phase is not TrajectoryPhase.TOOL_CALL
            or req.traj_id in self.restoring
            or req.src != traj.worker_id  # moved by a checkpoint recovery
            or not self.lanes[req.dst].alive  # destination died since emission
            or self.applied_epoch[req.dst] != traj.weight_epoch  # policy mismatch
            or not self.backend.can_migrate(traj)
        ):
            # resumed, finished, or already moved: migrating now would stall the
            # critical path — drop without touching load accounting
            self.controller.transmission.complete(req.traj_id)
            self.controller.abort_migration(req.traj_id)
            return
        dur = self.backend.migrate_out(traj, req.dst)
        self.controller.commit_migration(req.traj_id)
        traj.phase = TrajectoryPhase.MIGRATING
        traj.migrations += 1
        self.migrations += 1
        token = next(self._xfer_seq)
        self.in_flight[req.traj_id] = (req.dst, token)
        # rebind residency to dst now: the destination must not cut weights
        # over while an epoch-matched lane is on the wire towards it
        self._unbind(req.traj_id, now)
        self._resident[req.dst].add(req.traj_id)
        self._push(now + dur, "migration_done", (req.traj_id, token))
        self._note("migrate", req.traj_id, req.dst)

    def _on_migration_done(self, tid: int, token: int, now: float) -> None:
        if self.in_flight.get(tid, (None, None))[1] != token:
            return  # transfer aborted (destination died mid-flight)
        dst, _ = self.in_flight.pop(tid)
        traj = self.by_id[tid]
        self.backend.migrate_in(traj, dst)
        traj.worker_id = dst
        self.controller.transmission.complete(tid)
        self._note("migrate_done", tid, dst)
        for r in self.controller.transmission.next_batch():
            self._launch_migration(r, now)
        if tid in self.tool_arrived:  # transfer outlived the tool call
            self.tool_arrived.discard(tid)
            self._resume(traj, now)
        else:  # fully masked by the tool call
            traj.phase = TrajectoryPhase.TOOL_CALL

    def _on_tool_done(self, tid: int, now: float) -> None:
        traj = self.by_id[tid]
        self._note("tool_done", tid, traj.worker_id)
        if tid in self.in_flight or tid in self.restoring:
            # state still on the wire (migration or checkpoint restore): the
            # trajectory resumes when its lane lands
            self.tool_arrived.add(tid)
            return
        self._resume(traj, now)

    # ------------------------------------------------------------ faults / recovery
    def _pick_survivor(self, epoch: int = 0) -> int:
        """Least-loaded alive lane, counting restores already headed there.

        Lanes whose applied weight epoch matches the recovering trajectory's
        stamp are preferred (the lane resumes on the policy that started it);
        when none matches, availability beats purity — the stamp is still
        never rewritten, so the staleness-bounded consumer sees the truth.
        """
        alive = [ln for ln in self.lanes if ln.alive]
        if not alive:
            raise RuntimeError("all workers dead: nothing left to recover onto")
        matching = [ln for ln in alive if self.applied_epoch[ln.wid] == epoch]
        if matching:
            alive = matching
        return min(
            alive, key=lambda ln: (len(ln.active) + len(ln.scheduler) + ln.incoming, ln.wid)
        ).wid

    def _recover(self, traj: Trajectory, now: float, resubmit: bool) -> None:
        """Re-admit ``traj`` on a survivor from its last tool-boundary checkpoint.

        ``resubmit`` distinguishes a trajectory that must re-queue a generation
        step once landed (it was generating/queued when its worker died — the
        tokens since the last tool boundary are lost and re-decoded) from one
        whose tool call is still outstanding (it resumes via ``tool_done``).
        """
        tid = traj.traj_id
        dst = self._pick_survivor(traj.weight_epoch)
        if self.controller is not None:  # reads worker_id as src: before reassign
            self.controller.on_recover(traj, dst)
        delay = self.backend.restore(traj, dst)
        self._unbind(tid, now)
        self._resident[dst].add(tid)
        traj.worker_id = dst
        traj.recoveries += 1
        self.recoveries += 1
        self.lanes[dst].incoming += 1
        token = next(self._xfer_seq)
        self.restoring[tid] = (token, resubmit)
        self._push(now + delay, "restore_done", (tid, token))
        self._note("recover", tid, dst)

    def _on_restore_done(self, tid: int, token: int, now: float) -> None:
        entry = self.restoring.get(tid)
        if entry is None or entry[0] != token:
            return  # superseded: the restore target died before the lane landed
        _, resubmit = self.restoring.pop(tid)
        traj = self.by_id[tid]
        self.lanes[traj.worker_id].incoming -= 1
        self._note("restore_done", tid, traj.worker_id)
        if resubmit:
            traj.phase = TrajectoryPhase.PENDING
            self._submit(traj, now)
        elif tid in self.tool_arrived:  # tool finished while the lane was in flight
            self.tool_arrived.discard(tid)
            self._resume(traj, now)
        else:
            traj.phase = TrajectoryPhase.TOOL_CALL

    def _on_worker_death(self, wid: int, now: float) -> None:
        lane = self.lanes[wid]
        if not lane.alive:
            return
        lane.alive = False
        lane.version += 1  # every in-flight worker event for this lane is stale
        lane.sleeping = True
        self.worker_deaths += 1
        self._note("worker_death", -1, wid)
        # queued residents: their scheduler entries die with the lane
        queued: list[Trajectory] = []
        while len(lane.scheduler):
            t = lane.scheduler.pop(now)
            if t is not None:
                queued.append(t)
        victims = [self.by_id[tid] for tid in sorted(lane.active)]
        lane.active.clear()
        self.backend.kill(wid)
        if self.controller is not None:
            self.controller.mark_worker_dead(wid)
        for traj in victims + queued:
            self._mid_step.discard(traj.traj_id)  # partial step is gone: fresh redo
            self._recover(traj, now, resubmit=True)
        for traj in self.trajs:
            if traj.finished or traj.shed:
                continue
            tid = traj.traj_id
            if tid in self.in_flight and self.in_flight[tid][0] == wid:
                # in-flight migration to a corpse: abort cleanly, recover from
                # the checkpoint (the wire copy never lands)
                self.in_flight.pop(tid)
                self.controller.transmission.complete(tid)
                self._recover(traj, now, resubmit=False)
            elif (
                tid in self.restoring
                and traj.worker_id == wid
                and traj not in victims
                and traj not in queued
            ):
                # restore was headed to the dead worker: re-route (new token
                # invalidates the stale restore_done)
                _, resubmit = self.restoring.pop(tid)
                self._recover(traj, now, resubmit=resubmit)
            elif (
                traj.phase is TrajectoryPhase.TOOL_CALL
                and traj.worker_id == wid
                and tid not in self.in_flight
                and tid not in self.restoring
            ):
                # resident parked at a tool boundary: its KV died with the worker
                self._recover(traj, now, resubmit=False)
        # losing a worker shrinks capacity: re-check the overload ladder
        self._degradation_ladder(now)

    def _on_worker_up(self, wid: int, now: float) -> None:
        lane = self.lanes[wid]
        if lane.alive:
            return
        lane.alive = True
        lane.version += 1
        lane.sleeping = True
        self.backend.revive(wid)
        if self.controller is not None:
            self.controller.mark_worker_alive(wid)
        self._note("worker_up", -1, wid)
        # a cold replacement has no residents: adopt the latest policy at once
        self._try_sync(lane, now)

    def _resume(self, traj: Trajectory, now: float) -> None:
        # resuming invalidates any emitted-but-unlaunched migration: its target
        # was chosen from now-stale load/rank data
        if self.controller is not None:
            self.controller.abort_migration(traj.traj_id)
        if self.routing is not None:
            traj.worker_id = int(self.routing.step_worker(traj, self._loads()))
        self.backend.tool_absorb(traj)
        self._submit(traj, now)

    # ------------------------------------------------------------ serving (open loop)
    def _on_arrival(self, tid: int, now: float) -> None:
        """One open-loop arrival (or a deferred retry) hits the front door."""
        traj = self.by_id[tid]
        first = traj.deferrals == 0
        if first:
            self.arrivals += 1
            self._note("arrival", tid, -1)
        if self.controller is None:
            # baseline routing has no admission policy: place and go
            traj.predicted_remaining = self.predictor.predict(traj)
            traj.priority = traj.predicted_total
            traj.worker_id = int(self.routing.initial_worker(traj, self._loads()))
            self.backend.admit([traj], now)
            self._admit_resident(traj)
            self.admitted += 1
            self._note("admit", tid, traj.worker_id)
            self._submit(traj, now)
            return
        decision = self.controller.admit_arrival(traj, now)
        if decision.action == "shed":
            self._shed(traj, now, decision.reason, admitted=False)
            return
        if decision.action == "defer":
            traj.deferrals += 1
            self.deferred += 1
            self._note("defer", tid, -1)
            self._push(now + self.controller.config.serving.defer_seconds,
                       "arrival", tid)
            return
        self.backend.admit([traj], now)
        self._admit_resident(traj)
        self.admitted += 1
        self._note("admit", tid, decision.worker)
        self._submit(traj, now)
        self._degradation_ladder(now)

    def _shed(self, traj: Trajectory, now: float, reason: str,
              admitted: bool) -> None:
        """Drop one trajectory (admission gate or ladder level 1)."""
        tid = traj.traj_id
        if admitted:
            # it only ever sheds from a queue (PENDING/PREEMPTED): pull the
            # scheduler entry and free whatever lane state the backend holds
            self.lanes[traj.worker_id].scheduler.remove(traj)
            self._mid_step.discard(tid)
            self.backend.release(traj)
            self._unbind(tid, now)
        if self.controller is not None:
            self.controller.on_shed(traj, now, reason, admitted)
        traj.shed = True
        traj.shed_reason = reason
        traj.finish_time = now
        traj.phase = TrajectoryPhase.SHED
        self.shed_count += 1
        self._note("shed", tid, traj.worker_id if admitted else -1)

    def _degradation_ladder(self, now: float) -> None:
        """Graceful degradation under sustained overload (two levels).

        Level 1 (pressure >= shed_pressure): shed queued sheddable work,
        highest tier first, until pressure returns under the threshold.
        Level 2 (pressure >= degrade_pressure): tighten the step budget of
        live non-gold trajectories (they finish at their current-or-next tool
        boundary).  Gold tier is untouchable at every level; every decision
        lands in the trace, so sim/engine parity covers the ladder too.
        """
        ctl = self.controller
        if ctl is None or not self.cfg.open_loop:
            return
        scfg = ctl.config.serving
        if ctl.pressure() >= scfg.shed_pressure:
            queued: list[Trajectory] = []
            for lane in self.lanes:
                if lane.alive:
                    queued.extend(lane.scheduler.queued())
            for victim in ctl.select_shed_victims(queued):
                self._shed(victim, now, "overload", admitted=True)
        if ctl.pressure() >= scfg.degrade_pressure:
            live = [t for t in self.trajs if not t.finished and not t.shed]
            for traj in ctl.select_degrade_victims(live):
                traj.step_cap = traj.num_steps + scfg.degrade_step_grace
                traj.degraded = True
                self.degraded += 1
                ctl.on_degrade(traj)
                self._note("degrade", traj.traj_id, traj.worker_id
                           if traj.worker_id is not None else -1)

    # ------------------------------------------------------------ async service plane
    def _admit_resident(self, traj: Trajectory) -> None:
        """Stamp the admitting worker's applied weight epoch and bind residency.

        The stamp is written exactly once, here: a resident finishes on the
        policy that admitted it (sanitizer-enforced), and the staleness-bounded
        consumer compares this stamp against the latest published epoch.
        """
        wid = traj.worker_id
        traj.weight_epoch = self.applied_epoch[wid]
        self._resident[wid].add(traj.traj_id)

    def _unbind(self, tid: int, now: float) -> None:
        """Release ``tid``'s residency; a fully drained lane may cut weights over."""
        for lane in self.lanes:
            residents = self._resident[lane.wid]
            if tid in residents:
                residents.remove(tid)
                if not residents:
                    self._try_sync(lane, now)
                return

    def _try_sync(self, lane: _WorkerLane, now: float) -> None:
        """In-flight weight-sync fence: cut worker ``lane`` over to the latest
        published epoch only when it holds zero resident lanes — never under a
        running, queued, parked-at-a-tool-boundary or inbound trajectory."""
        wid = lane.wid
        if (
            not lane.alive
            or self.applied_epoch[wid] >= self.weight_epoch
            or self._resident[wid]
        ):
            return
        self.backend.sync_weights(wid, self.weight_epoch)
        self.applied_epoch[wid] = self.weight_epoch
        self._note("weight_sync", self.weight_epoch, wid)

    def publish_weights(self, params=None, *, at: Optional[float] = None) -> int:
        """Stage new policy weights and schedule their in-flight sync.

        Returns the new epoch.  ``at`` (virtual time, >= now) models training
        latency: the epoch only starts cutting workers over once its
        ``weight_sync`` event pops.  ``params=None`` advances the epoch without
        new tensors (modeled benches).  Workers adopt the epoch individually as
        their residents drain; lanes admitted before their worker cut over keep
        their old stamp, which is exactly what the staleness bound consumes.
        """
        self.published_epoch += 1
        epoch = self.published_epoch
        self.backend.stage_weights(params, epoch)
        when = self.now if at is None else max(self.now, at)
        self._push(when, "weight_sync", (epoch, next(self._xfer_seq)))
        return epoch

    def _on_weight_sync(self, epoch: int, now: float) -> None:
        if epoch <= self.weight_epoch:
            return  # superseded by a later publish that already popped
        self.weight_epoch = epoch
        for lane in self.lanes:
            self._try_sync(lane, now)

    def inject(self, trajectories: Sequence[Trajectory]) -> None:
        """Mid-run submission (rollout-as-a-service): new work enters the
        open-loop front door at the current virtual instant."""
        if not self.cfg.open_loop:
            raise ValueError("inject() needs open_loop mode (the service plane)")
        if not self._started:
            raise RuntimeError("inject() before run(): pass initial work instead")
        for t in trajectories:
            if t.traj_id in self.by_id:
                raise ValueError(f"trajectory {t.traj_id} already submitted")
            t.submit_time = self.now
            self.trajs.append(t)
            self.by_id[t.traj_id] = t
            self._push(self.now, "arrival", t.traj_id)
        if self._sanitizer is not None:
            self._sanitizer.register(trajectories)

    # ------------------------------------------------------------ run
    def run(self) -> OrchestratorResult:
        """Execute to completion (the synchronous barrier view of run_stream)."""
        for _ in self.run_stream():
            pass
        return self._result

    def run_stream(self):
        """Drive the event loop, yielding each harvested trajectory.

        Harvest events only exist under ``cfg.stream_harvest``; without it the
        generator yields nothing and ``run()`` degenerates to the classic
        barrier.  Between yields the consumer may ``inject()`` new work and
        ``publish_weights()`` — the service plane's whole API.  When the heap
        drains, the final :class:`OrchestratorResult` lands in ``self._result``.
        """
        self._begin()
        while self._evq:
            self.events += 1
            if self.events > self.cfg.max_events:
                raise RuntimeError("orchestrator event budget exceeded")
            now, _, kind, payload = heapq.heappop(self._evq)
            self.now = now
            harvested: Optional[Trajectory] = None
            if self._sanitizer is not None:
                self._sanitizer.on_clock(now)
            if kind == "worker":
                wid, ver = payload
                lane = self.lanes[wid]
                if self._sanitizer is not None:
                    self._sanitizer.on_worker_event(
                        wid, ver == lane.version, lane.alive
                    )
                if ver != lane.version:
                    continue  # stale event superseded by a replan
                self._worker_pass(lane, now)
            elif kind == "tool_done":
                self._on_tool_done(payload, now)
            elif kind == "migration_done":
                tid, token = payload
                self._on_migration_done(tid, token, now)
            elif kind == "restore_done":
                tid, token = payload
                self._on_restore_done(tid, token, now)
            elif kind == "arrival":
                self._on_arrival(payload, now)
            elif kind == "worker_death":
                self._on_worker_death(payload, now)
            elif kind == "worker_up":
                self._on_worker_up(payload, now)
            elif kind == "harvest":
                harvested = self.by_id[payload]
                self._note("harvest", payload, harvested.worker_id)
            elif kind == "weight_sync":
                epoch, _sync_token = payload
                self._on_weight_sync(epoch, now)
            if self.cfg.timeline_every and self.events % self.cfg.timeline_every == 0:
                self.timeline.append((now, sum(1 for t in self.trajs if not t.finished)))
            if harvested is not None:
                yield harvested
        self._result = self._finalize()

    def _begin(self) -> None:
        """Seed the heap: the t=0 batch (closed loop) or the arrival process."""
        self._started = True
        if self.cfg.open_loop:
            # serving: trajectories arrive over time (submit_time stamped by an
            # ArrivalPolicy); placement and admission happen per arrival
            if self.controller is not None:
                self.controller.begin_serving(self.cfg.max_active)
            for t in self.trajs:
                self._push(t.submit_time, "arrival", t.traj_id)
        else:
            for t in self.trajs:
                t.predicted_remaining = self.predictor.predict(t)
                t.priority = t.predicted_total
                t.submit_time = 0.0
            if self.routing is not None:
                loads = np.zeros(len(self.lanes))
                for t in self.trajs:
                    t.worker_id = int(self.routing.initial_worker(t, loads))
                    loads[t.worker_id] += 1
            else:
                self.controller.initial_placement(self.trajs)
            self.backend.admit(self.trajs)
            for t in self.trajs:
                self._admit_resident(t)
                self._submit(t, 0.0)
        if self.faults is not None:
            # the chaos schedule rides the same versioned heap as everything else
            for t, wid in self.faults.deaths:
                self._push(t, "worker_death", wid)
            for t, wid in self.faults.revivals:
                self._push(t, "worker_up", wid)

    def _finalize(self) -> OrchestratorResult:
        unfinished = [t.traj_id for t in self.trajs if not t.finished and not t.shed]
        assert not unfinished, f"orchestrator drained with live trajectories {unfinished}"
        # balance checks + raise on any accumulated invariant violation
        sanitizer_report = (
            self._sanitizer.finalize() if self._sanitizer is not None else {}
        )
        delays = np.asarray([s.queue_delay for t in self.trajs for s in t.steps])
        return OrchestratorResult(
            makespan=max((t.finish_time for t in self.trajs), default=0.0),
            preemptions=self.preemptions,
            migrations=self.migrations,
            queue_delay_mean=float(delays.mean()) if len(delays) else 0.0,
            queue_delay_p99=float(np.quantile(delays, 0.99)) if len(delays) else 0.0,
            trajectories=self.trajs,
            events=self.events,
            trace=self.trace,
            timeline=self.timeline,
            worker_deaths=self.worker_deaths,
            recoveries=self.recoveries,
            tool_retries=sum(t.tool_retries for t in self.trajs),
            injected_tool_faults=sum(t.injected_tool_faults for t in self.trajs),
            arrivals=self.arrivals,
            admitted=self.admitted,
            shed=self.shed_count,
            deferred=self.deferred,
            degraded=self.degraded,
            peak_live_global=(self.controller.peak_global_count
                              if self.cfg.open_loop and self.controller
                              is not None else 0),
            peak_live_worker=(self.controller.peak_worker_count
                              if self.cfg.open_loop and self.controller
                              is not None else 0),
            tenant_report=(self.controller.tenant_report()
                           if self.cfg.open_loop and self.controller is not None
                           else {}),
            sanitizer=sanitizer_report,
        )
