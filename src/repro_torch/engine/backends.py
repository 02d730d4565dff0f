"""Execution backends for the unified orchestrator (mechanics and cost only).

``core.orchestrator.Orchestrator`` owns the lifecycle state machine, the event
heap, the per-worker scheduler queues, preemption and migration *policy*; the
backends here own *how work advances and what it costs*:

* :class:`SimBackend` — the analytic cost models the discrete-event simulator
  always used (processor-sharing continuous batching, §5.2 interference, MP
  comm terms, the prefix-cache prefill-recompute model).  Interruptible: work
  settles in closed form at any instant, so the simulator scales to 64 workers
  and thousands of 40K-token trajectories.  With ``quantum`` set it instead
  mirrors the engine's quantized pricing exactly — the *engine-parity* mode the
  decision-trace harness runs.

* :class:`EngineBackend` — the real ``RolloutWorker``/``RolloutFleet`` data
  plane: real prefill, real batched decode into KV lanes, mask-flip preemption,
  lane migration with measured package bytes — on a deterministic virtual clock
  (a decode quantum of ``q`` tokens at batch ``b`` costs
  ``q * token_time * F(b)`` virtual seconds).  Non-interruptible: decode is
  quantized, so new arrivals wait for the running quantum.

Both backends price a quantum through :func:`quantum_seconds` and admission
through :func:`admission_seconds`, bit-identical arithmetic — that, plus the
shared orchestrator loop, is what makes sim-vs-engine decision traces equal.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.faults import FaultPlan, RetryPolicy, resolve_tool_call
from repro_torch.core.migration import kv_cache_bytes, migration_time
from repro_torch.core.orchestrator import StepOutcome
from repro_torch.core.trajectory import Trajectory
from repro_torch.engine import tracing
from repro_torch.models import model as M


def quantum_seconds(q: int, token_time: float, interference, batch: int) -> float:
    """Virtual seconds for a ``q``-token decode quantum at batch ``batch``."""
    return q * token_time * float(interference(batch))


def _package_bytes(pkg: dict) -> int:
    """Transfer size of a migration/checkpoint package: its ``logical_bytes``.

    The port's workers stamp every package with the bytes that actually move
    (resident pages + dense lane state, or the whole dense lane), equal to the
    JAX worker's; a package without them is refused rather than estimated."""
    n = pkg.get("logical_bytes")
    if n is None:
        raise ValueError("package carries no logical_bytes: cannot price its transfer")
    return int(n)


def admission_seconds(n_tokens: int, token_time: float, prefill_speedup: float) -> float:
    """Virtual seconds to prefill ``n_tokens`` (compute-bound vs decode)."""
    return n_tokens * token_time / prefill_speedup


# ---------------------------------------------------------------- simulator backend


class _SimWorker:
    """Processor-sharing continuous-batching cost model for one worker."""

    def __init__(self, wid: int, mp: int, token_time: float, interference):
        self.wid = wid
        self.mp = mp
        self.token_time = token_time  # t1 * ((1-o)/mp + o): control-plane view
        self.t1: Optional[float] = None  # data-plane comm model (set by SimBackend)
        self.comm_overlap = 0.0
        self.comm_batch_coef = 0.0
        self.ctx_coef = 0.0
        self.interference = interference
        self.active: dict[int, float] = {}  # traj_id -> remaining token-work
        self.trajs: dict[int, Trajectory] = {}
        self.last_update = 0.0
        self.tokens_done = 0.0
        # engine-parity (quantum) mode state
        self.clock = 0.0
        self.plan: Optional[tuple[list[int], int, float, float]] = None

    def rate(self) -> float:
        """Seconds per token-unit for each active trajectory (all advance together).

        Context-weighted interference: one decode step reads the weights once
        plus the KV cache of every resident sequence, so per-token time grows
        with the *total context tokens* in the batch, not just its size."""
        b = len(self.active)
        if b == 0:
            return math.inf
        total_ctx = sum(t.context_tokens for t in self.trajs.values())
        if self.t1 is None:  # control-plane-identical fallback
            return self.token_time * (self.interference(b) + self.ctx_coef * total_ctx)
        o, g = self.comm_overlap, self.comm_batch_coef
        scalable = (self.interference(b) + self.ctx_coef * total_ctx) / self.mp
        comm = (o * (1.0 + g * b)) if self.mp > 1 else 0.0
        return self.t1 * (
            (1.0 - o) * scalable + comm + (o / self.mp if self.mp == 1 else 0.0)
        )

    def settle(self, now: float) -> list[int]:
        """Progress all active trajectories to ``now``; pop + return finished."""
        dt = now - self.last_update
        self.last_update = now
        if not self.active or dt <= 0:
            return []
        progressed = dt / self.rate()
        done = []
        for tid in list(self.active):
            self.active[tid] -= progressed
            self.tokens_done += progressed
            if self.active[tid] <= 1e-9:
                done.append(tid)
                del self.active[tid]
                self.trajs.pop(tid, None)
        return done

    def horizon(self, now: float) -> Optional[float]:
        if not self.active:
            return None
        return now + max(min(self.active.values()), 0.0) * self.rate()


class SimBackend:
    """Analytic execution backend (the simulator's cost models, orchestrated).

    Default mode is the paper-scale processor-sharing model: interruptible
    closed-form settlement, prefill recompute on cache miss, analytic KV bytes
    for migration.  With ``quantum`` set the backend becomes the engine's
    *parity twin*: non-interruptible quantized decode priced with the exact
    arithmetic ``EngineBackend`` uses, admission charged to worker clocks, step
    work equal to plan generation tokens — same decisions, no model.
    """

    def __init__(
        self,
        degrees: Sequence[int],
        token_times: Sequence[float],
        interference,
        *,
        t1: Optional[float] = None,
        comm_overlap: float = 0.0,
        comm_batch_coef: float = 0.0,
        ctx_interference: float = 0.0,
        prefill_speedup: float = 100.0,
        measured_reuse_rate: Optional[float] = None,
        link_bandwidth: float = 50e9,
        kv_layers: int = 40,
        kv_heads: int = 8,
        kv_head_dim: int = 128,
        latency_scale: float = 1.0,
        quantum: Optional[int] = None,
        prompt_lens: Optional[dict[int, int]] = None,
        faults: Optional[FaultPlan] = None,
        retry: RetryPolicy = RetryPolicy(),
        page_size: int = 0,
    ):
        self.quantum = quantum
        self.faults = faults
        self.retry = retry
        self.interruptible = quantum is None
        self.interference = interference
        self.prefill_speedup = prefill_speedup
        self.measured_reuse_rate = measured_reuse_rate
        self.link_bandwidth = link_bandwidth
        self.kv_layers = kv_layers
        self.kv_heads = kv_heads
        self.kv_head_dim = kv_head_dim
        self.latency_scale = latency_scale
        # paged-KV twin: price migrated KV as resident *pages* (context rounded
        # up to the page grid), matching the engine's logical_bytes accounting.
        # 0 = dense lanes (exact context bytes, the pre-paging model).
        self.page_size = page_size
        self.prompt_lens = prompt_lens
        self.workers = [
            _SimWorker(i, mp, tt, interference)
            for i, (mp, tt) in enumerate(zip(degrees, token_times))
        ]
        if quantum is None:
            for w in self.workers:
                w.t1 = t1
                w.comm_overlap = comm_overlap
                w.comm_batch_coef = comm_batch_coef
                w.ctx_coef = ctx_interference
        self.suspended: dict[int, float] = {}  # preempted traj -> remaining work
        self.cache_home: dict[int, set[int]] = {}  # traj -> workers with its cache
        self.prompt_home: dict[int, set[int]] = {}  # prompt -> workers with its prompt
        self.miss_tokens = 0
        self.staged_epoch = 0  # latest weight epoch published to the fleet
        self._gen_time: dict[int, float] = {}

    @property
    def n_workers(self) -> int:
        return len(self.workers)

    # ------------------------------------------------------------ admission
    def admit(self, trajectories: Sequence[Trajectory], now: float = 0.0) -> None:
        if self.quantum is None:
            return  # paper mode prices prefill per step (cache model)
        for t in trajectories:
            w = self.workers[t.worker_id]
            n = (
                self.prompt_lens[t.traj_id]
                if self.prompt_lens is not None
                else t.prompt_tokens
            )
            # open loop: an idle clock can lag the arrival instant — prefill
            # starts at max(clock, now).  Closed loop (now=0) is unchanged.
            w.clock = max(w.clock, now) + admission_seconds(
                n, w.token_time, self.prefill_speedup
            )

    def ready_time(self, wid: int, now: float) -> float:
        return max(now, self.workers[wid].clock) if self.quantum else now

    # ------------------------------------------------------------ step mechanics
    def _step_work(self, traj: Trajectory) -> float:
        """Token-work for the upcoming step: generation + prefill recompute.

        Prefix-cache accounting: a worker holding the trajectory's own cache
        pays only the new tool output; a worker that has served any *group
        sibling* holds the shared prompt prefix (radix-cache reuse), so a fresh
        arrival there pays context - prompt, scaled by the engine's measured
        reuse rate when available."""
        plan = traj.payload
        gen = plan.gen_tokens[traj.num_steps]
        if self.quantum is not None:
            return float(gen)  # engine parity: admission paid at the clock
        wid = traj.worker_id
        if wid in self.cache_home.get(traj.traj_id, set()):
            prefill = (
                traj.steps[-1].tool_output_tokens if traj.steps else traj.prompt_tokens
            )
        elif wid in self.prompt_home.get(traj.prompt_id, set()):
            rate = self.measured_reuse_rate
            reusable = traj.prompt_tokens if rate is None else rate * traj.prompt_tokens
            prefill = max(traj.context_tokens - reusable, traj.prompt_tokens // 8)
            self.miss_tokens += int(prefill)
        else:
            prefill = traj.context_tokens or traj.prompt_tokens
            self.miss_tokens += int(prefill)
        return gen + prefill / self.prefill_speedup

    def dispatch(self, wid: int, traj: Trajectory, fresh: bool) -> float:
        w = self.workers[wid]
        tid = traj.traj_id
        work = self._step_work(traj) if fresh else self.suspended.pop(tid)
        w.active[tid] = work
        w.trajs[tid] = traj
        if self.quantum is None:
            self.cache_home.setdefault(tid, set()).add(wid)
            self.prompt_home.setdefault(traj.prompt_id, set()).add(wid)
        return work

    def preempt(self, wid: int, traj: Trajectory) -> None:
        w = self.workers[wid]
        self.suspended[traj.traj_id] = w.active.pop(traj.traj_id)
        w.trajs.pop(traj.traj_id, None)

    def advance(self, wid: int, now: float) -> list[int]:
        w = self.workers[wid]
        if self.quantum is None:
            return w.settle(now)
        if w.plan is None or now < w.plan[2] - 1e-12:
            return []
        ids, q, end, dt = w.plan
        w.plan = None
        w.clock = end
        done = []
        for tid in ids:
            w.active[tid] -= q
            w.tokens_done += q
            self._gen_time[tid] = self._gen_time.get(tid, 0.0) + dt
            if w.active[tid] <= 0:
                done.append(tid)
                del w.active[tid]
                w.trajs.pop(tid, None)
        return done

    def next_completion(self, wid: int, now: float) -> Optional[float]:
        w = self.workers[wid]
        if not w.active:
            w.plan = None
            return None
        if self.quantum is None:
            return w.horizon(now)
        ids = sorted(w.active)
        q = min(self.quantum, int(min(w.active[t] for t in ids)))
        dt = quantum_seconds(q, w.token_time, self.interference, len(ids))
        end = max(now, w.clock) + dt
        w.plan = (ids, q, end, dt)
        return end

    # ------------------------------------------------------------ tools / migration
    def tool_submit(self, traj: Trajectory) -> StepOutcome:
        plan = traj.payload
        s = traj.num_steps
        lat = float(plan.tool_latency[s]) * self.latency_scale
        # step_cap first: a degraded trajectory ends at its tightened budget
        # regardless of the plan — the engine's step_outcome orders the check
        # identically, so injection arithmetic stays bit-equal across backends
        terminal = (traj.step_cap is not None and s + 1 >= traj.step_cap) \
            or s + 1 >= plan.num_steps
        attempts, injected = 1, 0
        if not terminal:
            # identical injection arithmetic to ToolEnvironment.invoke (terminal
            # steps run no tool on either backend, so nothing to inject there)
            trace = resolve_tool_call(self.faults, self.retry, traj.traj_id, s, lat)
            lat, attempts, injected = trace.latency, trace.attempts, trace.injected_faults
        return StepOutcome(
            gen_tokens=int(plan.gen_tokens[s]),
            terminal=terminal,
            tool_latency=lat,
            tool_failed=bool(plan.tool_failed[s]),
            tool_output_tokens=int(plan.tool_output_tokens[s]),
            gen_time=self._gen_time.pop(traj.traj_id, 0.0),
            tool_attempts=attempts,
            tool_injected_faults=injected,
        )

    def tool_absorb(self, traj: Trajectory) -> None:
        pass  # context growth is tracked on the Trajectory itself

    def can_migrate(self, traj: Trajectory) -> bool:
        return True

    def _paged_ctx(self, ctx: int) -> int:
        """Round a context up to the page grid when pricing paged transfers."""
        if self.page_size <= 0:
            return ctx
        return -(-ctx // self.page_size) * self.page_size

    def migrate_out(self, traj: Trajectory, dst: int) -> float:
        kv = kv_cache_bytes(
            self._paged_ctx(traj.context_tokens),
            self.kv_layers, self.kv_heads, self.kv_head_dim,
        )
        return migration_time(kv, self.link_bandwidth)

    def migrate_in(self, traj: Trajectory, dst: int) -> None:
        self.cache_home[traj.traj_id] = {dst}  # the KV moved with the trajectory

    def release(self, traj: Trajectory) -> None:
        # shed-from-queue cleanup: a preempted victim leaves suspended work
        self.suspended.pop(traj.traj_id, None)
        self._gen_time.pop(traj.traj_id, None)

    def stats(self, wid: int) -> dict:
        return {}  # nothing measured: the cost model *is* the assumption

    # ------------------------------------------------------------ failure realism
    def checkpoint(self, traj: Trajectory) -> None:
        pass  # analytic state: the Trajectory record IS the tool-boundary snapshot

    def restore(self, traj: Trajectory, dst: int) -> float:
        """Re-admit from the last tool boundary: price the KV re-materialization
        as a transfer of the boundary context (the analytic twin of re-implanting
        the engine's host-gathered checkpoint lane)."""
        tid = traj.traj_id
        self.suspended.pop(tid, None)  # partial progress died with the worker
        self._gen_time.pop(tid, None)
        self.cache_home[tid] = {dst}
        kv = kv_cache_bytes(
            self._paged_ctx(max(traj.context_tokens, traj.prompt_tokens)),
            self.kv_layers, self.kv_heads, self.kv_head_dim,
        )
        return migration_time(kv, self.link_bandwidth)

    def kill(self, wid: int) -> None:
        w = self.workers[wid]
        w.active.clear()
        w.trajs.clear()
        w.plan = None
        for homes in self.cache_home.values():  # its KV (and prefixes) are gone
            homes.discard(wid)
        for homes in self.prompt_home.values():
            homes.discard(wid)

    def revive(self, wid: int) -> None:
        pass  # kill() already cleared the state; replacement capacity joins cold

    # ------------------------------------------------------------ weight sync
    def stage_weights(self, params, epoch: int) -> None:
        """The analytic twin holds no tensors: staging records the epoch only
        (the orchestrator's drain fence decides when each worker cuts over)."""
        del params
        self.staged_epoch = epoch

    def sync_weights(self, wid: int, epoch: int) -> None:
        """Cut worker ``wid`` over to ``epoch``: drop its cache/prompt homes so
        no stale-weight prefix ever serves a post-sync admission — the analytic
        twin of the engine's ``reset_cache()``.  Zero residents guaranteed by
        the fence, so no cost model state needs settling."""
        del epoch
        for homes in self.cache_home.values():
            homes.discard(wid)
        for homes in self.prompt_home.values():
            homes.discard(wid)


# ---------------------------------------------------------------- engine backend


class _EngineView:
    """One real worker's runtime view: engine + virtual clock + quantum plan."""

    def __init__(self, wid: int, engine, token_time: float):
        self.wid = wid
        self.engine = engine
        self.token_time = token_time  # virtual s/token at batch 1 AT THIS MP
        self.clock = 0.0  # this worker's virtual time frontier
        self.plan: Optional[tuple[list[int], int, float, float]] = None


def _plan_budget(traj: Trajectory) -> int:
    """Default per-step generation budget: the trajectory plan's next step."""
    return int(traj.payload.gen_tokens[traj.num_steps])


class EngineBackend:
    """Real slot-pool data plane behind the orchestrator's virtual event clock.

    Decoded tokens are real (real model, real KV lanes, real sampling keys);
    time is virtual and deterministic.  The environment decides each step's
    tool outcome and terminality via ``env.step_outcome(traj, step, gen,
    context)`` — plan-driven (``ToolEnvironment``) for workload studies,
    task-driven (``rl.loop.TaskEnvironment``) for RL training, where
    ``stop_token``/``step_budget`` replace the pre-rolled plan.

    Real time is the workers' tracer's (``engine.tracing``): the engines
    must share one, as a fleet's do, or the backend raises.  While it is on,
    the backend stamps when a lane's step becomes runnable (the end of its
    admission, for its first step; the end of ``tool_absorb``, for later
    ones; the end of ``restore``, for a step restarted after a worker died)
    and when a lane is preempted, and the first decode call that includes the lane afterwards
    records the seconds since as a ``wait.step`` or ``wait.preempted``
    sample.  A preemption before the step's first decode keeps the runnable
    stamp.  The virtual clock and every decision are the same either way.
    """

    interruptible = False

    def __init__(
        self,
        engines: Sequence,
        env,
        prompts: dict[int, list[int]],
        *,
        interference,
        quantum: int,
        token_times: Sequence[float],
        prefill_speedup: float = 100.0,
        link_bandwidth: float = 2e9,
        stop_token: Optional[int] = None,
        step_budget: Optional[Callable[[Trajectory], int]] = None,
        checkpoint_dir: Optional[str] = None,
    ):
        for i, w in enumerate(engines):
            if w.worker_id != i:
                raise ValueError(
                    f"worker_id {w.worker_id} at fleet position {i}: the "
                    "orchestrator indexes workers by position"
                )
        self.views = [
            _EngineView(w.worker_id, w, tt) for w, tt in zip(engines, token_times)
        ]
        self.env = env
        self.prompts = prompts
        self.interference = interference
        self.quantum = quantum
        self.prefill_speedup = prefill_speedup
        self.link_bandwidth = link_bandwidth
        self.stop_token = stop_token
        self.step_budget = step_budget if step_budget is not None else _plan_budget
        self.step_remaining: dict[int, int] = {}  # mid-step decode budget
        self._active: list[set[int]] = [set() for _ in self.views]  # decoding now
        self.pending_tool: dict[int, list[int]] = {}  # tool output awaiting absorb
        self.in_transit: dict[int, dict] = {}  # migrating traj -> lane package
        self._step_gen: dict[int, list[int]] = {}  # token ids decoded this step
        self._gen_time: dict[int, float] = {}
        self.total_tokens = 0  # real tokens decoded across all workers
        self.tracer = engines[0].tracer
        if any(e.tracer is not self.tracer for e in engines):
            raise ValueError("the engines hold different tracers: build them with one "
                             "(RolloutWorker(tracer=...)), as a RolloutFleet does")
        # traj -> (sample name, real stamp) until its next decode call
        self._waiting: dict[int, tuple[str, float]] = {}
        # failure realism: tool-boundary checkpoints (host-gathered lane
        # packages in migrate_out format) + dead-worker bookkeeping
        self.checkpoint_dir = checkpoint_dir
        self.ckpts: dict[int, dict] = {}
        self.dead: set[int] = set()
        # tool output absorbed since the last checkpoint: a boundary snapshot
        # pre-dates the absorb, so a restore must replay it into the lane
        self.last_absorb: dict[int, list[int]] = {}
        # in-flight weight sync: staged params by epoch, applied per worker as
        # the orchestrator's drain fence releases each one
        self._staged_params: dict[int, object] = {}

    @property
    def n_workers(self) -> int:
        return len(self.views)

    # ------------------------------------------------------------ admission
    def admit(self, trajectories: Sequence[Trajectory], now: float = 0.0) -> None:
        """Prefill each worker's group up front (lanes are memory; the
        scheduler gates decode *compute*).  Sibling-adjacent order maximizes
        radix-cache implants; admission cost lands on the worker's clock —
        from ``max(clock, now)`` so open-loop arrivals on an idle worker
        start prefilling at the arrival instant (closed loop: now=0)."""
        for view in self.views:
            mine = [t for t in trajectories if t.worker_id == view.wid]
            mine.sort(key=lambda t: (t.prompt_id, t.sample_id))
            for t in mine:
                toks = self.prompts[t.traj_id]
                view.engine.prefill(t.traj_id, toks)
                self._runnable(t.traj_id)
                view.clock = max(view.clock, now) + admission_seconds(
                    len(toks), view.token_time, self.prefill_speedup
                )

    def _runnable(self, tid: int) -> None:
        if self.tracer.on:
            self._waiting[tid] = ("wait.step", tracing.now())

    def ready_time(self, wid: int, now: float) -> float:
        return max(now, self.views[wid].clock)

    # ------------------------------------------------------------ step mechanics
    def dispatch(self, wid: int, traj: Trajectory, fresh: bool) -> float:
        tid = traj.traj_id
        if fresh:
            self.step_remaining[tid] = max(int(self.step_budget(traj)), 1)
            self._step_gen[tid] = []
            self._gen_time[tid] = 0.0
        # the lane is already resident; the next quantum's decode includes it
        self._active[wid].add(tid)
        return float(self.step_remaining[tid])

    def preempt(self, wid: int, traj: Trajectory) -> None:
        """Mask flip: the lane stays resident, ``step_remaining`` persists."""
        self.views[wid].engine.preempt(traj.traj_id)
        self._active[wid].discard(traj.traj_id)
        if self.tracer.on and traj.traj_id not in self._waiting:
            self._waiting[traj.traj_id] = ("wait.preempted", tracing.now())

    def advance(self, wid: int, now: float) -> list[int]:
        view = self.views[wid]
        if view.plan is None or now < view.plan[2] - 1e-12:
            return []
        ids, q, end, dt = view.plan
        view.plan = None
        if self.tracer.on:
            t = tracing.now()
            for tid in ids:
                if tid in self._waiting:
                    name, stamp = self._waiting.pop(tid)
                    self.tracer.sample(name, t - stamp)
        out = view.engine.decode(ids, q, stop_token=self.stop_token)
        view.clock = end
        done = []
        for tid in ids:
            got = out[tid]
            self.total_tokens += len(got)
            self.step_remaining[tid] -= len(got)
            self._step_gen[tid].extend(got)
            self._gen_time[tid] += dt
            stopped = self.stop_token is not None and view.engine.store[tid].finished
            if self.step_remaining[tid] <= 0 or stopped:
                done.append(tid)
                del self.step_remaining[tid]
                self._active[wid].discard(tid)
        return done

    def next_completion(self, wid: int, now: float) -> Optional[float]:
        view = self.views[wid]
        ids = sorted(self._active[wid])
        if not ids:
            view.plan = None
            return None
        q = min(self.quantum, min(self.step_remaining[t] for t in ids))
        dt = quantum_seconds(q, view.token_time, self.interference, len(ids))
        end = max(now, view.clock) + dt
        view.plan = (ids, q, end, dt)
        return end

    # ------------------------------------------------------------ tools / migration
    def tool_submit(self, traj: Trajectory) -> StepOutcome:
        tid = traj.traj_id
        gen = self._step_gen.pop(tid, [])
        context = self.views[traj.worker_id].engine.store[tid].tokens
        out = self.env.step_outcome(traj, traj.num_steps, gen, context)
        if not out.terminal and out.output_tokens:
            self.pending_tool[tid] = list(out.output_tokens)
        return StepOutcome(
            gen_tokens=len(gen),
            terminal=bool(out.terminal),
            tool_latency=float(out.latency),
            tool_failed=bool(out.failed),
            tool_output_tokens=len(out.output_tokens),
            gen_time=self._gen_time.pop(tid, 0.0),
            tool_attempts=int(getattr(out, "attempts", 1)),
            tool_injected_faults=int(getattr(out, "injected_faults", 0)),
        )

    def tool_absorb(self, traj: Trajectory) -> None:
        toks = self.pending_tool.pop(traj.traj_id, None)
        self.last_absorb.pop(traj.traj_id, None)
        if toks:  # chunked prefill into the lane, wherever it lives now
            view = self.views[traj.worker_id]
            view.engine.extend(traj.traj_id, toks)
            self.last_absorb[traj.traj_id] = list(toks)
        self._runnable(traj.traj_id)

    def can_migrate(self, traj: Trajectory) -> bool:
        return traj.traj_id in self.views[traj.worker_id].engine.store

    def migrate_out(self, traj: Trajectory, dst: int) -> float:
        src = self.views[traj.worker_id]
        pkg = src.engine.migrate_out(traj.traj_id)
        self.in_transit[traj.traj_id] = pkg
        return migration_time(_package_bytes(pkg), self.link_bandwidth)

    def migrate_in(self, traj: Trajectory, dst: int) -> None:
        pkg = self.in_transit.pop(traj.traj_id)
        self.views[dst].engine.migrate_in(pkg)  # lane lands in the new pool

    def release(self, traj: Trajectory) -> None:
        """Finished (or shed): the lane retires into the radix cache (prefix
        stays warm).  Shed-from-queue cleanup also drops any mid-step budget
        and parked tool output the trajectory left behind."""
        self.views[traj.worker_id].engine.release(traj.traj_id)
        self.ckpts.pop(traj.traj_id, None)
        self.last_absorb.pop(traj.traj_id, None)
        self.step_remaining.pop(traj.traj_id, None)
        self._step_gen.pop(traj.traj_id, None)
        self._gen_time.pop(traj.traj_id, None)
        self.pending_tool.pop(traj.traj_id, None)
        self._waiting.pop(traj.traj_id, None)

    def stats(self, wid: int) -> dict:
        return self.views[wid].engine.dispatch_stats()

    # ------------------------------------------------------------ failure realism
    def checkpoint(self, traj: Trajectory) -> None:
        """Tool-boundary snapshot: host-gather the lane without evicting it.

        The package is ``migrate_out``'s exact wire format, so recovery is just
        a ``migrate_in`` on a survivor.  With ``checkpoint_dir`` set the cache
        tree is also persisted through ``repro_torch.checkpoint`` (crash-atomic npz +
        manifest) for durability beyond this process."""
        tid = traj.traj_id
        view = self.views[traj.worker_id]
        if tid not in view.engine.store:
            return  # lane already on the wire; the transfer carries the state
        pkg = view.engine.checkpoint_out(tid)
        self.ckpts[tid] = pkg
        self.last_absorb.pop(tid, None)  # the new snapshot includes it
        if self.checkpoint_dir:
            from repro_torch.checkpoint import checkpoint as ckpt

            # paged engines snapshot resident pages + dense state; dense
            # engines a full lane — persist whichever tree the package carries
            kv = ({"cache": pkg["cache"]} if "cache" in pkg
                  else {"pages": pkg["pages"], "state": pkg["state"]})
            extra = {
                "seq_id": int(pkg["seq_id"]),
                "tokens": [int(x) for x in pkg["tokens"]],
                "generated": int(pkg["generated"]),
            }
            if "pages" in pkg:
                extra.update(page_size=int(pkg["page_size"]),
                             capacity=int(pkg["capacity"]),
                             logical_bytes=int(pkg["logical_bytes"]))
            ckpt.save(
                f"{self.checkpoint_dir}/traj_{tid:05d}",
                {**kv, "key": np.asarray(pkg["key"])},
                step=traj.num_steps,
                extra=extra,
            )

    def restore(self, traj: Trajectory, dst: int) -> float:
        """Re-admit on ``dst`` from the last tool-boundary checkpoint.

        Everything decoded since that boundary died with the worker and is
        re-decoded (the step restarts fresh); a trajectory that never reached a
        boundary re-admits from its prompt.  Returns the virtual transfer (or
        re-prefill) seconds the recovery costs."""
        tid = traj.traj_id
        self.step_remaining.pop(tid, None)  # partial step state is gone
        self._step_gen.pop(tid, None)
        self._gen_time.pop(tid, None)
        self.in_transit.pop(tid, None)  # a wire copy to a corpse never lands
        view = self.views[dst]
        pkg = self.ckpts.get(tid)
        if pkg is None:
            toks = self.prompts[tid]
            view.engine.prefill(tid, toks)
            self._runnable(tid)
            return admission_seconds(len(toks), view.token_time, self.prefill_speedup)
        view.engine.migrate_in(dict(pkg))
        extra = self.last_absorb.get(tid)
        if extra:  # tool output absorbed after the snapshot: replay it
            view.engine.extend(tid, extra)
        self._runnable(tid)
        return migration_time(_package_bytes(pkg), self.link_bandwidth)

    def kill(self, wid: int) -> None:
        """Worker death: every resident lane (live + retired prefix cache) is
        lost; pending tool outputs are host-side and survive."""
        view = self.views[wid]
        self.dead.add(wid)
        for tid in list(view.engine.store):
            self.step_remaining.pop(tid, None)
            self._step_gen.pop(tid, None)
            self._gen_time.pop(tid, None)
            self._waiting.pop(tid, None)
        self._active[wid].clear()
        view.plan = None
        view.engine.reset_cache()

    def revive(self, wid: int) -> None:
        """Replacement capacity joins in slot ``wid``: cold cache, same engine
        shell (kill() already dropped every lane and radix ref)."""
        self.dead.discard(wid)

    # ------------------------------------------------------------ weight sync
    def stage_weights(self, params, epoch: int) -> None:
        """Publish new policy weights as ``epoch``: staged host-side, applied
        per worker by ``sync_weights`` once the orchestrator's drain fence
        clears it.  ``params=None`` advances the epoch without new tensors
        (modeled trainers exercising only the control plane)."""
        self._staged_params[epoch] = params

    def sync_weights(self, wid: int, epoch: int) -> None:
        """Cut worker ``wid`` over to ``epoch``: swap the staged params in and
        ``reset_cache()`` — every retired prefix lane decoded under the old
        policy must never seed a post-sync admission.  The fence guarantees the
        worker holds zero resident lanes, so nothing live is destroyed."""
        params = self._staged_params.get(epoch)
        view = self.views[wid]
        if params is not None:
            view.engine.params = M.tree_to(params, view.engine.device)
        # the global target epoch is monotone: once any worker syncs to
        # ``epoch``, no future sync will ask for an older stage
        for stale in [e for e in self._staged_params if e < epoch]:
            del self._staged_params[stale]
        view.engine.reset_cache()
