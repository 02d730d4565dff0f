"""Real-engine rollout runtime = orchestrator + RolloutWorker backend.

``RolloutRuntime`` runs full agentic trajectories — generate → tool call →
absorb → repeat — on the real slot-pool data plane (``engine.worker``,
``engine.fleet``), under the same canonical control loop the simulator uses:
``core.orchestrator.Orchestrator`` driving an ``engine.backends.EngineBackend``.
This module contributes the *engine-side wiring*, not an event loop of its own
(the former twin loop is gone):

  * workload helpers — ``miniaturize`` (paper-scale plans → engine scale, tail
    and tool/gen ratio preserving), ``synth_prompts``, ``build_workbench``;
  * ``ToolEnvironment`` — deterministic tool backend (paper §3 'Tool Manager'):
    plan-driven outcomes, per-``(traj, step)``-seeded token ids *and* sampled
    latencies, so results never depend on backend or invocation order;
  * ``make_runtime`` / ``run_on_sim`` — identical controller wiring for the
    real fleet and for its analytic twin (the decision-trace parity pair);
  * ``calibrate()`` / ``reconfigure()`` — the §6 feedback loop: measured decode
    timing refits the latency model, Algorithm 2 re-provisions, and the fleet
    split/merges between runs.

Time is a **virtual event clock**: decoded tokens are real (real model, real
KV lanes, real sampling keys), but each decode quantum of ``q`` tokens at batch
``b`` costs ``q * token_time * F(b)`` virtual seconds and tool calls cost their
workload-sampled latencies.  That keeps end-to-end makespans deterministic,
hardware-independent, and long-tail-faithful while the data plane does the
actual token work.  See docs/runtime.md for the orchestrator/backend contract
and the lifecycle (PENDING → GENERATING → TOOL_CALL → MIGRATING → FINISHED).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.controller import HeddleController
from repro_torch.core.faults import FaultPlan, RetryPolicy, resolve_tool_call
from repro_torch.core.orchestrator import Orchestrator, OrchestratorConfig, OrchestratorResult
from repro_torch.core.tenancy import ServingConfig
from repro_torch.core.trajectory import Trajectory
from repro_torch.engine.backends import EngineBackend, SimBackend
from repro_torch.engine.fleet import FleetSpec, RolloutFleet
from repro_torch.engine.tools import TOOL_PROFILES, ToolProfile
from repro_torch.engine.worker import RolloutWorker
from repro_torch.engine.workload import TrajectoryPlan


# ---------------------------------------------------------------- configuration

@dataclass(frozen=True)
class RuntimeConfig:
    scheduler: str = "pps"               # pps | fcfs | rr | sjf (per-worker queues)
    migration: bool = True               # tool-interval KV migration (§5.3)
    max_active: int = 4                  # decode-concurrency slots per worker
    quantum: int = 8                     # decode tokens per scheduling quantum
    token_time: float = 0.02             # virtual s/token at batch 1 (per worker)
    kv_weight_ratio: float = 0.02        # interference F(b) = 1 + r * b
    prefill_speedup: float = 100.0       # prefill token cost vs decode token cost
    link_bandwidth: float = 2e9          # virtual migration link (bytes/s)
    tool_latency_scale: float = 1.0      # scales the workload's sampled latencies
    # preemption hysteresis applied to preemptive schedulers (PPS): progressive
    # predictions are noisy early in a trajectory, and at that stage every
    # low-margin preemption is a coin flip that only adds requeue delay — raise
    # these when the batch is heavily oversubscribed (units: predicted tokens)
    preemption_margin: float = 1.0
    preemption_floor: float = 2.0
    trace: bool = False                  # record the decision trace (parity harness)
    sanitize: bool = False               # validate the decision stream
                                         # (repro_torch.analysis.sanitize.TraceSanitizer)
    seed: int = 0
    checkpoint_dir: str | None = None    # persist tool-boundary checkpoints here
    open_loop: bool = False              # serve arrival-stamped trajectories
                                         # (submit_time) instead of a t=0 batch
    paged: bool | None = None            # paged-KV data plane (None = auto: on
                                         # whenever model.supports_paged_kv)
    page_size: int = 16                  # KV tokens per physical block


@dataclass
class RuntimeResult:
    makespan: float                      # virtual seconds to drain the batch
    total_tokens: int                    # real tokens decoded across all workers
    throughput: float                    # tokens per virtual second
    preemptions: int
    migrations: int
    queue_delay_mean: float              # over per-step queue delays
    queue_delay_p99: float
    trajectories: list[Trajectory] = field(default_factory=list)
    worker_stats: dict[int, dict] = field(default_factory=dict)
    wall_time: float = 0.0               # real seconds spent end to end
    events: int = 0
    degrees: list[int] = field(default_factory=list)  # fleet MP degrees (§6)
    trace: list[tuple[str, int, int]] = field(default_factory=list)
    # chaos telemetry (all zero on a fault-free run)
    worker_deaths: int = 0
    recoveries: int = 0
    tool_retries: int = 0
    injected_tool_faults: int = 0
    # serving telemetry (all zero/empty on a closed-loop run)
    arrivals: int = 0
    admitted: int = 0
    shed: int = 0
    deferred: int = 0
    degraded: int = 0
    peak_live_global: int = 0
    peak_live_worker: int = 0
    tenant_report: dict = field(default_factory=dict)
    sanitizer: dict = field(default_factory=dict)  # TraceSanitizer report ({} = off)


@dataclass
class ToolResult:
    latency: float
    failed: bool                         # plan-driven task outcome (rectification)
    output_tokens: list[int]
    terminal: bool = False
    attempts: int = 1                    # chaos layer: >1 = retries absorbed faults
    injected_faults: int = 0             # chaos layer: injected timeouts + errors


class ToolEnvironment:
    """Deterministic simulated tool backend (paper §3 'Tool Manager', elastic FaaS).

    Plan-driven outcomes — latency, failure, output size — come from the
    trajectory's pre-rolled ``TrajectoryPlan`` (``engine.workload``
    distributions, Table 1 latency calibration).  Everything stochastic the
    environment produces itself — output token *ids*, and sampled latencies for
    plan-less trajectories — is drawn from an rng seeded by
    ``(seed, traj_id, step)``: the same trajectory sees the same tool behavior
    regardless of which backend runs it or in what order steps across the batch
    interleave (the per-call-sequence rng this replaced broke exactly that).
    """

    def __init__(self, seed: int = 0, latency_scale: float = 1.0,
                 vocab: tuple[int, int] = (5, 105),
                 profile: ToolProfile | None = None, *,
                 faults: FaultPlan | None = None,
                 retry: RetryPolicy = RetryPolicy()):
        self.seed = seed
        self.latency_scale = latency_scale
        self.vocab = vocab
        self.profile = profile
        self.faults = faults
        self.retry = retry
        self.invocations = 0
        self.total_latency = 0.0

    def _rng(self, traj_id: int, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, traj_id, step))

    def sample_latency(self, traj_id: int, step: int) -> float:
        """Profile-sampled latency, seeded per (traj, step) — order-independent."""
        profile = self.profile or TOOL_PROFILES["math"]
        return float(profile.sample_latency(self._rng(traj_id, step))) \
            * self.latency_scale

    def invoke(self, traj: Trajectory, step: int) -> ToolResult:
        plan: TrajectoryPlan = traj.payload
        lat = float(plan.tool_latency[step]) * self.latency_scale
        n_out = int(plan.tool_output_tokens[step])
        toks = [int(t) for t in self._rng(traj.traj_id, step).integers(
            *self.vocab, n_out)]
        # injected system faults stretch latency via the retry discipline but
        # never touch the plan-driven outcome (failed / output tokens)
        trace = resolve_tool_call(self.faults, self.retry, traj.traj_id, step, lat)
        self.invocations += 1
        self.total_latency += trace.latency
        return ToolResult(trace.latency, bool(plan.tool_failed[step]), toks,
                          attempts=trace.attempts,
                          injected_faults=trace.injected_faults)

    def step_outcome(self, traj: Trajectory, step: int, gen_tokens: list[int],
                     context: list[int]) -> ToolResult:
        """The EngineBackend environment hook: roll the step's tool + terminality.

        The terminal step's tool ends the episode: its plan outcome is recorded
        for predictor-feature parity (harvest replays it too) but the
        environment is never invoked — no tool actually runs.  A degraded
        trajectory's tightened ``step_cap`` terminates ahead of the plan; the
        check is ordered identically to ``SimBackend.tool_submit`` so fault
        injection stays bit-equal across backends."""
        plan: TrajectoryPlan = traj.payload
        if (traj.step_cap is not None and step + 1 >= traj.step_cap) \
                or step + 1 >= plan.num_steps:
            return ToolResult(float(plan.tool_latency[step]) * self.latency_scale,
                              bool(plan.tool_failed[step]),
                              [0] * int(plan.tool_output_tokens[step]),
                              terminal=True)
        return self.invoke(traj, step)


# ---------------------------------------------------------------- workload helpers

def miniaturize(trajectories: list[Trajectory], *, max_steps: int | None = None,
                max_total_tokens: int = 48, max_prompt: int = 12,
                max_tool_tokens: int = 6, min_step_tokens: int = 2
                ) -> list[Trajectory]:
    """Rescale a paper-scale workload onto the real reduced-model engine.

    ``engine.workload.generate`` rolls plans at paper magnitudes (8K-token
    medians, 40K tails) that a reduced CPU model cannot decode; this maps every
    plan's token counts into engine range *multiplicatively* — one shared scale
    factor per quantity — so the lognormal long-tail shape (the thing the
    scheduler is being evaluated on) survives the shrink.  Tool latencies shrink
    by the *same* factor as generation tokens: a step's generation time is
    ``tokens * token_time``, so scaling both keeps the paper's tool/generation
    time ratio (Table 1 latencies vs ~420-token steps, ≈0.05) — leaving
    latencies at full scale would park every trajectory in tool calls and erase
    the slot contention trajectory-level scheduling exists to manage.  Plans are
    optionally truncated to ``max_steps`` agentic steps first (note the
    truncation itself flattens the step-count tail — benchmarks that evaluate
    long-tail scheduling should leave it None).  Mutates in place.
    """
    n_steps = {t.traj_id: (len(t.payload.gen_tokens) if max_steps is None
                           else min(len(t.payload.gen_tokens), max_steps))
               for t in trajectories}
    peak_total = max(sum(t.payload.gen_tokens[:n_steps[t.traj_id]])
                     for t in trajectories)
    peak_prompt = max(t.prompt_tokens for t in trajectories)
    peak_tool = max((o for t in trajectories
                     for o in t.payload.tool_output_tokens[:n_steps[t.traj_id]]),
                    default=1)
    g_scale = max_total_tokens / max(peak_total, 1)
    p_scale = max_prompt / max(peak_prompt, 1)
    o_scale = max_tool_tokens / max(peak_tool, 1)
    for t in trajectories:
        p: TrajectoryPlan = t.payload
        n = n_steps[t.traj_id]
        gen = [max(min_step_tokens, round(g * g_scale)) for g in p.gen_tokens[:n]]
        touts = [max(1, round(o * o_scale)) for o in p.tool_output_tokens[:n]]
        fail = list(p.tool_failed[:n])
        fail[-1] = False                 # terminal step's tool ends the episode
        lat = [x * g_scale for x in p.tool_latency[:n]]
        t.payload = TrajectoryPlan(gen, lat, fail, touts)
        t.prompt_tokens = max(4, round(t.prompt_tokens * p_scale))
        t.context_tokens = t.prompt_tokens
        t.true_total_tokens = sum(gen)
        t.true_num_steps = n
    return trajectories


def synth_prompts(trajectories: list[Trajectory], seed: int = 0,
                  vocab: tuple[int, int] = (5, 105)) -> dict[int, list[int]]:
    """Deterministic prompt token ids; GRPO siblings (same prompt_id) share ids,
    so co-placed groups exercise the engine's radix-cache prefix implants."""
    prompts: dict[int, list[int]] = {}
    for t in trajectories:
        rng = np.random.default_rng((seed, t.prompt_id))
        prompts[t.traj_id] = [int(x) for x in rng.integers(*vocab, t.prompt_tokens)]
    return prompts


def required_capacity(trajectories: list[Trajectory]) -> int:
    """Max lane occupancy any trajectory can reach: prompt + all gen + all tool."""
    return max(t.prompt_tokens + t.payload.total_tokens
               + sum(t.payload.tool_output_tokens) for t in trajectories)


def build_workbench(task: str = "coding", n_prompts: int = 6, group_size: int = 4,
                    seed: int = 0, *, base_steps: float = 3.0,
                    max_steps: int | None = None, max_total_tokens: int = 96,
                    max_prompt: int = 12, max_tool_tokens: int = 6,
                    min_step_tokens: int = 1, hist_prompts: int = 24):
    """Miniaturized long-tail batch + a predictor fitted on a disjoint history.

    The predictor trains on a *replayed* history workload at the same miniature
    scale the runtime decodes at — same contract as the paper's harvesting of
    historical trajectories, so predictions land in the units the scheduler
    queues on.  Returns ``(batch, predictor)``.
    """
    from repro_torch.core.predictor import ProgressivePredictor
    from repro_torch.engine.workload import WorkloadConfig, generate, replay_finished
    mini = dict(max_steps=max_steps, max_total_tokens=max_total_tokens,
                max_prompt=max_prompt, max_tool_tokens=max_tool_tokens,
                min_step_tokens=min_step_tokens)
    wl = dict(task=task, group_size=group_size, base_steps=base_steps)
    hist = replay_finished(miniaturize(
        generate(WorkloadConfig(n_prompts=hist_prompts, seed=seed + 10_000, **wl)),
        **mini))
    predictor = ProgressivePredictor().fit_trajectories(hist)
    batch = miniaturize(
        generate(WorkloadConfig(n_prompts=n_prompts, seed=seed, **wl)), **mini)
    return batch, predictor


def _make_controller(predictor, config: RuntimeConfig, spec: FleetSpec, *,
                     migration_load_gap: int = 1, migration_cooldown_steps: int = 1,
                     rank_hysteresis: float = 0.2,
                     serving: "ServingConfig | None" = None) -> HeddleController:
    """One controller construction for the real fleet AND its analytic twin.

    Gates default to small-cluster values (load gap 1, short cooldown): at a
    few workers and a few dozen live trajectories, the simulator-scale defaults
    never see a gap wide enough to open.  Heterogeneous fleets usually want a
    wider gap (the controller weighs loads in fast-worker equivalents, so a
    1-equivalent imbalance is within rounding of a single resident)."""
    from repro_torch.core.controller import HeddleConfig
    from repro_torch.core.placement import InterferenceModel
    from repro_torch.core.resource_manager import WorkerLatencyModel
    return HeddleController(
        predictor, InterferenceModel.analytic(config.kv_weight_ratio),
        WorkerLatencyModel(t1=config.token_time), gpu_budget=spec.budget,
        config=HeddleConfig(scheduler=config.scheduler, adaptive_resources=False,
                            migration=config.migration,
                            migration_load_gap=migration_load_gap,
                            migration_cooldown_steps=migration_cooldown_steps,
                            rank_hysteresis=rank_hysteresis,
                            serving=serving if serving is not None
                            else ServingConfig()),
        max_workers=spec.n_workers)


def make_runtime(cfg, params, batch: list[Trajectory], predictor,
                 n_workers: int = 2, config: RuntimeConfig = RuntimeConfig(), *,
                 fleet: FleetSpec | None = None, capacity: int | None = None,
                 migration_load_gap: int = 1, migration_cooldown_steps: int = 1,
                 rank_hysteresis: float = 0.2, temperature: float = 0.8,
                 device=None, faults: FaultPlan | None = None,
                 retry: RetryPolicy = RetryPolicy(),
                 serving: ServingConfig | None = None) -> "RolloutRuntime":
    """Wire controller + real worker fleet + tool environment into a RolloutRuntime.

    ``fleet`` is the per-worker MP degree spec (§6); omitted, it defaults to a
    homogeneous mp=1 fleet of ``n_workers``.  A non-trivial spec prices each
    worker's virtual decode clock through the controller's
    ``WorkerLatencyModel``, so long-tail partitions land on the high-MP
    workers.  Every worker runs on ``device`` (``None`` means the card, and
    raises where there is none; pass ``device="cpu"`` for the CPU).
    """
    from repro_torch.engine.sampler import SamplerConfig
    spec = fleet if fleet is not None else FleetSpec.homogeneous(n_workers)
    controller = _make_controller(predictor, config, spec,
                                  migration_load_gap=migration_load_gap,
                                  migration_cooldown_steps=migration_cooldown_steps,
                                  rank_hysteresis=rank_hysteresis,
                                  serving=serving)
    cap = max(capacity or 0, required_capacity(batch))
    if max(spec.degrees) > 1:            # the JAX package's rounding: lanes shard on the
                                         # model axis there, and equal lanes price equally
        cap = -(-cap // max(spec.degrees)) * max(spec.degrees)
    fleet_obj = RolloutFleet(cfg, params, spec, capacity=cap,
                             max_slots=len(batch),
                             sampler=SamplerConfig(temperature=temperature),
                             seed=config.seed, device=device,
                             paged=config.paged, page_size=config.page_size)
    env = ToolEnvironment(seed=config.seed,
                          latency_scale=config.tool_latency_scale,
                          faults=faults, retry=retry)
    return RolloutRuntime(fleet_obj, controller, batch, env, config,
                          faults=faults)


def make_sim_components(predictor, n_workers: int = 2,
                        config: RuntimeConfig = RuntimeConfig(), *,
                        fleet: FleetSpec | None = None,
                        migration_load_gap: int = 1,
                        migration_cooldown_steps: int = 1,
                        rank_hysteresis: float = 0.2,
                        prompt_lens: dict[int, int] | None = None,
                        faults: FaultPlan | None = None,
                        retry: RetryPolicy = RetryPolicy(),
                        serving: ServingConfig | None = None):
    """Controller + engine-parity ``SimBackend`` pair — ``run_on_sim``'s wiring,
    reusable by anything that drives the orchestrator itself (the streaming
    service plane builds on this).  Returns ``(backend, controller)``.
    """
    spec = fleet if fleet is not None else FleetSpec.homogeneous(n_workers)
    controller = _make_controller(predictor, config, spec,
                                  migration_load_gap=migration_load_gap,
                                  migration_cooldown_steps=migration_cooldown_steps,
                                  rank_hysteresis=rank_hysteresis,
                                  serving=serving)
    controller.degrees = list(spec.degrees)
    lat = controller.latency
    token_times = [config.token_time * lat.base_token_time(mp)
                   / lat.base_token_time(1) for mp in spec.degrees]
    backend = SimBackend(
        list(spec.degrees), token_times, controller.interference,
        prefill_speedup=config.prefill_speedup,
        link_bandwidth=config.link_bandwidth,
        latency_scale=config.tool_latency_scale,
        quantum=config.quantum, prompt_lens=prompt_lens,
        faults=faults, retry=retry,
        # price migrated KV on the page grid iff the engine twin runs paged
        page_size=0 if config.paged is False else config.page_size)
    return backend, controller


def run_on_sim(batch: list[Trajectory], predictor, n_workers: int = 2,
               config: RuntimeConfig = RuntimeConfig(), *,
               fleet: FleetSpec | None = None, migration_load_gap: int = 1,
               migration_cooldown_steps: int = 1, rank_hysteresis: float = 0.2,
               prompt_lens: dict[int, int] | None = None,
               faults: FaultPlan | None = None,
               retry: RetryPolicy = RetryPolicy(),
               serving: ServingConfig | None = None) -> OrchestratorResult:
    """Run a runtime configuration on the analytic twin — no model, no engine.

    Builds the exact controller ``make_runtime`` would and a ``SimBackend`` in
    engine-parity mode (quantized decode priced with the engine's arithmetic,
    admission charged to worker clocks), then drives the shared orchestrator.
    With the same batch, predictor and config — and a latency-dominated or
    infinite migration link — the scheduling/migration decision trace is
    identical to the real engine's, which ``tests/test_orchestrator.py``
    asserts and ``benchmarks/bench_rollout.py --backend sim`` exploits for
    model-free policy sweeps.
    """
    backend, controller = make_sim_components(
        predictor, n_workers, config, fleet=fleet,
        migration_load_gap=migration_load_gap,
        migration_cooldown_steps=migration_cooldown_steps,
        rank_hysteresis=rank_hysteresis, prompt_lens=prompt_lens,
        faults=faults, retry=retry, serving=serving)
    orch = Orchestrator(
        backend, batch,
        OrchestratorConfig(scheduler=config.scheduler, migration=config.migration,
                           max_active=config.max_active,
                           open_loop=config.open_loop,
                           preemption_margin=config.preemption_margin,
                           preemption_floor=config.preemption_floor,
                           trace=config.trace, sanitize=config.sanitize),
        controller=controller, faults=faults)
    return orch.run()


def split_restores(trace: list) -> tuple[list, list]:
    """(``trace`` without its ``restore_done`` events, those events sorted):
    the form in which an engine trace under faults equals its sim twin's.  A
    trajectory that died before its first tool boundary is re-prefilled from
    its prompt, which the engine prices as an admission and the sim as a
    transfer, so only the order of ``restore_done`` events may differ."""
    done = [e for e in trace if e[0] == "restore_done"]
    return [e for e in trace if e[0] != "restore_done"], sorted(done)


# ---------------------------------------------------------------- runtime

class RolloutRuntime:
    """Drives real RolloutWorkers through full agentic trajectories, event-driven.

    The caller supplies the worker fleet — a ``RolloutFleet`` (heterogeneous MP,
    reconfigurable between steps) or a bare worker list — a ``HeddleController``
    with a fitted predictor, the trajectory batch, and an environment exposing
    ``step_outcome`` (plan-driven ``ToolEnvironment`` or a task adapter like
    ``rl.loop.TaskEnvironment``).  ``run()`` builds the EngineBackend +
    Orchestrator pair, executes the batch to completion and returns
    deterministic end-to-end metrics.

    The fleet's per-worker MP degrees are the **single source of truth**: the
    controller's ``degrees`` vector is synced from them here (a pre-set
    conflicting stub raises), and each worker's virtual decode clock is priced
    at ``controller.latency.base_token_time(mp)`` — normalized so an mp=1 worker
    costs exactly ``config.token_time`` per token.
    """

    def __init__(self,
                 workers: list[RolloutWorker] | RolloutFleet,
                 controller: HeddleController,
                 trajectories: list[Trajectory], tool_env,
                 config: RuntimeConfig = RuntimeConfig(),
                 prompts: dict[int, list[int]] | None = None, *,
                 stop_token: int | None = None,
                 step_budget=None,
                 faults: FaultPlan | None = None):
        self.cfg = config
        self.controller = controller
        self.env = tool_env
        self.faults = faults
        self.trajs = list(trajectories)
        self.prompts = prompts if prompts is not None \
            else synth_prompts(self.trajs, seed=config.seed)
        if isinstance(workers, RolloutFleet):
            self.fleet: RolloutFleet | None = workers
            engines = workers.workers
        else:
            self.fleet = None
            engines = list(workers)
        # one authority for MP degrees: the engines themselves (FleetSpec
        # validates the §6.1 descending sort-and-zip order).  A controller
        # arriving with a different pre-set vector is a stale stub — refuse to
        # let it silently mask the real allocation.
        self.spec = FleetSpec(tuple(w.mp for w in engines))
        if controller.degrees and list(controller.degrees) != list(self.spec.degrees):
            raise ValueError(
                f"controller.degrees {controller.degrees} conflicts with the "
                f"fleet's MP degrees {list(self.spec.degrees)}; the fleet spec "
                f"is the single source of truth — drop the manual assignment")
        controller.degrees = list(self.spec.degrees)
        planned = [t for t in self.trajs
                   if isinstance(t.payload, TrajectoryPlan)]
        if planned:
            cap = min(w.capacity for w in engines)
            need = required_capacity(planned)
            if need > cap:
                raise ValueError(f"worker capacity {cap} < max trajectory context "
                                 f"{need}; raise capacity or miniaturize harder")
        self.stop_token = stop_token
        self.step_budget = step_budget
        self.backend = self._make_backend(engines)
        self._orch: Orchestrator | None = None

    # ------------------------------------------------------------ fleet pricing
    def _make_backend(self, engines: list[RolloutWorker]) -> EngineBackend:
        """The ONE place engine pricing + environment are wired, so
        reconfigured fleets never drift from freshly constructed ones."""
        return EngineBackend(
            engines, self.env, self.prompts,
            interference=self.controller.interference,
            quantum=self.cfg.quantum,
            token_times=[self._token_time(w.mp) for w in engines],
            prefill_speedup=self.cfg.prefill_speedup,
            link_bandwidth=self.cfg.link_bandwidth,
            stop_token=self.stop_token, step_budget=self.step_budget,
            checkpoint_dir=self.cfg.checkpoint_dir)

    def _token_time(self, mp: int) -> float:
        """Virtual s/token at batch 1 for MP degree ``mp``.

        Scaled through the controller's latency model and normalized so mp=1
        costs exactly ``config.token_time`` — a homogeneous mp=1 fleet prices
        identically to the pre-heterogeneous runtime."""
        lat = self.controller.latency
        return self.cfg.token_time * lat.base_token_time(mp) / lat.base_token_time(1)

    @property
    def workers(self):
        """Per-worker runtime views (``.wid``, ``.engine``, ``.token_time``)."""
        return self.backend.views

    # ------------------------------------------------------------ run
    def run(self) -> RuntimeResult:
        cfg = self.cfg
        wall0 = time.perf_counter()
        # the fleet spec was synced to the controller at construction; anything
        # that mutated it since (a stale [1]*n stub, a partial reconfigure)
        # would silently misprice placement — fail loudly instead
        if list(self.controller.degrees) != list(self.spec.degrees):
            raise ValueError(
                f"controller.degrees {self.controller.degrees} drifted from the "
                f"fleet spec {list(self.spec.degrees)} between construction and "
                f"run(); reconfigure() is the only sanctioned mutation path")
        self._orch = Orchestrator(
            self.backend, self.trajs,
            OrchestratorConfig(scheduler=cfg.scheduler, migration=cfg.migration,
                               max_active=cfg.max_active,
                               open_loop=cfg.open_loop,
                               preemption_margin=cfg.preemption_margin,
                               preemption_floor=cfg.preemption_floor,
                               max_events=2_000_000, trace=cfg.trace,
                               sanitize=cfg.sanitize),
            controller=self.controller, faults=self.faults)
        res = self._orch.run()
        for view in self.backend.views:              # final telemetry snapshot
            self.controller.record_worker_stats(view.wid,
                                                view.engine.dispatch_stats())
        if cfg.sanitize:
            from repro_torch.analysis.sanitize import (TraceViolationError,
                                                       check_block_conservation)

            leaks = check_block_conservation(self.controller.worker_stats)
            if leaks:
                raise TraceViolationError(leaks, len(leaks))
            if isinstance(res.sanitizer, dict) and res.sanitizer:
                res.sanitizer["block_conservation"] = "ok"
        makespan = res.makespan
        total = self.backend.total_tokens
        return RuntimeResult(
            makespan=makespan,
            total_tokens=total,
            throughput=total / makespan if makespan > 0 else 0.0,
            preemptions=res.preemptions,
            migrations=res.migrations,
            queue_delay_mean=res.queue_delay_mean,
            queue_delay_p99=res.queue_delay_p99,
            trajectories=self.trajs,
            worker_stats=dict(self.controller.worker_stats),
            wall_time=time.perf_counter() - wall0,
            events=res.events,
            degrees=list(self.spec.degrees),
            trace=res.trace,
            worker_deaths=res.worker_deaths,
            recoveries=res.recoveries,
            tool_retries=res.tool_retries,
            injected_tool_faults=res.injected_tool_faults,
            arrivals=res.arrivals,
            admitted=res.admitted,
            shed=res.shed,
            deferred=res.deferred,
            degraded=res.degraded,
            peak_live_global=res.peak_live_global,
            peak_live_worker=res.peak_live_worker,
            tenant_report=res.tenant_report,
            sanitizer=res.sanitizer,
        )

    # ------------------------------------------------------------ §6 feedback loop
    def calibrate(self):
        """Refit the controller's WorkerLatencyModel from measured decode timing.

        Uses the per-worker warm-call decode timing the run streamed through
        ``record_worker_stats`` (``decode_wall_s / decode_timed_steps`` per-step
        samples), so the next provisioning round prices MP degrees from
        observations instead of Fig. 7 constants.  Returns the fitted model
        (None if no timing was recorded)."""
        return self.controller.calibrate_latency()

    def reconfigure(self, spec: FleetSpec | None = None, *,
                    calibrate: bool = True, budget: int | None = None) -> dict:
        """Between-steps reconfiguration: calibrate → provision → split/merge.

        With ``spec=None`` the controller re-runs Algorithm 2 over this batch's
        trajectories (now carrying observed step histories) under the calibrated
        latency model and the fleet executes the resulting split/merge moves
        (``RolloutFleet.reconfigure``: reuse unchanged slots, rebuild changed
        ones, migrate residents across MP degrees).  ``budget`` overrides the
        accelerator budget for this provisioning round — the dynamic case of
        Algorithm 2: a dead worker shrinks the budget, recovered or scaled-up
        capacity grows it, and the fleet re-partitions onto whatever survives
        (specs of a different length than the current fleet are handled —
        retired workers' residents redistribute, new slots join cold).  Only
        legal between runs — the event queue must be drained.  Returns the
        fleet's move report; residents the fleet relocated have their
        trajectory ``worker_id`` re-pointed so the next run resumes them where
        they actually live.
        """
        if self.fleet is None:
            raise ValueError("runtime was built from a bare worker list; "
                             "construct it with a RolloutFleet to reconfigure")
        if self._orch is not None and self._orch._evq:
            raise RuntimeError("reconfigure() during a live run: drain the "
                               "event queue first (call between steps)")
        if calibrate:
            self.controller.calibrate_latency()
        if spec is None:
            was_adaptive = self.controller.config.adaptive_resources
            was_budget = self.controller.gpu_budget
            self.controller.config.adaptive_resources = True
            if budget is not None:
                self.controller.gpu_budget = int(budget)
            try:
                spec = FleetSpec.from_degrees(
                    self.controller.provision(self.trajs))
            finally:
                self.controller.config.adaptive_resources = was_adaptive
                self.controller.gpu_budget = was_budget
        report = self.fleet.reconfigure(spec)
        moves = report.get("moves", {})
        for t in self.trajs:
            if t.traj_id in moves:
                t.worker_id = moves[t.traj_id]
            elif t.worker_id is not None and t.worker_id >= spec.n_workers:
                t.worker_id = None       # stale placement beyond the new fleet
        self.spec = self.fleet.spec
        self.controller.degrees = list(self.spec.degrees)
        self.backend = self._make_backend(self.fleet.workers)
        return report
