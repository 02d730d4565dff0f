"""End-to-end agentic RL training loop: Heddle-orchestrated rollout + GRPO updates
(counterpart of ``repro/rl/loop.py``).

Two rollout planes feed the same GRPO update (paper §2.2):

* **synchronous** (:meth:`HeddleTrainer.train` → :meth:`HeddleTrainer.rollout`)
  — groups of trajectories per prompt, executed on real RolloutWorkers with
  tool calls in the loop, driven by the unified orchestration stack
  (``core.orchestrator`` + ``engine.backends.EngineBackend`` via
  ``RolloutRuntime``): per-worker PPS queues, preemptive execution,
  progressive prediction refresh, prefix-affine placement and tool-interval
  migration — the same control plane the serving path runs, not a side-car
  loop.  Each iteration barriers on the batch makespan; weight sync is a
  bulk republish (``w.params = self.params`` + ``reset_cache()``) between
  iterations.
* **asynchronous** (:meth:`HeddleTrainer.train_async`, docs/training.md) —
  a persistent :class:`~repro_torch.rl.service.RolloutService` streams FINISHED
  trajectories into a bounded :class:`~repro_torch.rl.service.ReplayBuffer` while
  the tail is still decoding; GRPO consumes partial batches of complete,
  at-most-``max_staleness``-epochs-old groups, and each update publishes an
  *in-flight* weight sync — workers cut over individually once their
  resident lanes drain, so every trajectory finishes on the policy that
  admitted it (the ``Trajectory.weight_epoch`` stamp).

Both planes share inference (old-policy logprobs) and the GRPO train step,
and both close the rollout→predictor feedback loop the way the paper harvests
history: finished trajectories are appended to a bounded history and the
``ProgressivePredictor`` is refit on it, so scheduler priorities sharpen as
training progresses (cold start uses a budget prior).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.controller import HeddleConfig, HeddleController
from repro_torch.core.placement import InterferenceModel
from repro_torch.core.predictor import ProgressivePredictor
from repro_torch.core.resource_manager import WorkerLatencyModel
from repro_torch.core.trajectory import Trajectory
from repro_torch.device import resolve_device
from repro_torch.engine.runtime import (
    RolloutRuntime,
    RuntimeConfig,
    RuntimeResult,
    ToolEnvironment,
    ToolResult,
)
from repro_torch.engine.sampler import SamplerConfig
from repro_torch.engine.tools import TOOL_PROFILES
from repro_torch.engine.worker import RolloutWorker
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.rl import data as D
from repro_torch.rl.grpo import GRPOConfig, group_advantages, make_train_step, token_logprobs
from repro_torch.rl.optimizer import AdamW


@dataclass
class RolloutRecord:
    tokens: list[int]
    prompt_len: int
    reward: float
    steps: int


@dataclass
class TrainerConfig:
    group_size: int = 4
    n_workers: int = 2
    max_steps_per_traj: int = 3  # agentic steps (gen -> tool -> gen ...)
    gen_tokens_per_step: int = 8
    max_seq: int = 64
    capacity: int = 96
    lr: float = 5e-4
    seed: int = 0
    # orchestration (the rollout phase runs the full Heddle control plane)
    scheduler: str = "pps"
    max_active: int = 2  # decode-concurrency slots per worker
    quantum: int = 4  # decode tokens per scheduling quantum
    migration: bool = True  # tool-interval KV migration (§5.3)
    token_time: float = 0.02  # virtual s/token (scheduling clock)
    history_cap: int = 512  # finished trajectories kept for refits


class _PriorPredictor:
    """Cold-start prior: a budget-sized total until any rollout history exists."""

    def __init__(self, total_budget: float):
        self.total = float(total_budget)

    def predict(self, traj: Trajectory) -> float:
        return max(self.total - traj.tokens_generated, 0.0)


class TaskEnvironment(ToolEnvironment):
    """Plan-less environment adapter: real task episodes under the orchestrator.

    Terminality and tool outcomes come from the *task*, not a pre-rolled plan:
    the episode ends on EOS, step budget exhaustion, or context-limit pressure;
    a TOOL_CALL token triggers the task's tool (the calculator result tokens,
    teacher-forced into the lane), with latency sampled from the task domain's
    ``ToolProfile`` seeded per ``(traj, step)`` — identical for the same
    trajectory under any backend or scheduling order.  Finished episodes are
    collected as ``RolloutRecord``s for the GRPO update.
    """

    def __init__(
        self,
        tasks: dict[int, D.MathTask],
        prompt_lens: dict[int, int],
        *,
        max_steps: int,
        max_seq: int,
        seed: int = 0,
    ):
        super().__init__(seed=seed, profile=TOOL_PROFILES["math"])
        self.tasks = tasks
        self.prompt_lens = prompt_lens
        self.max_steps = max_steps
        self.max_seq = max_seq
        self.records: dict[int, RolloutRecord] = {}

    def add_task(self, tid: int, task: D.MathTask, prompt_len: int) -> None:
        """Register a task mid-run (the async service injects work as it goes)."""
        self.tasks[tid] = task
        self.prompt_lens[tid] = prompt_len

    def step_outcome(
        self, traj: Trajectory, step: int, gen_tokens: list[int], context: list[int]
    ) -> ToolResult:
        tid = traj.traj_id
        task = self.tasks[tid]
        finished = (
            D.EOS in gen_tokens
            or step + 1 >= self.max_steps
            or len(context) >= self.max_seq - 8
        )
        if finished:
            plen = self.prompt_lens[tid]
            self.records[tid] = RolloutRecord(
                list(context), plen, task.reward(list(context[plen:])), step + 1
            )
            return ToolResult(0.0, False, [], terminal=True)
        if D.TOOL_CALL in gen_tokens:
            lat = self.sample_latency(tid, step)
            self.invocations += 1
            self.total_latency += lat
            # calculator returns the sum token (masked from loss via
            # teacher-forced extend; context grows, trajectory continues)
            return ToolResult(lat, False, task.tool_result_tokens())
        # no tool call: the trajectory thinks on — zero-latency requeue keeps
        # it flowing through the scheduler like any other step boundary
        return ToolResult(0.0, False, [])


class HeddleTrainer:
    """Small-scale but fully real: the port's model, tool loop, Heddle
    orchestration, GRPO.

    ``device=None`` means the card and raises where there is none; pass
    ``device="cpu"`` for the CPU.  ``params`` (a nested dict of tensors, e.g.
    JAX weights carried across with ``repro_torch.params.from_jax``) is moved
    to ``device``; omitted, random params are drawn from ``tcfg.seed``.
    Rollouts and the old-policy forward run under ``torch.no_grad()``; the
    update is functional, so the workers keep the previous policy's tensors
    until the next weight sync.
    """

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig = TrainerConfig(),
                 *, params=None, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.params = (M.init_params(cfg, tcfg.seed, self.device) if params is None
                       else M.tree_to(params, self.device))
        self.opt = AdamW(lr=tcfg.lr)
        self.opt_state = self.opt.init(self.params)
        grpo_cfg = GRPOConfig(group_size=tcfg.group_size)
        self.train_step = make_train_step(cfg, grpo_cfg, self.opt)
        step_budget_total = tcfg.max_steps_per_traj * tcfg.gen_tokens_per_step
        self.predictor = _PriorPredictor(step_budget_total)
        self.controller = HeddleController(
            self.predictor,
            InterferenceModel.analytic(0.02),
            WorkerLatencyModel(t1=tcfg.token_time),
            gpu_budget=tcfg.n_workers,
            config=HeddleConfig(
                scheduler=tcfg.scheduler,
                adaptive_resources=False,
                migration=tcfg.migration,
                migration_load_gap=1,
                migration_cooldown_steps=1,
                rank_hysteresis=0.2,
            ),
            max_workers=tcfg.n_workers,
        )
        self.workers = [
            RolloutWorker(
                cfg,
                self.params,
                capacity=tcfg.capacity,
                worker_id=i,
                sampler=SamplerConfig(temperature=1.0, top_p=0.95),
                seed=tcfg.seed,
                device=self.device,
            )
            for i in range(tcfg.n_workers)
        ]
        self._history: list[Trajectory] = []
        # instance-local trajectory-id base: ids seed per-(traj, step) tool
        # outcomes, so drawing them from the process-global counter would make
        # rollout behavior depend on whatever else ran in this process
        self._tid_base = 0
        self._pid_base = 0  # async plane: prompt ids unique across a service run
        self.last_rollout: RuntimeResult | None = None
        self.step_count = 0

    # ------------------------------------------------------------------ rollout
    def rollout(self, tasks: list[D.MathTask]) -> list[RolloutRecord]:
        tcfg = self.tcfg
        for w in self.workers:
            w.params = self.params  # weight sync (colocated update)
            # drop resident AND retired KV: stale-weight prefixes must never
            # be implanted into post-update admissions
            w.reset_cache()
        trajs: list[Trajectory] = []
        prompts: dict[int, list[int]] = {}
        tasks_by: dict[int, D.MathTask] = {}
        for pid, task in enumerate(tasks):
            ptoks = task.prompt_tokens()
            for g in range(tcfg.group_size):
                t = Trajectory(
                    traj_id=self._tid_base + len(trajs),
                    prompt_id=pid,
                    sample_id=g,
                    prompt_tokens=len(ptoks),
                    context_tokens=len(ptoks),
                )
                trajs.append(t)
                prompts[t.traj_id] = list(ptoks)
                tasks_by[t.traj_id] = task
        self._tid_base += len(trajs)
        env = TaskEnvironment(
            tasks_by,
            {tid: len(p) for tid, p in prompts.items()},
            max_steps=tcfg.max_steps_per_traj,
            max_seq=tcfg.max_seq,
            seed=tcfg.seed,
        )
        rcfg = RuntimeConfig(
            scheduler=tcfg.scheduler,
            migration=tcfg.migration,
            max_active=tcfg.max_active,
            quantum=tcfg.quantum,
            token_time=tcfg.token_time,
            seed=tcfg.seed,
        )
        runtime = RolloutRuntime(
            self.workers,
            self.controller,
            trajs,
            env,
            rcfg,
            prompts=prompts,
            stop_token=D.EOS,
            step_budget=lambda t: tcfg.gen_tokens_per_step,
        )
        with torch.no_grad():
            self.last_rollout = runtime.run()
        self._refit_predictor(trajs)
        return [env.records[t.traj_id] for t in trajs]

    def _refit_predictor(self, trajectories: list[Trajectory]) -> None:
        """Close the §4.1 loop: harvest this rollout, refit, sharpen priorities."""
        for t in trajectories:
            t.true_total_tokens = t.tokens_generated
            t.true_num_steps = t.num_steps
        self._history.extend(trajectories)
        excess = len(self._history) - self.tcfg.history_cap
        if excess > 0:
            del self._history[:excess]
        if len(self._history) >= 2 * self.tcfg.group_size:
            self.predictor = ProgressivePredictor().fit_trajectories(self._history)
            self.controller.predictor = self.predictor

    # ------------------------------------------------------------------ update
    def update(self, records: list[RolloutRecord]) -> dict:
        tcfg = self.tcfg
        tokens, mask = D.pad_batch(
            [r.tokens for r in records],
            [r.prompt_len for r in records],
            tcfg.max_seq,
        )
        rewards = torch.tensor([r.reward for r in records], dtype=torch.float32,
                               device=self.device)
        adv = group_advantages(rewards, tcfg.group_size)
        batch = {
            "tokens": torch.from_numpy(tokens).to(self.device),
            "loss_mask": torch.from_numpy(mask).to(self.device),
            "advantages": adv,
        }
        # old-policy logprobs (inference phase)
        with torch.no_grad():
            logits, _ = M.forward_full(self.cfg, self.params, {"tokens": batch["tokens"]})
            batch["old_logprobs"] = token_logprobs(logits, batch["tokens"])
        del logits
        self.params, self.opt_state, metrics = self.train_step(
            self.params, self.opt_state, batch
        )
        self.step_count += 1
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["mean_reward"] = float(rewards.mean())
        if self.last_rollout is not None:
            metrics["rollout_preemptions"] = float(self.last_rollout.preemptions)
            metrics["rollout_migrations"] = float(self.last_rollout.migrations)
            metrics["rollout_queue_delay_mean"] = self.last_rollout.queue_delay_mean
        return metrics

    def train(
        self, n_iterations: int, tasks_per_iter: int = 4, seed: int = 0
    ) -> list[dict]:
        history = []
        for it in range(n_iterations):
            tasks = D.sample_tasks(tasks_per_iter, seed=seed + it)
            records = self.rollout(tasks)
            metrics = self.update(records)
            history.append(metrics)
        return history

    # ------------------------------------------------------------------ async
    def _spawn_group(
        self, task: D.MathTask, env: TaskEnvironment
    ) -> tuple[list[Trajectory], dict[int, list[int]]]:
        """One GRPO group for ``task``: fresh trajectory + prompt ids, the task
        registered with the persistent environment."""
        tcfg = self.tcfg
        pid = self._pid_base
        self._pid_base += 1
        ptoks = task.prompt_tokens()
        group: list[Trajectory] = []
        prompts: dict[int, list[int]] = {}
        for g in range(tcfg.group_size):
            t = Trajectory(
                traj_id=self._tid_base,
                prompt_id=pid,
                sample_id=g,
                prompt_tokens=len(ptoks),
                context_tokens=len(ptoks),
            )
            self._tid_base += 1
            group.append(t)
            prompts[t.traj_id] = list(ptoks)
            env.add_task(t.traj_id, task, len(ptoks))
        return group, prompts

    def train_async(
        self,
        n_updates: int,
        *,
        groups_per_update: int = 2,
        max_staleness: int = 1,
        backlog_groups: int = 4,
        replay_capacity: int = 64,
        seed: int = 0,
    ) -> list[dict]:
        """Asynchronous training: rollout-as-a-service + staleness-bounded GRPO.

        One persistent fleet streams finished trajectories while the tail is
        still decoding; an update fires as soon as at least one complete,
        fresh-enough group is buffered (a *partial* batch of up to
        ``groups_per_update`` groups), then publishes an in-flight weight sync
        and submits replacement groups to keep the backlog fed.  No update
        ever consumes a trajectory more than ``max_staleness`` epochs older
        than the latest published weights — stale groups are discarded by the
        replay buffer, not trained on.  Returns per-update metrics
        (``staleness``, ``groups_consumed``, ``weight_epoch`` included).
        """
        from repro_torch.rl.service import ReplayBuffer, RolloutService

        tcfg = self.tcfg
        self.last_rollout = None  # sync-plane telemetry must not leak in
        for w in self.workers:
            w.params = self.params  # epoch-0 policy, cold caches
            w.reset_cache()
        env = TaskEnvironment(
            {},
            {},
            max_steps=tcfg.max_steps_per_traj,
            max_seq=tcfg.max_seq,
            seed=tcfg.seed,
        )
        rcfg = RuntimeConfig(
            scheduler=tcfg.scheduler,
            migration=tcfg.migration,
            max_active=tcfg.max_active,
            quantum=tcfg.quantum,
            token_time=tcfg.token_time,
            seed=tcfg.seed,
        )
        spawned = 0
        trajs: list[Trajectory] = []
        prompts: dict[int, list[int]] = {}
        for _ in range(backlog_groups):
            task = D.sample_tasks(1, seed=seed + 10_000 + spawned)[0]
            spawned += 1
            group, p = self._spawn_group(task, env)
            trajs.extend(group)
            prompts.update(p)
        # RolloutRuntime wires the engine backend (pricing, env, prompts) the
        # one sanctioned way; the service then drives the orchestrator itself
        runtime = RolloutRuntime(
            self.workers,
            self.controller,
            trajs,
            env,
            rcfg,
            prompts=prompts,
            stop_token=D.EOS,
            step_budget=lambda t: tcfg.gen_tokens_per_step,
        )
        svc = RolloutService(runtime.backend, self.controller, rcfg)
        svc.submit(trajs)
        buffer = ReplayBuffer(replay_capacity, tcfg.group_size)
        history: list[dict] = []
        with torch.no_grad():  # the rollouts; the update enables grad itself
            for traj in svc.stream():
                buffer.add(traj)
                if len(history) >= n_updates:
                    continue  # target reached: drain the stragglers untrained
                groups = buffer.take(
                    groups_per_update, epoch=svc.epoch, max_staleness=max_staleness
                )
                if not groups:
                    continue
                records = [env.records[t.traj_id] for g in groups for t in g]
                staleness = max(
                    svc.epoch - t.weight_epoch for g in groups for t in g
                )
                metrics = self.update(records)
                metrics["groups_consumed"] = float(len(groups))
                metrics["staleness"] = float(staleness)
                history.append(metrics)
                if len(history) < n_updates:
                    # in-flight sync: residents finish on their admitted policy
                    metrics["weight_epoch"] = float(svc.sync_weights(self.params))
                    for _ in range(len(groups)):  # keep the backlog fed
                        task = D.sample_tasks(1, seed=seed + 10_000 + spawned)[0]
                        spawned += 1
                        group, p = self._spawn_group(task, env)
                        svc.submit(group, p)
            res = svc.close()
        self._refit_predictor(res.trajectories)
        return history
