"""Agentic workload generators reproducing the paper's long-tail statistics (Fig. 2/5).

Each prompt has a latent difficulty; each GRPO sample of that prompt rolls its own
environment feedback (tool failures -> rectification steps), producing the *intra-group
variance* of Fig. 5 that defeats prompt-only length predictors.  The first step's
generation length correlates with difficulty (the "execution plan" semantic anchor of
§4.1), which is what the progressive predictor exploits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.trajectory import StepRecord, Trajectory, make_group
from repro_torch.engine.tools import TOOL_PROFILES, ToolProfile


@dataclass(frozen=True)
class WorkloadConfig:
    task: str = "coding"                  # coding | search | math
    n_prompts: int = 32
    group_size: int = 16                  # GRPO samples per prompt (paper: 16)
    max_output_tokens: int = 40_000       # paper cap
    # Calibrated against the paper's Fig 2 / Fig 4 statistics: median total ~8K tokens,
    # max ~40K (the cap), completion-time max/median ~4x.
    mean_step_tokens: float = 420.0
    difficulty_sigma: float = 0.55        # lognormal spread of latent difficulty
    base_steps: float = 3.0
    seed: int = 0

    @property
    def tool(self) -> ToolProfile:
        return TOOL_PROFILES[self.task]


@dataclass
class TrajectoryPlan:
    """Pre-rolled environment outcome for one trajectory (the simulator's oracle)."""

    gen_tokens: list[int]
    tool_latency: list[float]
    tool_failed: list[bool]
    tool_output_tokens: list[int]

    @property
    def num_steps(self) -> int:
        return len(self.gen_tokens)

    @property
    def total_tokens(self) -> int:
        return sum(self.gen_tokens)


# per-task shape knobs: (steps multiplier, step-token multiplier, step-count spread)
_TASK_SHAPE = {
    "coding": (2.5, 1.2, 1.0),     # many rectification steps, medium generations
    "search": (3.0, 0.4, 0.6),     # many short steps (multi-hop), tool-latency heavy
    "math": (1.8, 0.8, 0.8),       # fewer steps, light tools
}


def generate(config: WorkloadConfig) -> list[Trajectory]:
    """Generate a rollout batch: n_prompts x group_size trajectories with plans."""
    rng = np.random.default_rng(config.seed)
    steps_mult, tok_mult, spread = _TASK_SHAPE[config.task]
    tool = config.tool
    trajectories: list[Trajectory] = []
    for pid in range(config.n_prompts):
        difficulty = rng.lognormal(0.0, config.difficulty_sigma)
        prompt_tokens = int(np.clip(rng.normal(120 + 60 * difficulty, 40), 16, 2048))
        group = make_group(pid, prompt_tokens, config.group_size)
        for traj in group:
            # per-sample environment stochasticity (Fig. 5 intra-group variance)
            sample_luck = rng.lognormal(0.0, 0.6 * spread)
            hardness = difficulty * sample_luck          # only partially prompt-visible
            gen, lat, fail, touts = [], [], [], []
            # Step count is hardness-determined up to modest noise: a hard task *is*
            # visibly hard (its plan, tool outputs and failures reveal it) — the
            # predictability §4.1's progressive refinement relies on.  Failed tool
            # calls (hardness-driven) add rectification steps on top.
            fail_p = min(0.85, tool.fail_rate * (0.4 + 0.6 * hardness))
            base_n = config.base_steps + steps_mult * hardness
            n_steps = int(np.clip(round(rng.lognormal(np.log(base_n), 0.22)), 1, 64))
            total, s = 0, 0
            while True:
                # step 0 is the plan: its size reveals the sample's own complexity
                # (the paper's "strong semantic indicator")
                scale = (0.5 + 0.7 * hardness) if s == 0 else (0.9 + 0.1 * hardness)
                g = int(np.clip(rng.lognormal(
                    np.log(config.mean_step_tokens * tok_mult * scale), 0.35), 8, 8192))
                g = min(g, max(config.max_output_tokens - total, 8))
                total += g
                failed = bool(rng.random() < fail_p)
                if failed:
                    n_steps = min(n_steps + 1, 64)   # rectification extends the episode
                gen.append(g)
                lat.append(float(tool.sample_latency(rng)))
                # tool output size also tracks hardness (longer error logs / search
                # results for harder tasks) — observable runtime signal for §4.1
                touts.append(int(tool.sample_output_tokens(rng, failed)
                                 * (0.7 + 0.35 * hardness)))
                s += 1
                stop = (total >= config.max_output_tokens or s >= n_steps)
                fail.append(failed and not stop)  # terminal step's tool ends the episode
                if stop:
                    break
            traj.payload = TrajectoryPlan(gen, lat, fail, touts)
            traj.true_total_tokens = sum(gen)
            traj.true_num_steps = len(gen)
        trajectories.extend(group)
    return trajectories


# --------------------------------------------------------------------------
# Arrival processes (open-loop ingress).  A closed-loop batch admits
# everything at t=0; a serving front door sees an *arrival process*.  Each
# policy deterministically maps (seed, n) -> n monotone arrival times, which
# the orchestrator turns into ``arrival`` events on its versioned heap.

# Domain-separation constant for arrival rngs (same idiom as the fault layer:
# independent random decision streams must never correlate across subsystems).
_ARRIVAL_STREAM = 4099


@dataclass(frozen=True)
class PoissonArrivals:
    """Memoryless open-loop traffic: i.i.d. exponential inter-arrival gaps."""

    rate: float                       # mean arrivals per virtual second (QPS)
    seed: int = 0

    def times(self, n: int) -> list[float]:
        if self.rate <= 0:
            raise ValueError(f"arrival rate must be > 0, got {self.rate}")
        rng = np.random.default_rng((self.seed, _ARRIVAL_STREAM))
        return np.cumsum(rng.exponential(1.0 / self.rate, size=n)).tolist()


@dataclass(frozen=True)
class BurstyArrivals:
    """Markov-modulated Poisson: a 2-state chain alternates a calm rate and a
    burst rate (``burst_factor`` x), producing the clustered arrivals that
    stress admission control harder than a plain Poisson stream."""

    rate: float                       # *mean* arrivals per virtual second
    seed: int = 0
    burst_factor: float = 4.0         # burst-state rate multiplier
    burst_prob: float = 0.25          # stationary fraction of time in burst state
    switch_prob: float = 0.1          # per-arrival chance of re-drawing the state

    def times(self, n: int) -> list[float]:
        if self.rate <= 0:
            raise ValueError(f"arrival rate must be > 0, got {self.rate}")
        # rates chosen so the stationary mix averages to `rate`
        calm = self.rate * (1.0 - self.burst_prob * self.burst_factor
                            ) / (1.0 - self.burst_prob)
        calm = max(calm, 0.05 * self.rate)
        burst = self.rate * self.burst_factor
        rng = np.random.default_rng((self.seed, _ARRIVAL_STREAM, 1))
        t, out, bursting = 0.0, [], False
        for _ in range(n):
            if rng.random() < self.switch_prob:
                bursting = rng.random() < self.burst_prob
            t += rng.exponential(1.0 / (burst if bursting else calm))
            out.append(t)
        return out


@dataclass(frozen=True)
class DiurnalArrivals:
    """Slow sinusoidal load swing (a compressed day): a non-homogeneous
    Poisson process sampled by Lewis thinning against the peak rate."""

    rate: float                       # mean arrivals per virtual second
    seed: int = 0
    amplitude: float = 0.8            # peak swing as a fraction of `rate`
    period_s: float = 240.0           # one "day" of virtual time

    def times(self, n: int) -> list[float]:
        if self.rate <= 0:
            raise ValueError(f"arrival rate must be > 0, got {self.rate}")
        rng = np.random.default_rng((self.seed, _ARRIVAL_STREAM, 2))
        rmax = self.rate * (1.0 + self.amplitude)
        t, out = 0.0, []
        while len(out) < n:
            t += rng.exponential(1.0 / rmax)
            lam = self.rate * (1.0 + self.amplitude
                               * np.sin(2.0 * np.pi * t / self.period_s))
            if rng.random() * rmax < lam:
                out.append(t)
        return out


def make_arrivals(kind: str, rate: float, seed: int = 0, **kwargs):
    """Factory for the CLI/bench: ``poisson`` | ``bursty`` | ``diurnal``."""
    policies = {"poisson": PoissonArrivals, "bursty": BurstyArrivals,
                "diurnal": DiurnalArrivals}
    if kind not in policies:
        raise ValueError(f"unknown arrival policy {kind!r} "
                         f"(choose from {sorted(policies)})")
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    return policies[kind](rate=rate, seed=seed, **kwargs)


def assign_arrivals(trajectories: list[Trajectory], policy) -> None:
    """Stamp ``submit_time`` from an arrival policy, in trajectory order (GRPO
    groups arrive sample-by-sample: a serving front door sees requests, not
    groups)."""
    for t, at in zip(trajectories, policy.times(len(trajectories))):
        t.submit_time = float(at)


def replay_finished(trajectories: list[Trajectory]) -> list[Trajectory]:
    """Materialize plans into finished trajectories (predictor training data harvest)."""
    out = []
    for t in trajectories:
        plan: TrajectoryPlan = t.payload
        # same trajectory, materialized: reuse the id instead of burning the
        # global counter (keeps later batches' ids independent of this harvest)
        ft = Trajectory(traj_id=t.traj_id, prompt_id=t.prompt_id,
                        sample_id=t.sample_id, prompt_tokens=t.prompt_tokens,
                        context_tokens=t.prompt_tokens)
        for s in range(plan.num_steps):
            ft.record_step(StepRecord(s, plan.gen_tokens[s], plan.tool_latency[s],
                                      tool_failed=plan.tool_failed[s],
                                      tool_output_tokens=plan.tool_output_tokens[s]))
            ft.record_tool_output(plan.tool_output_tokens[s])
        ft.true_total_tokens = t.true_total_tokens
        ft.true_num_steps = t.true_num_steps
        ft.finished = True
        out.append(ft)
    return out
