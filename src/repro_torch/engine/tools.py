"""Tool manager: simulated elastic serverless backend (paper §3 'Tool Manager').

The paper offloads tool execution to FaaS and treats T_tool as elastic; we model each
task domain's tool with a lognormal latency distribution calibrated to the paper's
Table 1 means (coding 0.46s, search 1.42s, math 0.051s) plus a failure probability
(e.g. failing tests for the coding agent) that drives trajectory extension.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.faults import FaultPlan, RetryPolicy, resolve_tool_call


@dataclass(frozen=True)
class ToolProfile:
    name: str
    mean_latency: float              # seconds (Table 1)
    cv: float = 0.6                  # coefficient of variation (long-tailed)
    fail_rate: float = 0.0           # P(tool reports failure) -> rectification steps
    output_tokens_mean: int = 128    # tool output size folded back into context

    def sample_latency(self, rng: np.random.Generator, n: int | None = None):
        sigma = np.sqrt(np.log(1 + self.cv ** 2))
        mu = np.log(self.mean_latency) - sigma ** 2 / 2
        return rng.lognormal(mu, sigma, n)

    def sample_output_tokens(self, rng: np.random.Generator, failed: bool) -> int:
        base = self.output_tokens_mean * (2.0 if failed else 1.0)
        return int(max(1, rng.normal(base, base * 0.3)))


# Task domains evaluated in the paper (§7 'Workloads'), Table 1 tool-latency means.
TOOL_PROFILES: dict[str, ToolProfile] = {
    "coding": ToolProfile("sandbox", mean_latency=0.46, cv=0.8, fail_rate=0.35,
                          output_tokens_mean=160),
    "search": ToolProfile("web_search", mean_latency=1.42, cv=0.5, fail_rate=0.10,
                          output_tokens_mean=256),
    "math": ToolProfile("calculator", mean_latency=0.051, cv=0.4, fail_rate=0.20,
                        output_tokens_mean=48),
}


class ToolExecutor:
    """Elastic executor: unlimited concurrency (serverless), pay-per-invocation.

    Outcomes are seeded per ``(traj_id, step)``, NOT per call sequence: two
    backends (or two scheduling orders) invoking the same trajectory's steps
    must observe identical latencies/failures, and a shared sequential rng
    would entangle every trajectory's outcome with global dispatch order.

    Two failure channels, never conflated (see ``core.faults``): ``failed`` is
    the *task-level* outcome rolled from ``ToolProfile.fail_rate`` (the
    rectification signal the predictor features on), while a ``FaultPlan``
    injects *system-level* timeouts/transient errors that the executor absorbs
    via ``RetryPolicy`` — they stretch latency (and the retry telemetry) but
    cannot change the task outcome."""

    def __init__(self, profile: ToolProfile, seed: int = 0, *,
                 faults: Optional[FaultPlan] = None,
                 retry: RetryPolicy = RetryPolicy()):
        self.profile = profile
        self.seed = seed
        self.faults = faults
        self.retry = retry
        self.invocations = 0
        self.total_latency = 0.0
        self.retries = 0
        self.injected_faults = 0

    def invoke(self, traj_id: int, step: int) -> tuple[float, bool, int]:
        """Returns (latency_s, failed, output_tokens) for one (traj, step).

        The task-level roll consumes the rng stream identically with or without
        a fault plan, so chaos never perturbs plan-driven outcomes."""
        rng = np.random.default_rng((self.seed, traj_id, step))
        lat = float(self.profile.sample_latency(rng))
        failed = bool(rng.random() < self.profile.fail_rate)
        out = self.profile.sample_output_tokens(rng, failed)
        trace = resolve_tool_call(self.faults, self.retry, traj_id, step, lat)
        self.invocations += 1
        self.total_latency += trace.latency
        self.retries += trace.retries
        self.injected_faults += trace.injected_faults
        return trace.latency, failed, out
