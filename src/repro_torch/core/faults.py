"""Deterministic fault injection for the unified control plane (chaos harness).

Production agentic-RL rollout runs as a long-lived service on preemptible
capacity with flaky external tools; the paper's long-tail premise makes losing
a resident trajectory to a worker death disproportionately expensive.  This
module is the *schedule* side of the failure-realism layer: a seeded,
virtual-time :class:`FaultPlan` that both execution backends (the analytic
``SimBackend`` and the real ``EngineBackend``) consume through the one
orchestrator, so a chaos run makes identical fault decisions regardless of
substrate.

Two fault families, deliberately distinct from the *plan-driven* "tool
reported failure" signal (``ToolProfile.fail_rate``, which models the task —
failing tests, empty search results — and feeds the progressive predictor's
rectification features):

* **worker faults** — death at virtual time ``t`` (every resident lane is
  lost; trajectories re-admit elsewhere from their last tool-boundary
  checkpoint) and revival (replacement capacity joins with a cold cache);
* **tool system faults** — per-``(traj, step, attempt)``-seeded timeouts and
  transient errors, absorbed by :func:`resolve_tool_call`'s capped
  exponential-backoff retry discipline.

The retry cap bounds *injected delay*, never outcome: the final attempt always
succeeds, so chaos perturbs timing and placement but cannot flip a step's
task-level result — injected-fault telemetry stays orthogonal to the
predictor's features and every trajectory still reaches FINISHED.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

# domain-separation constant for the tool-fault rng stream: keeps fault rolls
# independent of the workload/tool rngs that also seed on (seed, traj, step)
_TOOL_FAULT_STREAM = 7919
# separate stream for backoff jitter: the jitter draw must not correlate with
# the fault roll that triggered the retry
_BACKOFF_STREAM = 104729


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with deterministic full jitter.

    ``max_attempts`` bounds total tries (so injected delay is bounded);
    attempt ``k``'s failure computes a ceiling ``min(base * factor**k, cap)``
    and — when a seed context is supplied — waits a uniform draw in
    ``[0, ceiling]`` seeded per ``(traj, step, attempt)``.  Full jitter
    decorrelates retries across trajectories (no synchronized retry storms
    when a burst of calls faults together) while staying bit-reproducible on
    both backends.  Without a seed the wait is the un-jittered ceiling.
    """

    max_attempts: int = 4
    backoff_base: float = 0.05
    backoff_factor: float = 2.0
    backoff_cap: float = 1.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("RetryPolicy needs at least one attempt")

    def backoff(self, attempt: int, *, seed: Optional[int] = None,
                traj_id: int = 0, step: int = 0) -> float:
        """Seconds to wait after failed attempt ``attempt`` (0-indexed)."""
        ceiling = min(self.backoff_base * self.backoff_factor ** attempt,
                      self.backoff_cap)
        if seed is None:
            return ceiling
        rng = np.random.default_rng(
            (seed, _BACKOFF_STREAM, traj_id, step, attempt))
        return ceiling * float(rng.random())


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic chaos schedule over virtual time.

    ``deaths`` / ``revivals`` are ``(virtual_time, worker_id)`` pairs injected
    straight into the orchestrator's versioned event heap.  Tool faults are
    rolled per ``(traj_id, step, attempt)`` from ``seed`` — never from call
    order — so sim and engine observe identical outcomes and a retry sees a
    fresh (but reproducible) roll.
    """

    seed: int = 0
    deaths: tuple[tuple[float, int], ...] = ()
    revivals: tuple[tuple[float, int], ...] = ()
    tool_timeout_rate: float = 0.0   # P(attempt times out)
    tool_error_rate: float = 0.0     # P(attempt hits a transient system error)
    tool_timeout_s: float = 1.0      # wall the caller burns before declaring timeout

    def __post_init__(self):
        if self.tool_timeout_rate + self.tool_error_rate >= 1.0:
            raise ValueError(
                "tool_timeout_rate + tool_error_rate must be < 1 (an attempt "
                "must be able to succeed, or retries never converge)")

    @property
    def injects_tool_faults(self) -> bool:
        return self.tool_timeout_rate > 0.0 or self.tool_error_rate > 0.0

    def tool_fault(self, traj_id: int, step: int, attempt: int) -> Optional[str]:
        """Roll attempt ``attempt`` of (traj, step): None | 'timeout' | 'error'."""
        if not self.injects_tool_faults:
            return None
        rng = np.random.default_rng(
            (self.seed, _TOOL_FAULT_STREAM, traj_id, step, attempt))
        u = float(rng.random())
        if u < self.tool_timeout_rate:
            return "timeout"
        if u < self.tool_timeout_rate + self.tool_error_rate:
            return "error"
        return None

    @classmethod
    def chaos(cls, seed: int, n_workers: int, horizon: float, *,
              tool_timeout_rate: float = 0.10, tool_error_rate: float = 0.05,
              tool_timeout_s: float = 1.0, kill_frac: float = 0.4,
              revive_frac: float = 0.75) -> "FaultPlan":
        """A canonical chaos schedule: one mid-run death + later revival.

        ``horizon`` is the caller's makespan estimate (e.g. the no-fault run's
        makespan, or a work/throughput bound); the victim dies at
        ``kill_frac * horizon`` and replacement capacity arrives at
        ``revive_frac * horizon``.  With a single worker no death is scheduled
        (there would be no survivor to recover onto).
        """
        rng = np.random.default_rng((seed, _TOOL_FAULT_STREAM, 1))
        deaths: tuple[tuple[float, int], ...] = ()
        revivals: tuple[tuple[float, int], ...] = ()
        if n_workers > 1 and horizon > 0:
            victim = int(rng.integers(n_workers))
            deaths = ((kill_frac * horizon, victim),)
            revivals = ((revive_frac * horizon, victim),)
        return cls(seed=seed, deaths=deaths, revivals=revivals,
                   tool_timeout_rate=tool_timeout_rate,
                   tool_error_rate=tool_error_rate,
                   tool_timeout_s=tool_timeout_s)


@dataclass(frozen=True)
class ToolCallTrace:
    """What one tool call cost after injection + retries settled."""

    latency: float       # total seconds incl. timeouts, errors, and backoff
    attempts: int        # >= 1; 1 means no injected fault
    timeouts: int
    errors: int

    @property
    def injected_faults(self) -> int:
        return self.timeouts + self.errors

    @property
    def retries(self) -> int:
        return self.attempts - 1


def resolve_tool_call(faults: Optional[FaultPlan], retry: RetryPolicy,
                      traj_id: int, step: int,
                      base_latency: float) -> ToolCallTrace:
    """Apply the fault plan's injection + the retry discipline to one tool call.

    Each faulted attempt burns its cost (``tool_timeout_s`` for a timeout, the
    call's own ``base_latency`` for a transient error — the call ran, then the
    result was lost) plus the attempt's backoff.  The last allowed attempt
    always succeeds (see module docstring), so the returned latency is the
    *effective* tool interval the orchestrator masks migration behind.
    """
    if faults is None or not faults.injects_tool_faults:
        return ToolCallTrace(base_latency, 1, 0, 0)
    total = 0.0
    timeouts = errors = 0
    for attempt in range(retry.max_attempts - 1):
        kind = faults.tool_fault(traj_id, step, attempt)
        if kind is None:
            break
        if kind == "timeout":
            total += faults.tool_timeout_s
            timeouts += 1
        else:
            total += base_latency
            errors += 1
        total += retry.backoff(attempt, seed=faults.seed,
                               traj_id=traj_id, step=step)
    total += base_latency
    return ToolCallTrace(total, timeouts + errors + 1, timeouts, errors)
