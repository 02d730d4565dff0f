"""Trajectory lifecycle state machine and metadata (Heddle's trajectory-centric unit).

The paper's central observation is that existing agentic-RL frameworks are *step-centric*:
every LLM generation request is stateless, stripping the metadata (trajectory id, step
index, accumulated context, predicted remaining length) that the control plane needs.
``Trajectory`` is the metadata record that the router, scheduler, placement engine and
resource manager all operate on.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, Optional


class TrajectoryPhase(enum.Enum):
    """Lifecycle of an agentic trajectory (Fig. 1 of the paper)."""

    PENDING = "pending"          # waiting in a worker's queue for LLM generation
    GENERATING = "generating"    # active in a worker's running batch (decoding)
    TOOL_CALL = "tool_call"      # executing an external tool (GPU released)
    MIGRATING = "migrating"      # KV cache in flight to a new worker (during tool call)
    FINISHED = "finished"        # reached terminal state
    PREEMPTED = "preempted"      # evicted from the running batch, KV persisted
    SHED = "shed"                # dropped by admission control / overload shedding


@dataclass
class StepRecord:
    """One agentic step: an LLM generation followed by a tool execution."""

    step_index: int
    gen_tokens: int                  # tokens generated by the LLM in this step
    tool_latency: float              # seconds spent in tool execution
    tool_kind: str = "generic"
    tool_failed: bool = False        # e.g. a failed test run for a coding agent
    tool_output_tokens: int = 0      # tool output folded back into the context
    queue_delay: float = 0.0         # seconds this step waited in the pending queue
    gen_time: float = 0.0            # seconds of LLM generation for this step
    # chaos-layer accounting: injected system faults, kept strictly separate
    # from tool_failed (the plan-driven rectification signal above)
    tool_attempts: int = 1           # 1 = clean call; >1 = retries absorbed faults
    tool_injected_faults: int = 0    # injected timeouts + transient errors


_traj_counter = itertools.count()


@dataclass
class Trajectory:
    """Trajectory-centric metadata record.

    Carries everything the paper says step-centric systems throw away: identity, step
    index, accumulated lengths, runtime context features and the progressive prediction.
    """

    prompt_id: int
    sample_id: int                      # GRPO samples multiple trajectories per prompt
    prompt_tokens: int
    traj_id: int = field(default_factory=lambda: next(_traj_counter))
    phase: TrajectoryPhase = TrajectoryPhase.PENDING

    # --- runtime progress -------------------------------------------------
    steps: list[StepRecord] = field(default_factory=list)
    tokens_generated: int = 0           # cumulative LLM output tokens
    context_tokens: int = 0             # prompt + generated + tool-output tokens
    tool_output_tokens: int = 0
    failed_tool_calls: int = 0      # plan-driven (rectification); never chaos
    finished: bool = False
    recoveries: int = 0             # checkpoint re-admissions after worker death
    tool_retries: int = 0           # injected-fault retry attempts
    injected_tool_faults: int = 0   # injected timeouts + transient errors

    # --- tenancy + SLO (open-loop serving front door) -----------------------
    tenant: str = "default"             # SLA class name this request belongs to
    tenant_tier: int = 0                # 0 = gold (never shed/degraded); higher = softer
    priority_weight: float = 1.0        # tenant multiplier blended into PPS priority
    slo_deadline: float = float("inf")  # absolute virtual-time deadline (inf = no SLO)
    sheddable: bool = False             # admission gate / ladder may drop this work
    slo_boost: float = 0.0              # EDF urgency term added to the PPS priority
    shed: bool = False                  # dropped by admission control or the ladder
    shed_reason: str = ""               # "queue_full" | "deadline" | "overload"
    deferrals: int = 0                  # times admission pushed the arrival back
    step_cap: Optional[int] = None      # degradation ladder's tightened step budget
    degraded: bool = False              # step budget was tightened under overload

    # --- control-plane state ----------------------------------------------
    predicted_remaining: float = 0.0    # progressive predictor output (tokens)
    priority: float = 0.0               # scheduler priority (= predicted total length)
    worker_id: Optional[int] = None     # current placement
    # policy-weights epoch stamped at admission (async rollout-as-a-service):
    # the admitting worker's applied epoch.  Never mutated mid-flight — a
    # resident finishes on the policy that started it (sanitizer-enforced),
    # and the staleness-bounded consumer reads this stamp to decide whether
    # the sample is still fresh enough to train on.
    weight_epoch: int = 0
    placement_rank: int = -1            # rank in the presorted order
    migrations: int = 0
    preemptions: int = 0

    # --- accounting for Formula 1 ------------------------------------------
    total_queue_delay: float = 0.0      # sum of per-step queueing delays (paper §7.2)
    total_gen_time: float = 0.0
    total_tool_time: float = 0.0
    submit_time: float = 0.0
    finish_time: float = 0.0

    # --- ground truth (known to the workload generator / oracle only) ------
    true_total_tokens: int = 0          # total tokens this trajectory will generate
    true_num_steps: int = 0

    # arbitrary payload (real-engine token ids, simulator step plan, ...)
    payload: Any = None

    # ------------------------------------------------------------------ API
    @property
    def num_steps(self) -> int:
        return len(self.steps)

    @property
    def predicted_total(self) -> float:
        """Predicted total trajectory length = generated so far + predicted remaining."""
        return self.tokens_generated + max(self.predicted_remaining, 0.0)

    def record_step(self, step: StepRecord) -> None:
        self.steps.append(step)
        self.tokens_generated += step.gen_tokens
        self.context_tokens += step.gen_tokens
        self.total_queue_delay += step.queue_delay
        self.total_gen_time += step.gen_time
        self.total_tool_time += step.tool_latency
        if step.tool_failed:
            self.failed_tool_calls += 1
        self.tool_retries += step.tool_attempts - 1
        self.injected_tool_faults += step.tool_injected_faults

    def record_tool_output(self, tokens: int) -> None:
        self.tool_output_tokens += tokens
        self.context_tokens += tokens

    def completion_time(self) -> float:
        return self.finish_time - self.submit_time

    @property
    def deadline_met(self) -> bool:
        """True iff this trajectory finished (not shed) inside its SLO deadline."""
        return self.finished and not self.shed and self.finish_time <= self.slo_deadline

    # Features consumed by the progressive predictor (core/predictor.py).
    # Static prompt features + dynamic runtime context, exactly the paper's
    # "fuses static prompt analysis with dynamic runtime context".
    def features(self) -> list[float]:
        import math
        n = max(self.num_steps, 1)
        step0 = float(self.steps[0].gen_tokens) if self.steps else 0.0
        return [
            1.0,                                     # bias
            float(self.prompt_tokens),
            float(self.num_steps),
            float(self.tokens_generated),
            float(self.tokens_generated) / n,        # mean tokens per step
            float(self.tool_output_tokens),
            float(self.failed_tool_calls),           # rectification signal (coding agents)
            float(self.failed_tool_calls) / n,       # failure *rate* ~ task hardness
            float(self.steps[-1].gen_tokens) if self.steps else 0.0,
            float(self.steps[-1].tool_failed) if self.steps else 0.0,
            float(self.steps[-1].tool_latency) if self.steps else 0.0,
            float(self.total_tool_time),
            step0,                                   # the plan step: semantic anchor (§4.1)
            math.log1p(float(self.tokens_generated)),
            math.log1p(float(self.prompt_tokens)),
            math.log1p(step0),
            float(self.num_steps) * float(self.failed_tool_calls) / n,
        ]


FEATURE_DIM = 17


def make_group(prompt_id: int, prompt_tokens: int, group_size: int) -> list[Trajectory]:
    """Spawn a GRPO group: ``group_size`` trajectory samples sharing one prompt."""
    return [
        Trajectory(prompt_id=prompt_id, sample_id=s, prompt_tokens=prompt_tokens,
                   context_tokens=prompt_tokens)
        for s in range(group_size)
    ]
