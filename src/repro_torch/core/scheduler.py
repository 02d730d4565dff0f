"""Trajectory-level scheduling (paper §4.2, Algorithm 1).

Progressive Priority Scheduling (PPS) is an adaptive approximation of
longest-processing-time-first (LPT): the pending queue is ordered by *predicted remaining
length* (refreshed by the progressive predictor every time a trajectory returns from a
tool call), and preemptive execution lets a pending request that outranks the
lowest-priority active request evict it (persisting its KV cache).

Baseline disciplines from §7.2 (FCFS, round-robin, Autellix-style shortest-job-first)
share the same interface so the simulator and the real engine can swap them.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol

from repro_torch.core.trajectory import Trajectory, TrajectoryPhase


class Scheduler(Protocol):
    """Per-worker scheduling discipline over pending LLM generation requests."""

    def submit(self, traj: Trajectory, now: float) -> None: ...
    def pop(self, now: float) -> Optional[Trajectory]: ...
    def peek_priority(self) -> Optional[float]: ...
    def __len__(self) -> int: ...
    # Preemption hook: return the active trajectory to evict for `incoming`, or None.
    def preempt_victim(self, active: list[Trajectory]) -> Optional[Trajectory]: ...


@dataclass(order=True)
class _Entry:
    sort_key: tuple
    traj: Trajectory = field(compare=False)
    dead: bool = field(default=False, compare=False)


class _HeapScheduler:
    """Heap-based scheduler with lazy deletion; subclasses define the sort key."""

    preemptive = False

    def __init__(self) -> None:
        self._heap: list[_Entry] = []
        self._entries: dict[int, _Entry] = {}
        self._tie = itertools.count()

    def _key(self, traj: Trajectory, now: float) -> tuple:
        raise NotImplementedError

    def submit(self, traj: Trajectory, now: float) -> None:
        old = self._entries.get(traj.traj_id)
        if old is not None:
            old.dead = True
        entry = _Entry((*self._key(traj, now), next(self._tie)), traj)
        self._entries[traj.traj_id] = entry
        heapq.heappush(self._heap, entry)
        traj.phase = TrajectoryPhase.PENDING

    def pop(self, now: float) -> Optional[Trajectory]:
        while self._heap:
            entry = heapq.heappop(self._heap)
            if entry.dead:
                continue
            del self._entries[entry.traj.traj_id]
            return entry.traj
        return None

    def remove(self, traj: Trajectory) -> None:
        entry = self._entries.pop(traj.traj_id, None)
        if entry is not None:
            entry.dead = True

    def peek_priority(self) -> Optional[float]:
        while self._heap and self._heap[0].dead:
            heapq.heappop(self._heap)
        if not self._heap:
            return None
        return self._peek_value(self._heap[0].traj)

    def _peek_value(self, traj: Trajectory) -> float:
        return 0.0

    def preempt_victim(self, active: list[Trajectory]) -> Optional[Trajectory]:
        return None

    def queued(self) -> list[Trajectory]:
        """Live queued trajectories (insertion order) — degradation-ladder input."""
        return [e.traj for e in self._entries.values()]

    def __len__(self) -> int:
        return len(self._entries)


class PPSScheduler(_HeapScheduler):
    """Algorithm 1: progressive priority scheduling with preemptive execution.

    priority := predicted TOTAL trajectory length (generated + predicted remaining);
    longer => higher priority (LPT). The heap is a min-heap, so we negate.
    """

    preemptive = True

    def __init__(self, preemption_margin: float = 1.0,
                 preemption_floor: float = 1.0) -> None:
        super().__init__()
        # Hysteresis: only preempt when the pending request's priority exceeds the
        # victim's by this multiplicative margin (prevents eviction thrash).  The
        # margin alone is vacuous when the victim's priority is 0 (cold predictor:
        # anything > 0 * margin), so an additive floor guarantees a minimum
        # absolute priority gap before any eviction.
        self.preemption_margin = preemption_margin
        self.preemption_floor = preemption_floor

    def submit(self, traj: Trajectory, now: float) -> None:  # Alg.1 lines 1-4
        # Serving blend: tenant weight scales the LPT term and an EDF urgency
        # boost (computed by the controller at submit time) pulls deadline-
        # critical work forward.  Closed-loop defaults (weight 1, boost 0)
        # reduce to the paper's pure predicted-total priority.
        traj.priority = (traj.priority_weight * traj.predicted_total
                         + traj.slo_boost)
        super().submit(traj, now)

    def _key(self, traj: Trajectory, now: float) -> tuple:
        return (-traj.priority,)

    def _peek_value(self, traj: Trajectory) -> float:
        return traj.priority

    def preempt_victim(self, active: list[Trajectory]) -> Optional[Trajectory]:
        """Alg.1 lines 5-10: evict the lowest-priority active request if outranked."""
        top = self.peek_priority()
        if top is None or not active:
            return None
        victim = min(active, key=lambda t: t.priority)
        if top > victim.priority * self.preemption_margin + self.preemption_floor:
            return victim
        return None


class FCFSScheduler(_HeapScheduler):
    """First-come-first-served over *trajectory* arrival."""

    def _key(self, traj: Trajectory, now: float) -> tuple:
        return (traj.submit_time,)


class RoundRobinScheduler(_HeapScheduler):
    """Step-centric round-robin: every tool return re-queues at the tail (the de facto
    policy of existing agentic RL frameworks, §2.3)."""

    def _key(self, traj: Trajectory, now: float) -> tuple:
        return (now,)


class SJFScheduler(_HeapScheduler):
    """Autellix-style shortest-job-first (minimizes mean latency, not makespan)."""

    def submit(self, traj: Trajectory, now: float) -> None:
        traj.priority = traj.predicted_total
        super().submit(traj, now)

    def _key(self, traj: Trajectory, now: float) -> tuple:
        return (traj.predicted_total,)


SCHEDULERS: dict[str, Callable[[], _HeapScheduler]] = {
    "pps": PPSScheduler,
    "fcfs": FCFSScheduler,
    "rr": RoundRobinScheduler,
    "sjf": SJFScheduler,
}


def make_scheduler(name: str) -> _HeapScheduler:
    try:
        return SCHEDULERS[name]()
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}; options: {sorted(SCHEDULERS)}")
