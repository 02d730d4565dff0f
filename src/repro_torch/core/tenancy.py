"""Tenant/SLA classes and serving-time overload policy (open-loop front door).

The closed-loop reproduction treats a rollout batch as one undifferentiated
pile of work; a serving front door does not.  Requests arrive over time, belong
to tenants with different SLOs, and under overload the system must decide whose
latency to protect.  This module holds the *policy vocabulary* for that layer:

* :class:`TenantClass` — an SLA class (deadline, priority weight, sheddable
  flag, traffic share).  Tier 0 is "gold": never shed, never degraded.
* :class:`ServingConfig` — admission-control and degradation-ladder knobs
  attached to :class:`repro_torch.core.controller.HeddleConfig`.
* :func:`assign_tenants` — seeded, deterministic tenant assignment over a
  workload batch (domain-separated per trajectory id, like the fault rngs),
  stamping absolute deadlines relative to each trajectory's arrival time.

The mechanisms that *consume* this vocabulary live in ``core/controller.py``
(admission gate, shed-victim selection, per-tenant accounting) and
``core/orchestrator.py`` (arrival events, degradation ladder).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.trajectory import Trajectory

# Domain-separation constant for the tenant-assignment rng stream (the fault
# layer uses the same idiom so independent random decisions never correlate).
_TENANT_STREAM = 6151


@dataclass(frozen=True)
class TenantClass:
    """One SLA class.  ``tier`` orders the degradation ladder: tier 0 (gold)
    is untouchable, higher tiers are shed / degraded first."""

    name: str
    tier: int = 0
    deadline_s: float = math.inf     # completion SLO relative to arrival time
    weight: float = 1.0              # multiplier on the PPS priority (higher = sooner)
    sheddable: bool = False          # admission gate / ladder may drop this work
    share: float = 1.0               # fraction of arriving traffic in this class


#: Default three-class mix used by the serving bench and the launcher when the
#: user asks for tenants without spelling out a spec.
DEFAULT_TENANTS: tuple[TenantClass, ...] = (
    TenantClass("gold", tier=0, deadline_s=math.inf, weight=2.0,
                sheddable=False, share=0.25),
    TenantClass("silver", tier=1, deadline_s=math.inf, weight=1.0,
                sheddable=False, share=0.35),
    TenantClass("best_effort", tier=2, deadline_s=math.inf, weight=0.5,
                sheddable=True, share=0.40),
)


@dataclass(frozen=True)
class ServingConfig:
    """Admission-control + graceful-degradation knobs (all off by default, so
    a default controller behaves exactly like the closed-loop reproduction)."""

    # deadline-aware admission gate: predict each arrival's completion time
    # from the progressive predictor + current fast-worker-equivalent loads and
    # shed sheddable arrivals that cannot meet their SLO.
    admission_control: bool = False
    # backpressure: bounded queues.  An arrival beyond a bound is shed (if
    # sheddable) or deferred (gold/silver are never dropped at the door).
    queue_bound_per_worker: float = math.inf    # live trajectories per worker
    queue_bound_global: float = math.inf        # live trajectories fleet-wide
    # degradation ladder, driven by pressure = live / (alive_workers * max_active):
    #   level 1 (>= shed_pressure):    shed queued sheddable work, lowest tier first
    #   level 2 (>= degrade_pressure): tighten step budgets for non-gold tenants
    shed_pressure: float = math.inf
    degrade_pressure: float = math.inf
    degrade_step_grace: int = 1       # degraded trajectories get current+grace steps
    # EDF blend: priority -= nothing, priority += edf_weight * urgency * scale.
    # 0 disables deadline-shaped preemption entirely.
    edf_weight: float = 0.5
    edf_urgency_cap: float = 4.0      # cap on service/slack so late work can't explode
    defer_seconds: float = 1.0        # re-arrival delay for deferred admissions


def parse_tenants(spec: str) -> tuple[TenantClass, ...]:
    """Parse a CLI tenant spec: ``name:share[:deadline_s]`` comma-separated,
    e.g. ``gold:0.25:40,silver:0.35:80,best:0.4``.  Tiers follow list order
    (first class = tier 0 = gold); the last class is sheddable.  Shares must be
    positive and are normalised to sum to 1."""
    fields = [f.strip() for f in spec.split(",") if f.strip()]
    if not fields:
        raise ValueError("empty tenant spec")
    raw: list[tuple[str, float, float]] = []
    for f in fields:
        parts = f.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(f"tenant field {f!r}: expected name:share[:deadline_s]")
        name = parts[0]
        try:
            share = float(parts[1])
            deadline = float(parts[2]) if len(parts) == 3 else math.inf
        except ValueError as e:
            raise ValueError(f"tenant field {f!r}: {e}") from None
        if not name or share <= 0 or deadline <= 0:
            raise ValueError(f"tenant field {f!r}: name must be non-empty, "
                             "share and deadline must be > 0")
        raw.append((name, share, deadline))
    total = sum(s for _, s, _ in raw)
    n = len(raw)
    return tuple(
        # weights halve per tier (gold highest): PPS pops max priority first
        TenantClass(name, tier=i, deadline_s=deadline, weight=2.0 ** (n - 2 - i),
                    sheddable=(i == n - 1 and n > 1), share=share / total)
        for i, (name, share, deadline) in enumerate(raw)
    )


def assign_tenants(trajectories: Sequence[Trajectory],
                   tenants: Optional[Sequence[TenantClass]] = None,
                   seed: int = 0) -> None:
    """Stamp tenant/SLA fields onto a batch, deterministically per traj_id.

    Deadlines are absolute virtual times: ``submit_time + deadline_s``, so run
    :func:`repro_torch.engine.workload.assign_arrivals` *first*.  Seeded per
    trajectory id (not per list position) so the same workload gets the same
    tenant mix regardless of batch slicing.
    """
    classes = tuple(tenants) if tenants else DEFAULT_TENANTS
    shares = np.array([c.share for c in classes], dtype=float)
    cum = np.cumsum(shares / shares.sum())
    for t in trajectories:
        u = np.random.default_rng((seed, _TENANT_STREAM, t.traj_id)).random()
        cls = classes[int(np.searchsorted(cum, u, side="right").clip(0, len(classes) - 1))]
        t.tenant = cls.name
        t.tenant_tier = cls.tier
        t.priority_weight = cls.weight
        t.sheddable = cls.sheddable
        t.slo_deadline = (t.submit_time + cls.deadline_s
                          if math.isfinite(cls.deadline_s) else math.inf)
