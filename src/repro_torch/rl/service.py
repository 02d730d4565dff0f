"""Rollout-as-a-service: the asynchronous plane between rollout and training
(counterpart of ``repro/rl/service.py``; pure Python over the port's
orchestrator).

``HeddleTrainer.rollout()`` is a synchronous barrier — every training
iteration waits for the full batch, so the long tail the paper attacks gates
*training* throughput even though the rollout plane itself schedules,
migrates and reconfigures around it.  This module disaggregates the two
planes (RollArt's rollout/training split, Libra's SLO-aware accounting —
see PAPERS.md):

* :class:`RolloutService` keeps one fleet resident across iterations and
  drives the shared :class:`~repro_torch.core.orchestrator.Orchestrator` in
  open-loop + ``stream_harvest`` mode: FINISHED trajectories surface through
  ``harvest`` events on the versioned heap the moment they complete — no
  makespan barrier — while new work is injected mid-run and weight syncs are
  published in flight (each worker cuts over only once its resident lanes
  drain, so every trajectory finishes on the policy that admitted it).
* :class:`ReplayBuffer` is the bounded, group-aware buffer between harvest
  and the GRPO consumer: groups become consumable only when complete (GRPO
  advantages normalize within a group), and :meth:`ReplayBuffer.take`
  enforces the staleness bound — a group whose stamp lags the published
  epoch by more than ``max_staleness`` is discarded, never trained on.

Both backends implement the same harvest/weight-sync semantics, so the
decision-trace parity harness and the TraceSanitizer extend to this plane
(``tests/test_torch_service.py``).  The lifecycle is documented in
docs/training.md.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

from repro_torch.core.faults import FaultPlan
from repro_torch.core.orchestrator import (
    Orchestrator,
    OrchestratorConfig,
    OrchestratorResult,
)
from repro_torch.core.trajectory import Trajectory


class ReplayBuffer:
    """Bounded, group-aware buffer between trajectory harvest and GRPO.

    Trajectories land one at a time (harvest order); a group — keyed by
    ``prompt_id`` — becomes *ready* once all ``group_size`` siblings arrived.
    ``take`` pops ready groups FIFO, discarding any whose weight-epoch stamp
    exceeds the staleness bound.  When the buffer overflows ``capacity``, the
    oldest ready group is evicted (never a partial group: its siblings are
    still streaming in and dropping half a group would poison the advantage
    normalization).
    """

    def __init__(self, capacity: int, group_size: int):
        if group_size < 1:
            raise ValueError("group_size must be >= 1")
        self.capacity = capacity
        self.group_size = group_size
        self._groups: dict[int, list[Trajectory]] = {}  # prompt_id -> members
        self._ready: list[int] = []  # complete groups, completion order
        self.added = 0
        self.evicted = 0  # trajectories dropped by capacity eviction
        self.stale_discards = 0  # trajectories dropped by the staleness bound

    def __len__(self) -> int:
        return sum(len(g) for g in self._groups.values())

    @property
    def ready_groups(self) -> int:
        return len(self._ready)

    def add(self, traj: Trajectory) -> None:
        group = self._groups.setdefault(traj.prompt_id, [])
        group.append(traj)
        self.added += 1
        if len(group) == self.group_size:
            self._ready.append(traj.prompt_id)
        while len(self) > self.capacity and self._ready:
            oldest = self._ready.pop(0)
            self.evicted += len(self._groups.pop(oldest))

    def take(self, n_groups: int, *, epoch: int,
             max_staleness: int) -> list[list[Trajectory]]:
        """Pop up to ``n_groups`` complete groups fresh enough to train on.

        Freshness is per trajectory: a group is consumable iff **every**
        member's ``weight_epoch`` stamp is within ``max_staleness`` of the
        latest published ``epoch`` (siblings may have been admitted by
        different workers under different applied epochs).  Stale groups are
        discarded and counted — the staleness bound is a hard guarantee, not
        a preference.
        """
        out: list[list[Trajectory]] = []
        keep: list[int] = []
        for pid in self._ready:
            group = self._groups[pid]
            if any(epoch - t.weight_epoch > max_staleness for t in group):
                self.stale_discards += len(group)
                del self._groups[pid]
            elif len(out) < n_groups:
                out.append(group)
                del self._groups[pid]
            else:
                keep.append(pid)
        self._ready = keep
        return out


class RolloutService:
    """A persistent, streaming rollout fleet behind a tiny four-call API.

    ``submit()`` new work (before or during the run), iterate ``stream()`` to
    receive FINISHED trajectories the instant they harvest, ``sync_weights()``
    to publish a new policy epoch in flight, ``close()`` to drain.  The fleet
    — real engines or the analytic twin — stays resident the whole time; KV
    caches, radix prefixes and controller state survive across what used to
    be iteration barriers.
    """

    def __init__(self, backend, controller, config, *,
                 faults: Optional[FaultPlan] = None):
        self.backend = backend
        self.controller = controller
        self.cfg = config  # a RuntimeConfig (scheduler/migration/knobs source)
        self.faults = faults
        self._initial: list[Trajectory] = []
        self._orch: Optional[Orchestrator] = None
        self._stream: Optional[Iterator[Trajectory]] = None
        self.result: Optional[OrchestratorResult] = None

    # ------------------------------------------------------------ introspection
    @property
    def now(self) -> float:
        """Current virtual instant (0.0 before the stream starts)."""
        return self._orch.now if self._orch is not None else 0.0

    @property
    def epoch(self) -> int:
        """Latest *published* weight epoch (what staleness is measured from)."""
        return self._orch.published_epoch if self._orch is not None else 0

    @property
    def applied_epochs(self) -> list[int]:
        """Per-worker applied epochs (lag published until residents drain)."""
        if self._orch is None:
            return [0] * self.backend.n_workers
        return list(self._orch.applied_epoch)

    # ------------------------------------------------------------ the four calls
    def submit(self, trajectories: Sequence[Trajectory],
               prompts: Optional[dict[int, list[int]]] = None) -> None:
        """Queue new trajectories; mid-run they arrive at the current instant.

        ``prompts`` maps traj_id -> token ids for the engine backend (the sim
        prices prompts from ``prompt_tokens``/``prompt_lens`` instead).
        """
        if prompts:
            if hasattr(self.backend, "prompts"):
                self.backend.prompts.update(prompts)
            elif getattr(self.backend, "prompt_lens", None) is not None:
                self.backend.prompt_lens.update(
                    {tid: len(toks) for tid, toks in prompts.items()})
        if self._orch is None:
            self._initial.extend(trajectories)
        else:
            self._orch.inject(trajectories)

    def stream(self) -> Iterator[Trajectory]:
        """The harvest stream: yields each trajectory the moment it finishes.

        Lazily builds the orchestrator on first call; subsequent calls return
        the same generator, so consumers may break out, submit/sync, and
        resume iteration.
        """
        if self._stream is None:
            if not self._initial:
                raise ValueError("submit() work before opening the stream")
            cfg = self.cfg
            self._orch = Orchestrator(
                self.backend, self._initial,
                OrchestratorConfig(scheduler=cfg.scheduler,
                                   migration=cfg.migration,
                                   max_active=cfg.max_active,
                                   open_loop=True, stream_harvest=True,
                                   preemption_margin=cfg.preemption_margin,
                                   preemption_floor=cfg.preemption_floor,
                                   trace=cfg.trace, sanitize=cfg.sanitize),
                controller=self.controller, faults=self.faults)
            self._stream = self._orch.run_stream()
        return self._stream

    def sync_weights(self, params=None, *, at: Optional[float] = None) -> int:
        """Publish a new weight epoch in flight; returns the epoch number.

        ``at`` (virtual seconds, >= now) models training latency — the sync
        starts cutting workers over only when its heap event pops.  Workers
        adopt the epoch individually as their residents drain; nothing decoding
        is ever destroyed (``reset_cache`` fires only on drained workers).
        """
        if self._orch is None:
            raise RuntimeError("sync_weights() before stream(): no run yet")
        return self._orch.publish_weights(params, at=at)

    def close(self) -> OrchestratorResult:
        """Drain the stream (every submitted trajectory finishes or sheds)
        and return the run's :class:`OrchestratorResult`."""
        for _ in self.stream():
            pass
        self.result = self._orch._result
        return self.result


def service_on_sim(predictor, n_workers: int = 2, config=None,
                   **kwargs) -> RolloutService:
    """A :class:`RolloutService` on the analytic twin — no model, no engine.

    Same wiring as :func:`repro_torch.engine.runtime.run_on_sim` (controller +
    engine-parity ``SimBackend``), wrapped as a streaming service.  Keyword
    arguments pass through to ``make_sim_components`` (``fleet``,
    ``prompt_lens``, ``faults``, ``serving``, ...).
    """
    from repro_torch.engine.runtime import RuntimeConfig, make_sim_components

    cfg = config if config is not None else RuntimeConfig()
    faults = kwargs.get("faults")
    backend, controller = make_sim_components(predictor, n_workers, cfg, **kwargs)
    return RolloutService(backend, controller, cfg, faults=faults)


__all__ = [
    "ReplayBuffer",
    "RolloutService",
    "service_on_sim",
]
