"""TraceSanitizer — runtime validation of the orchestrator's decision stream.

The JAX package's linter (``repro.analysis.lint``, not ported) catches
nondeterminism *sources*; the sanitizer catches *consequences*: it mirrors the
control-plane state machine off the same ``_note`` stream the decision-trace
parity harness records, and checks every transition against the invariants
the orchestrator is supposed to maintain.  Hooked in via
``OrchestratorConfig(sanitize=True)`` — on by default in the parity tests and
every bench ``--smoke`` — it validates:

* **monotone virtual time** — the heap never pops backwards (an event pushed
  into the past would);
* **version-stamped causality** — no stale worker event is ever applied to a
  lane (death/replan bumps ``lane.version``; the sanitizer proves the guard
  held), stale drops are counted;
* **worker liveness** — no dispatch, migrate-in, restore-in or admission onto
  a dead worker;
* **lane/slot conservation** — a trajectory is active on at most one worker,
  each worker holds at most ``max_active`` concurrent steps, and
  preempt/step events refer to actually-active trajectories;
* **migration commit/abort balance** — every launched transfer is exactly
  once committed (``migrate_done``) or aborted (checkpoint ``recover`` after
  the destination died); nothing is left on the wire at drain;
* **tenancy legality** — gold (tier-0) and non-sheddable trajectories are
  never shed; only non-gold work is degraded;
* **weight-epoch discipline** (async rollout-as-a-service) — a trajectory's
  ``weight_epoch`` stamp never changes mid-flight (a resident finishes on the
  policy that admitted it), each worker's applied epoch is strictly monotone,
  a sync only ever lands on an alive worker with zero resident lanes (the
  drain fence held), and a harvest fires exactly once, only after the
  trajectory finished.

Violations accumulate (capped) and :meth:`finalize` raises
:class:`TraceViolationError` listing them; ``report()`` returns counters plus
the sanitizer's own wall-clock cost so benches can publish the overhead.
"""

from __future__ import annotations

from time import perf_counter
from typing import Sequence

_MAX_RECORDED = 50  # keep the first N violations; count the rest
_EPS = 1e-9  # float-tolerant monotonicity


class TraceViolationError(AssertionError):
    """The decision stream broke a control-plane invariant."""

    def __init__(self, violations: Sequence[str], total: int):
        self.violations = list(violations)
        self.total = total
        shown = "\n  ".join(self.violations)
        extra = f" (+{total - len(self.violations)} more)" \
            if total > len(self.violations) else ""
        super().__init__(
            f"trace sanitizer: {total} invariant violation(s){extra}:\n  {shown}")


class TraceSanitizer:
    """Mirrors trajectory/worker lifecycle off the decision-note stream."""

    def __init__(self, trajectories, n_workers: int, max_active: int):
        self.max_active = max_active
        self.tenancy: dict[int, tuple[bool, int]] = {}
        self._trajs: dict[int, object] = {}
        self.register(trajectories)
        self.now = 0.0
        self.alive = [True] * n_workers
        self.active: list[set[int]] = [set() for _ in range(n_workers)]
        self.where: dict[int, int] = {}  # tid -> wid while a step is in progress
        self.finished: set[int] = set()
        self.shed: set[int] = set()
        self.pending_migration: dict[int, int] = {}  # tid -> dst on the wire
        self.pending_restore: dict[int, int] = {}  # tid -> dst re-admitting
        self.events = 0
        self.stale_worker_events = 0
        self.migrate_launches = 0
        self.migrate_commits = 0
        self.migrate_aborts = 0
        # async service plane: weight-epoch discipline + harvest bookkeeping
        self.worker_epoch = [0] * n_workers  # applied epoch, strictly monotone
        self.lane_epoch: dict[int, int] = {}  # tid -> stamp at first dispatch
        self.resident_of: dict[int, int] = {}  # tid -> admitting worker (serving)
        self.harvested: set[int] = set()
        self.weight_syncs = 0
        self.wall_s = 0.0
        self._violations: list[str] = []
        self._total_violations = 0

    def register(self, trajectories) -> None:
        """Adopt trajectories, including mid-run submissions (``inject``)."""
        for t in trajectories:
            self.tenancy[t.traj_id] = (bool(getattr(t, "sheddable", True)),
                                       int(getattr(t, "tenant_tier", 0)))
            self._trajs[t.traj_id] = t

    # ------------------------------------------------------------ plumbing
    def _flag(self, msg: str) -> None:
        self._total_violations += 1
        if len(self._violations) < _MAX_RECORDED:
            self._violations.append(f"t={self.now:.6f} {msg}")

    # ------------------------------------------------------------ hooks
    def on_clock(self, now: float) -> None:
        """Called once per heap pop, before the event is handled."""
        t0 = perf_counter()
        self.events += 1
        if now + _EPS < self.now:
            self._flag(f"virtual time went backwards: heap popped {now:.6f} "
                       f"after {self.now:.6f} (an event was pushed into the past)")
        else:
            self.now = now
        self.wall_s += perf_counter() - t0

    def on_worker_event(self, wid: int, applied: bool, lane_alive: bool) -> None:
        """Called for every popped worker event, stale or fresh."""
        t0 = perf_counter()
        if not applied:
            self.stale_worker_events += 1
        elif not lane_alive:
            self._flag(f"stale-guard breach: worker event applied to dead "
                       f"lane {wid} (death must bump lane.version)")
        self.wall_s += perf_counter() - t0

    def observe(self, kind: str, tid: int, wid: int) -> None:
        """One decision note, in emission order (same stream as the trace)."""
        t0 = perf_counter()
        handler = self._HANDLERS.get(kind)
        if handler is None:
            self._flag(f"unknown decision-note kind '{kind}': the sanitizer "
                       f"vocabulary must grow with the trace")
        else:
            handler(self, tid, wid)
        self.wall_s += perf_counter() - t0

    # ------------------------------------------------------------ note handlers
    def _not_terminal(self, tid: int, what: str) -> bool:
        if tid in self.finished:
            self._flag(f"{what} for trajectory {tid} after it finished")
            return False
        if tid in self.shed:
            self._flag(f"{what} for trajectory {tid} after it was shed")
            return False
        return True

    def _on_start(self, tid: int, wid: int) -> None:
        if not self.alive[wid]:
            self._flag(f"dispatch of trajectory {tid} onto dead worker {wid}")
        if tid in self.where:
            self._flag(f"trajectory {tid} dispatched on worker {wid} while "
                       f"still active on worker {self.where[tid]} "
                       f"(slot conservation)")
        if tid in self.pending_migration:
            self._flag(f"trajectory {tid} dispatched while its state is on "
                       f"the wire to worker {self.pending_migration[tid]}")
        self._not_terminal(tid, "dispatch")
        if len(self.active[wid]) >= self.max_active:
            self._flag(f"worker {wid} exceeds max_active={self.max_active} "
                       f"dispatching trajectory {tid} (slot conservation)")
        self.active[wid].add(tid)
        self.where[tid] = wid
        self._check_epoch(tid)

    def _check_epoch(self, tid: int) -> None:
        """Stamp immutability: a resident finishes on the policy that admitted
        it — its ``weight_epoch`` must never change while the lane lives."""
        traj = self._trajs.get(tid)
        if traj is None:
            return
        epoch = int(getattr(traj, "weight_epoch", 0))
        first = self.lane_epoch.setdefault(tid, epoch)
        if epoch != first:
            self._flag(f"trajectory {tid} weight epoch changed mid-flight "
                       f"({first} -> {epoch}): residents must finish on the "
                       f"policy that admitted them")

    def _on_preempt(self, tid: int, wid: int) -> None:
        if self.where.get(tid) != wid:
            self._flag(f"preemption of trajectory {tid} on worker {wid} but "
                       f"it is active on {self.where.get(tid)}")
        self.active[wid].discard(tid)
        self.where.pop(tid, None)

    def _on_step(self, tid: int, wid: int) -> None:
        if self.where.get(tid) != wid:
            self._flag(f"step completion for trajectory {tid} on worker {wid} "
                       f"but it is active on {self.where.get(tid)}")
        self.active[wid].discard(tid)
        self.where.pop(tid, None)
        self._check_epoch(tid)

    def _on_finish(self, tid: int, wid: int) -> None:
        if self._not_terminal(tid, "finish"):
            self.finished.add(tid)
        self._check_epoch(tid)
        self.resident_of.pop(tid, None)

    def _on_tool_done(self, tid: int, wid: int) -> None:
        self._not_terminal(tid, "tool completion")

    def _on_migrate(self, tid: int, dst: int) -> None:
        if not self.alive[dst]:
            self._flag(f"migration of trajectory {tid} launched toward dead "
                       f"worker {dst}")
        if tid in self.where:
            self._flag(f"migration of trajectory {tid} launched mid-step on "
                       f"worker {self.where[tid]} (only tool intervals "
                       f"migrate)")
        if tid in self.pending_migration:
            self._flag(f"second migration launched for trajectory {tid} while "
                       f"one is on the wire to {self.pending_migration[tid]}")
        self._not_terminal(tid, "migration launch")
        self.pending_migration[tid] = dst
        if tid in self.resident_of:  # residency rebinds to dst at launch
            self.resident_of[tid] = dst
        self.migrate_launches += 1

    def _on_migrate_done(self, tid: int, dst: int) -> None:
        src = self.pending_migration.pop(tid, None)
        if src is None:
            self._flag(f"migration commit for trajectory {tid} with no "
                       f"transfer on the wire (commit/abort balance)")
        elif src != dst:
            self._flag(f"migration of trajectory {tid} committed on worker "
                       f"{dst} but was launched toward {src}")
        if not self.alive[dst]:
            self._flag(f"migration of trajectory {tid} landed on dead "
                       f"worker {dst}")
        self.migrate_commits += 1

    def _on_recover(self, tid: int, dst: int) -> None:
        if not self.alive[dst]:
            self._flag(f"checkpoint recovery of trajectory {tid} onto dead "
                       f"worker {dst}")
        if tid in self.where:
            self._flag(f"recovery launched for trajectory {tid} while it is "
                       f"still active on worker {self.where[tid]}")
        self._not_terminal(tid, "recovery")
        if self.pending_migration.pop(tid, None) is not None:
            # in-flight transfer to a worker that died: the recovery aborts it
            self.migrate_aborts += 1
        if tid in self.resident_of:
            self.resident_of[tid] = dst
        self.pending_restore[tid] = dst  # re-route overwrites: token superseded

    def _on_restore_done(self, tid: int, wid: int) -> None:
        dst = self.pending_restore.pop(tid, None)
        if dst is None:
            self._flag(f"restore completion for trajectory {tid} with no "
                       f"restore in flight")
        elif dst != wid:
            self._flag(f"restore of trajectory {tid} landed on worker {wid} "
                       f"but was headed to {dst}")
        if not self.alive[wid]:
            self._flag(f"restore of trajectory {tid} landed on dead worker {wid}")

    def _on_worker_death(self, tid: int, wid: int) -> None:
        if not self.alive[wid]:
            self._flag(f"death event for worker {wid} which is already dead")
        self.alive[wid] = False
        for t in self.active[wid]:
            self.where.pop(t, None)
        self.active[wid].clear()

    def _on_worker_up(self, tid: int, wid: int) -> None:
        if self.alive[wid]:
            self._flag(f"revival event for worker {wid} which is already alive")
        self.alive[wid] = True

    def _on_arrival(self, tid: int, wid: int) -> None:
        self._not_terminal(tid, "arrival")

    def _on_admit(self, tid: int, wid: int) -> None:
        if 0 <= wid < len(self.alive) and not self.alive[wid]:
            self._flag(f"trajectory {tid} admitted onto dead worker {wid}")
        self._not_terminal(tid, "admission")
        if 0 <= wid < len(self.alive):
            self.resident_of[tid] = wid

    def _on_defer(self, tid: int, wid: int) -> None:
        self._not_terminal(tid, "deferral")

    def _on_shed(self, tid: int, wid: int) -> None:
        sheddable, tier = self.tenancy.get(tid, (True, 0))
        if tier == 0:
            self._flag(f"gold-tier trajectory {tid} was shed (tenancy "
                       f"legality: gold is never shed)")
        if not sheddable:
            self._flag(f"non-sheddable trajectory {tid} was shed")
        if tid in self.where:
            self._flag(f"trajectory {tid} shed while actively generating on "
                       f"worker {self.where[tid]} (only queued work sheds)")
        if self._not_terminal(tid, "shed"):
            self.shed.add(tid)
        self.resident_of.pop(tid, None)

    def _on_harvest(self, tid: int, wid: int) -> None:
        if tid not in self.finished:
            self._flag(f"harvest of trajectory {tid} before it finished "
                       f"(the consumer would train on a partial episode)")
        if tid in self.harvested:
            self._flag(f"trajectory {tid} harvested twice (duplicate sample)")
        self.harvested.add(tid)

    def _on_weight_sync(self, epoch: int, wid: int) -> None:
        """The note's tid slot carries the applied epoch, not a trajectory."""
        if not self.alive[wid]:
            self._flag(f"weight sync applied to dead worker {wid}")
        if self.active[wid]:
            self._flag(f"weight sync on worker {wid} with steps in progress "
                       f"{sorted(self.active[wid])}: the drain fence leaked")
        held = sorted(t for t, w in self.resident_of.items() if w == wid)
        if held:
            self._flag(f"weight sync on worker {wid} holding resident "
                       f"trajectories {held}: the drain fence leaked")
        if epoch <= self.worker_epoch[wid]:
            self._flag(f"worker {wid} applied weight epoch went backwards "
                       f"({self.worker_epoch[wid]} -> {epoch}): applied "
                       f"epochs must be strictly monotone")
        self.worker_epoch[wid] = epoch
        self.weight_syncs += 1

    def _on_degrade(self, tid: int, wid: int) -> None:
        _, tier = self.tenancy.get(tid, (True, 0))
        if tier == 0:
            self._flag(f"gold-tier trajectory {tid} was degraded (the ladder "
                       f"must not touch gold)")
        self._not_terminal(tid, "degradation")

    _HANDLERS = {
        "start": _on_start,
        "preempt": _on_preempt,
        "step": _on_step,
        "finish": _on_finish,
        "tool_done": _on_tool_done,
        "migrate": _on_migrate,
        "migrate_done": _on_migrate_done,
        "recover": _on_recover,
        "restore_done": _on_restore_done,
        "worker_death": _on_worker_death,
        "worker_up": _on_worker_up,
        "arrival": _on_arrival,
        "admit": _on_admit,
        "defer": _on_defer,
        "shed": _on_shed,
        "degrade": _on_degrade,
        "harvest": _on_harvest,
        "weight_sync": _on_weight_sync,
    }

    # ------------------------------------------------------------ teardown
    def finalize(self, strict: bool = True) -> dict:
        """End-of-run balance checks; raises on any accumulated violation."""
        t0 = perf_counter()
        for tid, dst in sorted(self.pending_migration.items()):
            self._flag(f"trajectory {tid} still on the wire to worker {dst} "
                       f"at drain (migration commit/abort imbalance)")
        for tid, dst in sorted(self.pending_restore.items()):
            self._flag(f"trajectory {tid} still restoring onto worker {dst} "
                       f"at drain")
        for wid, acts in enumerate(self.active):
            if acts:
                self._flag(f"worker {wid} drained with active trajectories "
                           f"{sorted(acts)} (slot leak)")
        self.wall_s += perf_counter() - t0
        if strict and self._total_violations:
            raise TraceViolationError(self._violations, self._total_violations)
        return self.report()

    def report(self) -> dict:
        return {
            "events": self.events,
            "violations": self._total_violations,
            "stale_worker_events": self.stale_worker_events,
            "migrations": {
                "launched": self.migrate_launches,
                "committed": self.migrate_commits,
                "aborted": self.migrate_aborts,
            },
            "harvests": len(self.harvested),
            "weight_syncs": self.weight_syncs,
            "wall_s": self.wall_s,
        }


def check_block_conservation(worker_stats: dict) -> list[str]:
    """Paged-pool drain check: every block reference must be accounted for.

    Consumes the ``blocks_*`` occupancy counters paged engines merge into
    ``dispatch_stats()`` (workers without them — dense fallback, sim — are
    skipped) and enforces, per worker:

    * ``allocated_total - freed_total == resident + shared`` — cumulative
      reference increments minus decrements equals live references (a
      mismatch is a leaked or double-freed block);
    * ``total == free + resident`` — distinct blocks partition exactly into
      the free heap and the resident set.

    Returns violation strings (empty = conserved); the runtime raises
    :class:`TraceViolationError` on any when ``sanitize`` is on.
    """
    out: list[str] = []
    for wid in sorted(worker_stats):
        s = worker_stats[wid]
        if "blocks_allocated_total" not in s:
            continue
        live = s["blocks_allocated_total"] - s["blocks_freed_total"]
        held = s["blocks_resident"] + s["blocks_shared"]
        if live != held:
            out.append(
                f"worker {wid}: block-reference leak — allocated "
                f"{s['blocks_allocated_total']} - freed "
                f"{s['blocks_freed_total']} = {live} live refs, but resident "
                f"{s['blocks_resident']} + shared {s['blocks_shared']} = {held}")
        if s["blocks_total"] != s["blocks_free"] + s["blocks_resident"]:
            out.append(
                f"worker {wid}: block partition broken — total "
                f"{s['blocks_total']} != free {s['blocks_free']} + resident "
                f"{s['blocks_resident']}")
    return out


__all__ = ["TraceSanitizer", "TraceViolationError", "check_block_conservation"]
