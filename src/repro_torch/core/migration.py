"""Trajectory migration (paper §5.3).

Two pieces:

1. **Rank-based re-placement** — when the progressive predictor updates a trajectory's
   length, we avoid re-running the full DP: the original partition sizes {s_1..s_m} are
   scaled by the fraction of still-active trajectories (s_i * n_active / n), and the
   trajectory's *new rank* in the sorted order is mapped through the scaled cumulative
   capacities to a target worker.  Migrate iff target != current host.

2. **Transmission scheduler** — migrations transfer KV caches between workers; to prevent
   endpoint contention the router builds batches of strictly parallel, *endpoint-exclusive*
   requests, greedily picking the longest trajectory first and skipping any request whose
   source or destination worker is already busy (selected in this epoch or still running).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


@dataclass
class MigrationRequest:
    traj_id: int
    src: int
    dst: int
    length: float            # predicted trajectory length (priority key)
    bytes: float = 0.0       # KV cache size to move
    submitted: float = 0.0


class ScaledCapacityRouter:
    """Maps (new rank, active count) -> worker via proportionally scaled group sizes."""

    def __init__(self, group_sizes: Sequence[int]):
        self.group_sizes = np.asarray(group_sizes, dtype=np.float64)
        self.n_total = float(self.group_sizes.sum())

    def worker_for_rank(self, rank: int, n_active: int) -> int:
        """Worker index whose scaled capacity interval contains ``rank`` (0-based).

        Effective capacity of group i is s_i * n_active / n_total (paper §5.3); ranks are
        assigned to workers in order of the (descending-length-sorted) original partition.
        """
        if self.n_total == 0:
            return 0
        scale = n_active / self.n_total
        cum = 0.0
        for i, s in enumerate(self.group_sizes):
            cum += s * scale
            if rank < cum - 1e-9 or cum >= n_active - 1e-9:
                return i
        return len(self.group_sizes) - 1

    def target_worker(self, predicted_lengths: dict[int, float], traj_id: int) -> int:
        """Rank ``traj_id`` among active trajectories by descending predicted length."""
        items = sorted(predicted_lengths.items(), key=lambda kv: (-kv[1], kv[0]))
        rank = next(i for i, (tid, _) in enumerate(items) if tid == traj_id)
        return self.worker_for_rank(rank, len(items))


@dataclass
class TransmissionScheduler:
    """Endpoint-exclusive, longest-first migration batching (paper §5.3)."""

    pending: list[MigrationRequest] = field(default_factory=list)
    running: list[MigrationRequest] = field(default_factory=list)

    def submit(self, req: MigrationRequest) -> None:
        if req.src == req.dst:
            return
        # replace any stale pending request for the same trajectory: the newest
        # prediction owns the target (prevents outdated requests firing later and
        # ping-ponging the trajectory between old targets)
        self.pending = [r for r in self.pending if r.traj_id != req.traj_id]
        self.pending.append(req)

    def cancel(self, traj_id: int) -> None:
        self.pending = [r for r in self.pending if r.traj_id != traj_id]

    def next_batch(self) -> list[MigrationRequest]:
        """One scheduling epoch: greedily select non-conflicting requests, longest first.

        A request conflicts if its src or dst worker appears as an endpoint of any
        already-selected or still-running request (strict endpoint exclusivity).
        """
        busy: set[int] = set()
        for r in self.running:
            busy.add(r.src)
            busy.add(r.dst)
        batch: list[MigrationRequest] = []
        remaining: list[MigrationRequest] = []
        for req in sorted(self.pending, key=lambda r: -r.length):
            if req.src in busy or req.dst in busy:
                remaining.append(req)
            else:
                batch.append(req)
                busy.add(req.src)
                busy.add(req.dst)
        self.pending = remaining
        self.running.extend(batch)
        return batch

    def complete(self, traj_id: int) -> None:
        self.running = [r for r in self.running if r.traj_id != traj_id]

    def __len__(self) -> int:
        return len(self.pending)


def migration_time(kv_bytes: float, link_bandwidth: float, base_latency: float = 1e-3) -> float:
    """Transfer time model for a KV-cache migration over one interconnect link."""
    return base_latency + kv_bytes / link_bandwidth


def kv_cache_bytes(context_tokens: int, n_layers: int, n_kv_heads: int, head_dim: int,
                   bytes_per_el: int = 2) -> float:
    """KV cache footprint of a trajectory: 2 (K and V) * L * kv * hd * ctx * dtype."""
    return 2.0 * n_layers * n_kv_heads * head_dim * context_tokens * bytes_per_el
