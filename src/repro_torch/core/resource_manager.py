"""Trajectory-adaptive resource manager (paper §6, Algorithm 2).

Breaks the rigid homogeneous-MP constraint: a total accelerator budget N is carved into m
workers with model-parallel degrees {N_1..N_m} drawn from a discrete set D.  Long-tail
partitions map to high-MP workers (low per-token time T), short partitions to low-MP
workers (high aggregate throughput).

The joint (partition, allocation) problem is decoupled (paper §6.1):
  * **mapping** — sort both the DP partitions (by length, §5.2 already does) and the
    workers (by MP degree, descending) and zip them;
  * **allocation** — *sort-initialized simulated annealing*: start from a random sorted
    allocation, perturb with redistribute / split / merge moves, evaluate each candidate
    by running the presorted DP with the candidate's per-worker token-time vector, accept
    worse states with probability exp(-delta/T), cool by alpha until T < eps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.core.placement import InterferenceModel, PlacementResult, presorted_dp


@dataclass(frozen=True)
class WorkerLatencyModel:
    """Per-token decode latency as a function of model-parallel degree.

    t(mp) = t1 * ((1 - overlap) / mp + overlap): scaling the model axis divides the
    weight/KV read time by mp but leaves a non-scalable fraction (ICI latency,
    layernorms, sampling).  This reproduces the Fig. 7 latency-throughput trade-off:
    per-token time falls with mp while per-chip throughput (1 / (t * mp)) falls too.
    """

    t1: float = 1.0              # per-token seconds at mp=1, batch=1
    overlap: float = 0.22        # non-scalable latency fraction (calibrated to the
                                 # paper's Fig 7 latency-throughput trade-off)
    comm_batch_coef: float = 0.087   # TP all-reduce volume scales with batch

    def base_token_time(self, mp: int, batch: float = 1.0) -> float:
        """Per-token time at MP degree ``mp`` and typical batch ``batch``.

        The batch-scaled comm term keeps the control-plane model consistent with the
        data plane: high MP buys latency at small batch but pays growing all-reduce
        volume at saturation (Fig 7)."""
        comm = self.overlap * (1.0 + self.comm_batch_coef * max(batch - 1.0, 0.0))             if mp > 1 else self.overlap
        return self.t1 * ((1.0 - self.overlap) / mp + comm)

    def token_times(self, degrees: Sequence[int], batch: float = 1.0) -> np.ndarray:
        return np.asarray([self.base_token_time(d, batch) for d in degrees],
                          dtype=np.float64)

    @classmethod
    def fit(cls, observations: Sequence[tuple[int, float, float]],
            comm_batch_coef: float = 0.087) -> "WorkerLatencyModel":
        """Least-squares ``(t1, overlap)`` from measured per-worker decode timing.

        ``observations`` are ``(mp, batch, per_step_seconds)`` samples — the
        engine's warm-call ``dispatch_stats`` feed (``decode_wall_s /
        decode_timed_steps`` at the worker's declared MP degree and mean live
        batch; one masked full-pool step advances every live lane one token, so
        per-step time is the per-sequence token time the control plane prices).
        The model is linear in ``u = t1`` and ``v = t1 * overlap``:

            t(mp, b) = u / mp + v * (c(mp, b) - 1 / mp),
            c(mp, b) = 1 + comm_batch_coef * max(b - 1, 0)  if mp > 1 else 1,

        so ordinary least squares recovers both, replacing the Fig. 7 constants
        with observed behavior.  With a single distinct MP degree the system is
        degenerate; ``overlap`` keeps its prior and only ``t1`` is re-scaled to
        match the observed mean.  Fitted values are clamped to the physical
        range (t1 > 0, 0 <= overlap <= 0.95).
        """
        obs = [(int(mp), float(b), float(t)) for mp, b, t in observations
               if t > 0.0 and int(mp) >= 1]
        if not obs:
            raise ValueError("WorkerLatencyModel.fit needs at least one "
                             "positive-time observation")

        def c_term(mp: int, b: float) -> float:
            return 1.0 + comm_batch_coef * max(b - 1.0, 0.0) if mp > 1 else 1.0

        prior = cls(comm_batch_coef=comm_batch_coef)
        if len({mp for mp, _, _ in obs}) == 1:
            # shape is per-observation: samples at different batches carry
            # different comm terms, so divide each out before averaging
            ratios = [t / ((1.0 - prior.overlap) / mp
                           + prior.overlap * c_term(mp, b))
                      for mp, b, t in obs]
            return cls(t1=max(float(np.mean(ratios)), 1e-12),
                       overlap=prior.overlap,
                       comm_batch_coef=comm_batch_coef)
        design = np.asarray([[1.0 / mp, c_term(mp, b) - 1.0 / mp]
                             for mp, b, _ in obs], dtype=np.float64)
        target = np.asarray([t for _, _, t in obs], dtype=np.float64)
        (u, v), *_ = np.linalg.lstsq(design, target, rcond=None)
        if u <= 0.0:                     # pathological sample: keep prior shape
            return cls(t1=max(float(target.mean()), 1e-12),
                       overlap=prior.overlap, comm_batch_coef=comm_batch_coef)
        overlap = float(np.clip(v / u, 0.0, 0.95))
        return cls(t1=float(u), overlap=overlap,
                   comm_batch_coef=comm_batch_coef)


@dataclass
class AllocationResult:
    degrees: list[int]               # {N_1..N_m}, descending
    makespan: float
    placement: PlacementResult
    history: list[float] = field(default_factory=list)   # best-so-far per iteration
    evaluations: int = 0


def _random_allocation(rng: np.random.Generator, budget: int, degrees: Sequence[int]
                       ) -> list[int]:
    """Sample N_i ~ D until the budget is exactly consumed (Alg. 2 line 1)."""
    degrees = sorted(degrees)
    alloc: list[int] = []
    remaining = budget
    while remaining > 0:
        feasible = [d for d in degrees if d <= remaining]
        d = int(rng.choice(feasible))
        alloc.append(d)
        remaining -= d
    return sorted(alloc, reverse=True)


def _perturb(rng: np.random.Generator, alloc: list[int], degrees: Sequence[int]
             ) -> list[int]:
    """One of three moves (Alg. 2 line 6): redistribute / split / merge."""
    degrees = set(degrees)
    alloc = list(alloc)
    moves = ["redistribute", "split", "merge"]
    rng.shuffle(moves)
    for move in moves:
        if move == "split":
            cands = [i for i, d in enumerate(alloc) if d // 2 in degrees and d >= 2]
            if cands:
                i = int(rng.choice(cands))
                d = alloc.pop(i)
                alloc.extend([d // 2, d // 2])
                return sorted(alloc, reverse=True)
        elif move == "merge":
            if len(alloc) >= 2:
                by_deg: dict[int, list[int]] = {}
                for i, d in enumerate(alloc):
                    by_deg.setdefault(d, []).append(i)
                cands = [d for d, idxs in by_deg.items()
                         if len(idxs) >= 2 and 2 * d in degrees]
                if cands:
                    d = int(rng.choice(cands))
                    i, j = by_deg[d][:2]
                    alloc = [x for k, x in enumerate(alloc) if k not in (i, j)]
                    alloc.append(2 * d)
                    return sorted(alloc, reverse=True)
        else:  # redistribute: halve a donor, double a same-size receiver elsewhere
            if len(alloc) >= 2:
                pairs = [(i, j) for i, di in enumerate(alloc) for j, dj in enumerate(alloc)
                         if i != j and di // 2 in degrees and di >= 2
                         and dj + di // 2 in degrees]
                if pairs:
                    i, j = pairs[int(rng.integers(len(pairs)))]
                    give = alloc[i] // 2
                    alloc[i] -= give
                    alloc[j] += give
                    return sorted(alloc, reverse=True)
    return sorted(alloc, reverse=True)   # no feasible move: return unchanged


def sort_initialized_sa(
    lengths: Sequence[float],
    budget: int,
    interference: InterferenceModel,
    latency: WorkerLatencyModel | None = None,
    degrees: Sequence[int] = (1, 2, 4, 8),
    cooling: float = 0.95,
    eps_frac: float = 1e-3,
    max_workers: int | None = None,
    counts: Sequence[int] | None = None,
    seed: int = 0,
    work_aware: bool = False,
    max_group_count: float | None = None,
) -> AllocationResult:
    """Algorithm 2: sort-initialized simulated annealing over MP allocations."""
    latency = latency or WorkerLatencyModel()
    rng = np.random.default_rng(seed)

    n_total = float(np.sum(counts)) if counts is not None else float(len(lengths))
    counts_arr = (np.asarray(counts, dtype=np.float64) if counts is not None
                  else np.ones(len(lengths)))

    def evaluate(alloc: list[int]) -> tuple[float, PlacementResult]:
        if max_workers is not None and len(alloc) > max_workers:
            return math.inf, None   # infeasible: too many workers for the slot count
        # two-pass pricing: first DP at the average batch, then re-price each worker's
        # token time at its actual group size (high-MP tail workers run small batches,
        # mp1 bulk workers big ones — a single average misprices both)
        avg_batch = n_total / max(len(alloc), 1)
        res = presorted_dp(lengths, len(alloc), interference,
                           base_token_time=latency.token_times(alloc, avg_batch),
                           counts=counts,
                           work_aware=work_aware, max_group_count=max_group_count)
        group_counts = [max(sum(counts_arr[i] for i in g), 1.0) for g in res.groups]
        tt2 = np.asarray([latency.base_token_time(mp, c)
                          for mp, c in zip(alloc, group_counts)])
        res2 = presorted_dp(lengths, len(alloc), interference, base_token_time=tt2,
                            counts=counts, work_aware=work_aware,
                            max_group_count=max_group_count)
        return res2.makespan, res2

    alloc = _random_allocation(rng, budget, degrees)           # line 1-2
    cost, placement = evaluate(alloc)                          # line 3
    while not math.isfinite(cost):                             # re-sample if infeasible
        alloc = _random_allocation(rng, budget, degrees)
        cost, placement = evaluate(alloc)
    temp = cost                                                # line 4
    best_cost, best_alloc, best_placement = cost, alloc, placement
    eps = eps_frac * cost
    history = [best_cost]
    evals = 1

    while temp > eps:                                          # line 5
        cand = _perturb(rng, alloc, degrees)                   # lines 6-7 (sorted inside)
        cand_cost, cand_placement = evaluate(cand)             # line 8
        evals += 1
        delta = cand_cost - cost                               # line 9
        if math.isfinite(cand_cost) and (
                delta < 0 or rng.random() < math.exp(-delta / max(temp, 1e-12))):
            alloc, cost = cand, cand_cost                      # line 11
            if cost < best_cost:                               # lines 12-13
                best_cost, best_alloc, best_placement = cost, alloc, cand_placement
        temp *= cooling                                        # line 14
        history.append(best_cost)

    return AllocationResult(best_alloc, best_cost, best_placement, history, evals)


def homogeneous_allocation(budget: int, mp: int) -> list[int]:
    """Fix-k baseline (§7.4): all workers share one MP degree."""
    if budget % mp:
        raise ValueError(f"budget {budget} not divisible by mp {mp}")
    return [mp] * (budget // mp)
