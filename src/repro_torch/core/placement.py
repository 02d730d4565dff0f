"""Trajectory-aware placement (paper §5): presorted dynamic programming.

Problem (Formula 2): partition n trajectories across m workers minimizing
``max_i F(g_i) * max_len(g_i) * T`` where F is a monotone interference factor of group
size.  Lemma 5.1: with trajectories sorted by descending length, some optimal partition is
contiguous — so the search space drops from Stirling S(n, m) to C(n-1, m-1), and the DP in
Formula 3 resolves it exactly in O(n^2 m).

This module provides:
  * ``InterferenceModel`` — F(batch) from profiler samples or the roofline-analytic
    default (decode per-token time t(b) = t_weights + t_kv*b, so F(b) = t(b)/t(1)).
  * ``presorted_dp``      — the paper's DP (vectorized; optional monotone two-pointer
    speedup, a beyond-paper control-plane optimization recorded in EXPERIMENTS.md §Perf).
  * ``aggregate_short``   — the paper's short-trajectory aggregation heuristic.
  * ``brute_force_partition`` — exact enumeration oracle for tests.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Sequence

import numpy as np


class InterferenceModel:
    """Monotone interference factor F(group_size) (paper §5.2 'Interference Factor').

    The paper profiles per-token time across batch sizes and feeds a simulator; we keep
    the profile as a lookup table with linear interpolation.  The analytic default models
    memory-bound decode: one step reads the weights once (t_w, shared by the batch is NOT
    possible per-token-latency-wise — every decode step costs t_w regardless of batch) plus
    each sequence's KV cache (t_kv each), so step latency t(b) = t_w + t_kv * b and
    F(b) = t(b) / t(1).
    """

    def __init__(self, batch_sizes: Sequence[float], per_token_time: Sequence[float]):
        bs = np.asarray(batch_sizes, dtype=np.float64)
        tt = np.asarray(per_token_time, dtype=np.float64)
        order = np.argsort(bs)
        self._bs, self._tt = bs[order], tt[order]
        if not np.all(np.diff(self._tt) >= -1e-12):
            raise ValueError("per-token time must be monotone non-decreasing in batch size")
        self._base = self._tt[0]

    @classmethod
    def analytic(cls, kv_weight_ratio: float = 0.05, max_batch: int = 4096) -> "InterferenceModel":
        """Roofline default: t(b) = 1 + kv_weight_ratio * b (normalized to t_w = 1)."""
        bs = np.arange(1, max_batch + 1, dtype=np.float64)
        return cls(bs, 1.0 + kv_weight_ratio * bs)

    @classmethod
    def from_profile(cls, profile: dict[int, float]) -> "InterferenceModel":
        items = sorted(profile.items())
        return cls([b for b, _ in items], [t for _, t in items])

    def per_token_time(self, batch: float) -> float:
        return float(np.interp(batch, self._bs, self._tt))

    def __call__(self, group_size: float) -> float:
        if group_size <= 0:
            return 0.0
        return self.per_token_time(group_size) / self._base

    def table(self, n: int) -> np.ndarray:
        """F evaluated at group sizes 0..n (F(0) := 0 so empty groups cost nothing)."""
        sizes = np.arange(n + 1, dtype=np.float64)
        out = np.interp(sizes, self._bs, self._tt) / self._base
        out[0] = 0.0
        return out


@dataclass
class PlacementResult:
    groups: list[list[int]]        # per-worker lists of item indices (into the sorted order)
    makespan: float                # predicted makespan (Formula 2 objective)
    splits: list[int]              # DP split points (prefix sizes), len m
    order: np.ndarray              # indices sorting the original lengths descending


def sort_desc(lengths: Sequence[float]) -> np.ndarray:
    return np.argsort(-np.asarray(lengths, dtype=np.float64), kind="stable")


def presorted_dp(
    lengths: Sequence[float],
    m: int,
    interference: InterferenceModel,
    base_token_time: float | Sequence[float] = 1.0,
    counts: Sequence[int] | None = None,
    monotone_speedup: bool = True,
    max_group_count: float | None = None,
    work_aware: bool = False,
) -> PlacementResult:
    """Formula 3 DP over descending-sorted trajectories.

    ``counts`` supports aggregated items (an item standing for `count` short
    trajectories); group interference is evaluated at the summed count.

    ``base_token_time`` may be a per-worker vector (descending-MP order) — the §6
    heterogeneous extension: worker j's groups cost L * T_j * F.  Workers are consumed
    in order, matching the resource manager's sort-initialized mapping.

    dp[i][j] = optimal makespan for the first i sorted items on j workers:
        dp[i][1] = L(1) * T * F(c_1..i)
        dp[i][j] = min_k max( dp[k][j-1], L(k+1) * T * F(c_{k+1}..i) )

    With lengths descending and F monotone, cost(k+1, i) is non-increasing in k while
    dp[k][j-1] is non-decreasing, so the argmin is locatable by binary search
    (``monotone_speedup``) reducing O(n^2 m) to O(n m log n).

    ``max_group_count`` caps group count at the worker's batch-slot capacity (Formula 2
    models members as co-resident, which only holds within the batch).  ``work_aware``
    (beyond-paper, EXPERIMENTS.md §Perf) strengthens Formula 2's longest-member bound to
        cost(g) = max( F(|g|)*maxlen(g)*T,  total_len(g)*T*F(b)/b ),  b = min(|g|, cap):
    a group's completion can never beat either lower bound, and Formula 2 alone lets the
    DP pile unbounded work behind a small maxlen.  Contiguity (Lemma 5.1) still holds —
    the swap argument only needs group cost non-increasing when a member is swapped for
    a shorter one at equal count, true for both terms.
    """
    lengths = np.asarray(lengths, dtype=np.float64)
    n = len(lengths)
    if n == 0:
        return PlacementResult([[] for _ in range(m)], 0.0, [0] * m, np.array([], dtype=int))
    order = sort_desc(lengths)
    slen = lengths[order]
    scnt = (np.ones(n) if counts is None else np.asarray(counts, dtype=np.float64)[order])
    csum = np.concatenate([[0.0], np.cumsum(scnt)])          # csum[i] = count of first i items
    m_eff = min(m, n)

    if np.ndim(base_token_time) == 0:
        tvec = np.full(m_eff, float(base_token_time))
    else:
        tvec = np.asarray(base_token_time, dtype=np.float64)[:m_eff]
        if len(tvec) < m_eff:
            raise ValueError("per-worker token-time vector shorter than worker count")

    cap = float("inf") if max_group_count is None else float(max_group_count)
    if csum[-1] > cap * m_eff:          # infeasible cap: relax proportionally
        cap = csum[-1] / m_eff * 1.25

    ftab = interference.table(int(round(csum[-1])))

    def fcount(c: np.ndarray | float) -> np.ndarray | float:
        # counts are integral (trajectory counts), so F is a direct table lookup —
        # np.interp here costs ~10x more and dominated the SA loop before this.
        if isinstance(c, np.ndarray):
            return ftab[c.astype(np.int64)]
        return ftab[int(c)]

    # work-conserving term: per-count throughput divisor g(c) = F(min(c,cap)) / min(c,cap)
    wsum = np.concatenate([[0.0], np.cumsum(slen * scnt)])   # total predicted tokens
    gdiv = None
    if work_aware:
        cap_idx = len(ftab) - 1 if not np.isfinite(cap) else int(min(cap, len(ftab) - 1))
        cc = np.minimum(np.arange(len(ftab), dtype=np.float64), max(float(cap_idx), 1.0))
        cc[0] = 1.0
        gdiv = ftab.copy()
        gdiv[1:] = ftab[np.minimum(np.arange(1, len(ftab)), cap_idx)] / cc[1:]

    def gcost_scalar(k, i, T):
        c = csum[i] - csum[k]
        if c > cap:
            return np.inf
        base = slen[k] * T * fcount(c)
        if work_aware and c >= 1:
            base = max(base, (wsum[i] - wsum[k]) * T * gdiv[int(c)])
        return base

    def gcost_vec(ks, i, T):
        c = csum[i] - csum[ks]
        base = slen[ks] * T * fcount(c)
        if work_aware:
            wb = (wsum[i] - wsum[ks]) * T * gdiv[np.maximum(c.astype(np.int64), 1)]
            base = np.maximum(base, wb)
        return np.where(c <= cap, base, np.inf)

    # cost(a, i) = slen[a] * T_j * F(csum[i] - csum[a]) for group = items a..i-1 (0-based)
    dp = np.full((n + 1, m_eff + 1), np.inf)
    arg = np.zeros((n + 1, m_eff + 1), dtype=int)
    dp[0, 0] = 0.0
    # j = 1 row
    dp[1:, 1] = np.array([gcost_scalar(0, i, tvec[0]) for i in range(1, n + 1)])
    for j in range(2, m_eff + 1):
        T = tvec[j - 1]
        if monotone_speedup:
            for i in range(j, n + 1):
                lo, hi = j - 1, i - 1   # k range: previous j-1 workers need >= j-1 items
                # binary search for crossing point of dp[k][j-1] (nondecr) vs cost (nonincr)
                def cost(k):
                    return gcost_scalar(k, i, T)

                while lo < hi:
                    mid = (lo + hi) // 2
                    if dp[mid, j - 1] < cost(mid):
                        lo = mid + 1
                    else:
                        hi = mid
                best_k, best_v = lo, max(dp[lo, j - 1], cost(lo))
                if lo > j - 1:  # check the neighbor on the other side of the crossing
                    v = max(dp[lo - 1, j - 1], cost(lo - 1))
                    if v < best_v:
                        best_k, best_v = lo - 1, v
                dp[i, j], arg[i, j] = best_v, best_k
        else:
            for i in range(j, n + 1):
                ks = np.arange(j - 1, i)
                cand = np.maximum(dp[ks, j - 1], gcost_vec(ks, i, T))
                b = int(np.argmin(cand))
                dp[i, j], arg[i, j] = cand[b], ks[b]

    makespan = float(dp[n, m_eff])
    # backtrack splits
    splits_rev = []
    i = n
    for j in range(m_eff, 0, -1):
        k = int(arg[i, j]) if j > 1 else 0
        splits_rev.append(i)
        i = k
    bounds = [0] + splits_rev[::-1]
    groups: list[list[int]] = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        groups.append([int(order[t]) for t in range(a, b)])
    while len(groups) < m:
        groups.append([])
    return PlacementResult(groups, makespan, bounds[1:] + [n] * (m - m_eff), order)


def aggregate_short(
    lengths: Sequence[float], threshold: float, block: int = 8
) -> tuple[np.ndarray, np.ndarray, list[list[int]]]:
    """Paper §5.2 heuristic: after sorting, coalesce sub-threshold trajectories into
    blocks of ``block`` treated as single DP items (length = block max, count = block size).

    Returns (item_lengths, item_counts, item_members) where members map items back to
    original trajectory indices.
    """
    lengths = np.asarray(lengths, dtype=np.float64)
    order = sort_desc(lengths)
    item_lengths: list[float] = []
    item_counts: list[int] = []
    members: list[list[int]] = []
    i = 0
    n = len(order)
    while i < n:
        idx = int(order[i])
        if lengths[idx] >= threshold:
            item_lengths.append(float(lengths[idx]))
            item_counts.append(1)
            members.append([idx])
            i += 1
        else:
            chunk = [int(order[t]) for t in range(i, min(i + block, n))]
            item_lengths.append(float(lengths[chunk[0]]))  # max of chunk (sorted desc)
            item_counts.append(len(chunk))
            members.append(chunk)
            i += len(chunk)
    return np.asarray(item_lengths), np.asarray(item_counts), members


def place(
    lengths: Sequence[float],
    m: int,
    interference: InterferenceModel,
    base_token_time: float = 1.0,
    agg_threshold: float | None = None,
    agg_block: int = 8,
) -> PlacementResult:
    """Full placement pipeline: optional aggregation -> presorted DP -> expand members."""
    if agg_threshold is None:
        return presorted_dp(lengths, m, interference, base_token_time)
    ilen, icnt, members = aggregate_short(lengths, agg_threshold, agg_block)
    res = presorted_dp(ilen, m, interference, base_token_time, counts=icnt)
    groups = [[orig for item in g for orig in members[item]] for g in res.groups]
    return PlacementResult(groups, res.makespan, res.splits, res.order)


def evaluate_partition(
    groups: Sequence[Sequence[int]],
    lengths: Sequence[float],
    interference: InterferenceModel,
    base_token_time: float | Sequence[float] = 1.0,
) -> float:
    """Formula 2 objective for an arbitrary partition (scalar or per-worker T)."""
    lengths = np.asarray(lengths, dtype=np.float64)
    if np.ndim(base_token_time) == 0:
        tvec = np.full(len(groups), float(base_token_time))
    else:
        tvec = np.asarray(base_token_time, dtype=np.float64)
    worst = 0.0
    for j, g in enumerate(groups):
        if len(g):
            worst = max(worst, interference(len(g)) * float(lengths[list(g)].max())
                        * tvec[j])
    return worst


def brute_force_partition(
    lengths: Sequence[float],
    m: int,
    interference: InterferenceModel,
    base_token_time: float = 1.0,
) -> tuple[list[list[int]], float]:
    """Exact enumeration over all assignments (test oracle; n small)."""
    n = len(lengths)
    best, best_groups = np.inf, None
    for assign in itertools.product(range(m), repeat=n):
        groups: list[list[int]] = [[] for _ in range(m)]
        for t, w in enumerate(assign):
            groups[w].append(t)
        v = evaluate_partition(groups, lengths, interference, base_token_time)
        if v < best:
            best, best_groups = v, groups
    return best_groups, float(best)
