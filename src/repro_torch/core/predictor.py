"""Progressive trajectory prediction (paper §4.1).

The paper fine-tunes a lightweight regression model (Qwen-0.6B) on
``(context, remaining_length)`` tuples harvested from historical trajectories, and invokes
it after every agentic step so that estimates improve monotonically as runtime context
accumulates.

Here the regressor is a ridge regression over the trajectory's runtime feature vector
(`Trajectory.features()`), trained on exactly the same data contract. The *progressive*
property — step-2 predictions beating step-1 predictions beating prompt-only predictions —
comes from the features, not the model class, and is what the paper's Figure 13 measures.

The fit solves the normal equations in numpy float64.  The JAX package solves them in
f32, where rounding dominates (the Gram matrix's condition number reaches ~1e7), so the
two packages' fitted weights differ; given the same fitted state, ``predict`` agrees
exactly, since both evaluate it in numpy float64.  ``predict_batch`` is ``predict`` row
by row here; the JAX package evaluates it in f32, so it agrees to f32 rounding.

Two prompt-only baselines from §7.2 are included:
  * ``HistoryPredictor`` — per-prompt statistical heuristic over historical rollouts
    (Seer / RhymeRL style).
  * ``ModelPredictor``   — regression over *static prompt features only* (TTFT-predictor
    style), i.e. the same model class as Heddle's but blind to runtime context.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.core.trajectory import FEATURE_DIM, Trajectory

_PROMPT_FEATURES = (0, 1)  # bias + prompt_tokens: the only static-analysis features


def _fit_ridge(x: np.ndarray, y: np.ndarray, reg: float) -> np.ndarray:
    """Closed-form ridge regression in float64: (X^T X + reg I)^-1 X^T y."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    gram = x.T @ x + reg * np.eye(x.shape[1])
    return np.linalg.solve(gram, x.T @ y)


@dataclass
class ProgressivePredictor:
    """Heddle's runtime predictor: features fuse prompt + runtime context.

    Train on (features(context_at_step_k), remaining_length_after_step_k) tuples for all k,
    so a single model serves every step index; the features carry the step information.
    Regression is on log1p(remaining): trajectory lengths are multiplicative
    (lognormal difficulty x environment luck), so the log target roughly linearizes
    them and stops the bulk of short trajectories from swamping the tail fit.
    """

    reg: float = 1e-3
    weights: np.ndarray | None = None
    _scale: np.ndarray | None = None
    _resid_var: float = 0.0
    hist_max_tokens: float = 0.0          # longest trajectory seen in training data
    hist_lengths: np.ndarray | None = None  # sorted historical true lengths

    def fit(self, feats: np.ndarray, remaining: np.ndarray) -> "ProgressivePredictor":
        feats = np.asarray(feats, dtype=np.float64)
        remaining = np.asarray(remaining, dtype=np.float64)
        # Feature scaling keeps the Gram matrix well-conditioned.
        self._scale = np.maximum(np.abs(feats).max(axis=0), 1.0)
        y = np.log1p(np.maximum(remaining, 0.0))
        w = _fit_ridge(feats / self._scale, y, self.reg)
        self.weights = w
        resid = y - (feats / self._scale) @ self.weights
        self._resid_var = float(np.var(resid))     # lognormal mean correction
        return self

    def fit_trajectories(self, trajectories: Sequence[Trajectory]) -> "ProgressivePredictor":
        """Harvest (context, remaining_length) tuples from finished trajectories."""
        feats, remaining = harvest(trajectories)
        self.hist_max_tokens = float(max((t.true_total_tokens for t in trajectories),
                                         default=0.0))
        self.hist_lengths = np.sort(np.asarray(
            [t.true_total_tokens for t in trajectories], dtype=np.float64))
        return self.fit(feats, remaining)

    def predict(self, traj: Trajectory) -> float:
        """Predicted *remaining* length (tokens) given the trajectory's current context."""
        assert self.weights is not None, "predictor not fitted"
        f = np.asarray(traj.features(), dtype=np.float64) / self._scale
        y = f @ self.weights + 0.5 * getattr(self, "_resid_var", 0.0)
        return float(np.expm1(np.clip(y, 0.0, 18.0)))

    def predict_batch(self, trajs: Sequence[Trajectory]) -> np.ndarray:
        """``predict`` over many trajectories: row ``i`` is ``predict(trajs[i])``
        exactly (numpy float64, one dot product a row; the JAX package
        evaluates the batch in f32)."""
        assert self.weights is not None, "predictor not fitted"
        return np.asarray([self.predict(t) for t in trajs], dtype=np.float64)


@dataclass
class ModelPredictor:
    """Prompt-only regression baseline (§7.2 'model-based prediction')."""

    reg: float = 1e-3
    weights: np.ndarray | None = None
    _scale: np.ndarray | None = None

    def fit_trajectories(self, trajectories: Sequence[Trajectory]) -> "ModelPredictor":
        feats, remaining = harvest(trajectories, first_step_only=True)
        feats = feats[:, _PROMPT_FEATURES]
        self._scale = np.maximum(np.abs(feats).max(axis=0), 1.0)
        w = _fit_ridge(feats / self._scale, remaining, self.reg)
        self.weights = w
        return self

    def predict(self, traj: Trajectory) -> float:
        f = np.asarray(traj.features(), dtype=np.float64)[list(_PROMPT_FEATURES)] / self._scale
        return float(max(f @ self.weights, 0.0))


@dataclass
class HistoryPredictor:
    """Historical statistics baseline (§7.2 'history-based prediction').

    Estimates every trajectory's total length as the historical mean length for its
    prompt (falling back to the global mean) — static, so it cannot separate the
    divergent samples within a GRPO group (Fig. 5's intra-group variance).
    """

    per_prompt: dict[int, float] = field(default_factory=dict)
    global_mean: float = 0.0

    def fit_trajectories(self, trajectories: Sequence[Trajectory]) -> "HistoryPredictor":
        by_prompt: dict[int, list[int]] = {}
        totals = []
        for t in trajectories:
            by_prompt.setdefault(t.prompt_id, []).append(t.true_total_tokens)
            totals.append(t.true_total_tokens)
        self.per_prompt = {p: float(np.mean(v)) for p, v in by_prompt.items()}
        self.global_mean = float(np.mean(totals)) if totals else 0.0
        return self

    def predict(self, traj: Trajectory) -> float:
        total = self.per_prompt.get(traj.prompt_id, self.global_mean)
        return max(total - traj.tokens_generated, 0.0)


def harvest(trajectories: Sequence[Trajectory], first_step_only: bool = False
            ) -> tuple[np.ndarray, np.ndarray]:
    """Decompose finished trajectories into (context-features, remaining_length) tuples.

    Replays each trajectory's steps to reconstruct the feature vector as it would have
    looked at every step boundary — the paper's training-data harvesting.
    """
    feats: list[list[float]] = []
    remaining: list[float] = []
    for traj in trajectories:
        # reuse the source id: a feature replay IS the same trajectory, and
        # drawing a fresh id would burn the process-global counter (later
        # batches' ids — which seed per-(traj, step) tool outcomes — would
        # then depend on how many harvests ran before them)
        replay = Trajectory(traj_id=traj.traj_id, prompt_id=traj.prompt_id,
                            sample_id=traj.sample_id,
                            prompt_tokens=traj.prompt_tokens,
                            context_tokens=traj.prompt_tokens)
        # step-0 (prompt only) tuple
        feats.append(replay.features())
        remaining.append(float(traj.true_total_tokens))
        if first_step_only:
            continue
        for step in traj.steps:
            replay.record_step(step)
            replay.record_tool_output(step.tool_output_tokens or _tool_tokens(step))
            feats.append(replay.features())
            remaining.append(float(traj.true_total_tokens - replay.tokens_generated))
    if not feats:
        return np.zeros((0, FEATURE_DIM)), np.zeros((0,))
    return np.asarray(feats, dtype=np.float64), np.asarray(remaining, dtype=np.float64)


def _tool_tokens(step) -> int:
    # Tool output size proxy: failed tool calls (e.g. failing tests) emit longer output.
    return int(64 + 192 * step.tool_failed + 8 * step.tool_latency)


# ---------------------------------------------------------------- metrics (Fig. 13)

def long_tail_recall(pred_total: np.ndarray, true_total: np.ndarray, frac: float = 0.1) -> float:
    """Recall of the true top-``frac`` longest trajectories among the predicted top-frac."""
    n = len(true_total)
    k = max(1, int(round(n * frac)))
    true_top = set(np.argsort(-true_total)[:k].tolist())
    pred_top = set(np.argsort(-pred_total)[:k].tolist())
    return len(true_top & pred_top) / k


def pearson(pred: np.ndarray, true: np.ndarray) -> float:
    if len(pred) < 2 or np.std(pred) == 0 or np.std(true) == 0:
        return 0.0
    return float(np.corrcoef(pred, true)[0, 1])
