"""Decode-throughput profiler (paper §5.2 'Interference Factor').

Counterpart of ``repro/engine/profiler.py``.  The paper derives F(batch) by
profiling per-token time across batch sizes and feeding a simulator.  This
module does that against the port's model: batched decode steps at
increasing batch sizes, yielding an ``InterferenceModel`` the placement DP /
SA can consume.

    profile = profile_decode(cfg, params, batch_sizes=(1, 2, 4, 8, 16))
    interference = InterferenceModel.from_profile(profile)

It runs on the card unless ``device="cpu"`` (the params must lie on that
device).  A CPU profile times PyTorch's CPU kernels and is no device number.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from repro_torch.core.placement import InterferenceModel
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def profile_decode(cfg: ModelConfig, params, batch_sizes: Sequence[int] = (1, 2, 4, 8),
                   capacity: int = 128, context: int = 64, steps: int = 8,
                   warmup: int = 2, seed: int = 0, device=None) -> dict[int, float]:
    """Measure per-token decode time (seconds) at each batch size.

    Each sequence carries ``context`` cached tokens so the KV-read component of the
    interference (the term that grows with batch) is actually exercised.  The
    prompt tokens come from a ``torch.Generator`` seeded with ``seed``; their
    values differ from ``jax.random.randint``'s in the JAX package, which
    changes only what is timed, not any decision.
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    profile: dict[int, float] = {}
    for b in batch_sizes:
        tokens = torch.randint(0, cfg.vocab, (b, context), generator=gen,
                               dtype=torch.int32).to(dev)
        _, _, cache = M.forward_full(cfg, params, {"tokens": tokens}, capacity=capacity)
        tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        for _ in range(warmup):                      # stabilize
            _, cache = M.decode_step(cfg, params, cache, tok)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            _, cache = M.decode_step(cfg, params, cache, tok)
        _sync(dev)
        profile[b] = (time.perf_counter() - t0) / steps
        del cache
    return profile


def interference_from_profile(profile: dict[int, float]) -> InterferenceModel:
    """The paper's F(batch) from a ``profile_decode`` profile."""
    # enforce monotonicity (timer noise at tiny models): running max
    mono, best = {}, 0.0
    for b in sorted(profile):
        best = max(best, profile[b])
        mono[b] = best
    return InterferenceModel.from_profile(mono)


def measured_interference(cfg: ModelConfig, params, **kw) -> InterferenceModel:
    """One-call helper: profile the model, return the paper's F(batch)."""
    return interference_from_profile(profile_decode(cfg, params, **kw))
