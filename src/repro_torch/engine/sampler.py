"""Temperature / top-p token sampling (counterpart of ``repro/engine/sampler.py``).

Two entry points:

  * ``sample``        -- one shared key for a (B, V) batch.
  * ``sample_slots``  -- every lane drawn from its own key (``engine.prng``), so a
    lane's token stream is a pure function of (its key, its context) and survives
    re-batching, preemption and migration.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.engine import prng


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 1.0
    top_p: float = 0.9


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask logits outside the smallest prefix with cumulative mass >= top_p."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff_idx = torch.argmax((cum >= top_p).to(torch.int8), dim=-1)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx[..., None])
    return torch.where(logits < cutoff, torch.full_like(logits, -torch.inf), logits)


def sample(key: torch.Tensor, logits: torch.Tensor, cfg: SamplerConfig = SamplerConfig()
           ) -> torch.Tensor:
    """logits: (B, V) -> tokens (B,) int32, one Gumbel draw over the whole
    (B, V) from the one (2,) ``key``: ``jax.random.categorical(key, logits)``
    numbers a (B, V) array's elements row-major, so its noise is
    ``random_bits(key, B * V)`` cut into rows."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.to(torch.float32) / cfg.temperature
    if cfg.top_p < 1.0:
        scaled = top_p_filter(scaled, cfg.top_p)
    noise = prng.gumbel(key.to(scaled.device), scaled.numel()).reshape(scaled.shape)
    return torch.argmax(noise + scaled, dim=-1).to(torch.int32)


def sample_slots(keys: torch.Tensor, logits: torch.Tensor,
                 cfg: SamplerConfig = SamplerConfig(),
                 active: torch.Tensor | None = None) -> torch.Tensor:
    """Masked per-slot sampling.

    keys: (B, 2) per-slot keys (``engine.prng``); logits: (B, V); active:
    optional (B,) bool.  Returns (B,) int32; inactive lanes yield -1.
    """
    if cfg.temperature <= 0.0:
        toks = torch.argmax(logits, dim=-1)
    else:
        scaled = logits.to(torch.float32) / cfg.temperature
        if cfg.top_p < 1.0:
            scaled = top_p_filter(scaled, cfg.top_p)
        toks = prng.categorical(keys, scaled)
    toks = toks.to(torch.int32)
    if active is not None:
        toks = torch.where(active, toks, torch.full_like(toks, -1))
    return toks
