"""The Gumbel noise a sampled token was drawn with, worked out from the run's seed.

A served token is ``argmax(logits / temperature + g)`` over the vocabulary,
where ``g`` is standard Gumbel noise from a counter-based generator: the
Threefry-2x32 hash (20 rounds; Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC 2011) in the key and counter layout of ``jax.random``
(``PRNGKey``, ``fold_in``, ``bits`` with the partitionable layout, and
``uniform``'s 23-bit mantissa fill).  A lane's key is ``fold_in(PRNGKey(seed
+ worker), sequence id)``, and the step that feeds position ``p`` draws with
``fold_in(lane key, p)``.  Values are uint32 words held in int64 tensors.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
TINY = torch.finfo(torch.float32).tiny


def threefry(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds, a key injection every 4."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0, x1 = (x0 + k0) & M32, (x1 + k1) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key(seed: int, device) -> torch.Tensor:
    """``PRNGKey(seed)``: the high and low 32-bit words of the seed."""
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Keys (..., 2) folded with ``data`` (...): the hash of (0, data)."""
    data = data.to(torch.int64) & M32
    y0, y1 = threefry(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def noise(k: torch.Tensor, n: int) -> torch.Tensor:
    """Gumbel noise (rows of ``n``) for each key of (R, 2), float32."""
    counts = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry(k[:, 0, None], k[:, 1, None], torch.zeros_like(counts), counts)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(u * (1.0 - TINY) + TINY, min=TINY)
    return -torch.log(-torch.log(u))


def step_noise(seed: int, worker: int, seq_ids: torch.Tensor, positions: torch.Tensor,
               vocab: int) -> torch.Tensor:
    """(R, vocab) noise of the steps that fed ``positions`` of lanes
    ``seq_ids`` on worker ``worker`` of a run seeded ``seed``."""
    base = key(seed + worker, seq_ids.device)
    lane = fold_in(base.expand(seq_ids.shape[0], 2), seq_ids)
    return noise(fold_in(lane, positions), vocab)
