"""Counter-based sampling keys: ``jax.random``'s threefry2x32 scheme in tensor ops.

A key is a pair of 32-bit words, held here in int64 tensors masked to 32 bits
(shape ``(..., 2)``).  The functions reproduce ``jax.random`` bit for bit
under its default ``jax_threefry_partitionable`` layout:

  * ``prng_key(seed)``     -- ``jax.random.PRNGKey(seed)``: ``[seed >> 32, seed & M]``;
  * ``fold_in(key, data)`` -- ``threefry2x32(key, [0, data])``;
  * ``random_bits(key, n)``-- word ``i`` is ``x0 ^ x1`` of ``threefry2x32(key, [0, i])``;
  * ``uniform`` / ``gumbel`` / ``categorical`` -- the float32 construction of
    ``jax.random.uniform(minval=tiny)`` and Gumbel-argmax sampling.

So a lane's token stream is a pure function of ``(seed + worker_id, seq_id,
pos)``, the same in both packages, and independent of what else is batched.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) on int64 tensors holding uint32 values."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a (2,) int64 tensor."""
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``, batched: key (..., 2), data broadcastable to (...)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) uint32 words (int64) of ``jax.random.bits(key, (n,))`` per key."""
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None], torch.zeros_like(counts),
                          counts)
    return y0 ^ y1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0) -> torch.Tensor:
    """float32 in [minval, 1): ``jax.random.uniform(key, (n,), minval=minval)``."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000          # 23 mantissa bits, exponent 0
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(1.0, dtype=torch.float32) - lo
    return torch.maximum(lo.to(key.device), floats * span.to(key.device) + lo.to(key.device))


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """Standard Gumbel noise, ``jax.random.gumbel``'s default ("low") mode."""
    return -torch.log(-torch.log(uniform(key, n, minval=_TINY)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row: key (B, 2), logits (B, V) float32 -> (B,) int64."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
