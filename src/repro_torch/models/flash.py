"""Flash attention forward as PyTorch ops (counterpart of ``repro/models/flash.py``).

A blocked online softmax over (q block x kv block) pairs: no S x T score
tensor is formed, only one (qb x kb) block at a time.  It is not a Pallas
kernel in the JAX package, so tensor ops suffice here.  The backward (the
JAX package's custom VJP) belongs to the training slice.

Layout: q (B, KV, G, S, hd) -- GQA query heads grouped onto their KV head;
k, v (B, T, KV, hd); positions (S,) / (T,) int (negative = padding).
Masking: causal (q_pos >= k_pos) and optional sliding window
(q_pos - k_pos < window), as an additive -1e30 bias.  Block sizes and the
order of the online-softmax updates are the JAX package's, so the two agree
to float32 rounding.
"""

from __future__ import annotations

import torch

F32 = torch.float32
NEG = -1e30
_INT_MAX = torch.iinfo(torch.int32).max


def _mask_bias(qp: torch.Tensor, kp: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    """Additive (qb, kb) f32 mask: 0 where attendable, -1e30 elsewhere."""
    m = (qp[:, None] >= 0) & (kp[None, :] >= 0) & (kp[None, :] < _INT_MAX)
    if causal:
        m &= qp[:, None] >= kp[None, :]
    if window:
        m &= qp[:, None] - kp[None, :] < window
    return torch.where(m, 0.0, NEG).to(F32)


def _pad_to(x: torch.Tensor, n: int, dim: int, value=0) -> torch.Tensor:
    if x.shape[dim] == n:
        return x
    shape = list(x.shape)
    shape[dim] = n - x.shape[dim]
    return torch.cat([x, x.new_full(shape, value)], dim=dim)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, scale: float,
                    causal: bool, window: int, q_block: int, kv_block: int
                    ) -> torch.Tensor:
    """Blocked attention forward.  Returns (B, KV, G, S, hd) in q's dtype.

    Padding query rows (``q_pos`` -1) see only masked keys; their output is
    finite (an average of values) and is cut off before returning.
    """
    B, KV, G, S, hd = q.shape
    T = k.shape[1]
    qb, kb = min(q_block, S), min(kv_block, T)
    nq, nk = -(-S // qb), -(-T // kb)
    q = _pad_to(q, nq * qb, 3)
    q_pos = _pad_to(q_pos.to(torch.int32), nq * qb, 0, -1)
    k = _pad_to(k, nk * kb, 1)
    v = _pad_to(v, nk * kb, 1)
    kv_pos = _pad_to(kv_pos.to(torch.int32), nk * kb, 0, _INT_MAX)
    outs = []
    for i in range(nq):
        qi = q[:, :, :, i * qb:(i + 1) * qb].to(F32)
        qp = q_pos[i * qb:(i + 1) * qb]
        m = torch.full((B, KV, G, qb), float("-inf"), dtype=F32, device=q.device)
        lsum = torch.zeros((B, KV, G, qb), dtype=F32, device=q.device)
        acc = torch.zeros((B, KV, G, qb, hd), dtype=F32, device=q.device)
        for j in range(nk):
            ki = k[:, j * kb:(j + 1) * kb].to(F32)          # (B, kb, KV, hd)
            vi = v[:, j * kb:(j + 1) * kb].to(F32)
            s = torch.einsum("bkgqd,btkd->bkgqt", qi, ki) * scale
            s = s + _mask_bias(qp, kv_pos[j * kb:(j + 1) * kb], causal, window)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p, vi)
            m = m_new
        outs.append(acc / torch.clamp(lsum, min=1e-30)[..., None])
    return torch.cat(outs, dim=3)[:, :, :, :S].to(q.dtype)
