"""Flash attention with a memory-correct backward, as PyTorch ops
(counterpart of ``repro/models/flash.py``).

Forward: a blocked online softmax over (q block x kv block) pairs, which also
returns the log-sum-exp of every query row; it saves only (q, k, v, q_pos,
kv_pos, out, lse) -- O(S) residuals.  Backward: recomputes each block's
scores from them (the flash-attention backward), so training never forms an
S x T score tensor nor keeps the per-block intermediates that autograd
through the forward loop would save.  Neither is a Pallas kernel in the JAX
package (its custom VJP is plain JAX), so tensor ops suffice here.

Layout: q (B, KV, G, S, hd) -- GQA query heads grouped onto their KV head;
k, v (B, T, KV, hd); positions (S,) / (T,) int (negative = padding).
Masking: causal (q_pos >= k_pos) and optional sliding window
(q_pos - k_pos < window), as an additive -1e30 bias.  Block sizes and the
order of every sum are the JAX package's, so the two agree to float32
rounding.
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


def _blocks(S: int, T: int, q_block: int, kv_block: int):
    qb, kb = min(q_block, S), min(kv_block, T)
    return qb, kb, -(-S // qb), -(-T // kb)


def _scores(qi, ki, qp, kp, scale, causal, window):
    """One block's masked f32 scores (B, KV, G, qb, kb)."""
    s = torch.einsum("bkgqd,btkd->bkgqt", qi, ki) * scale
    return s + _mask_bias(qp, kp, causal, window)


def _forward(q, k, v, q_pos, kv_pos, scale, causal, window, q_block, kv_block):
    """(out (B, KV, G, S, hd) in q's dtype, lse (B, KV, G, S) f32).  A row
    that sees no key (a padding row) gets lse 0, as the JAX package gives it."""
    B, KV, G, S, hd = q.shape
    T = k.shape[1]
    qb, kb, nq, nk = _blocks(S, T, q_block, kv_block)
    q = _pad_to(q, nq * qb, 3)
    q_pos = _pad_to(q_pos.to(torch.int32), nq * qb, 0, -1)
    k = _pad_to(k, nk * kb, 1)
    v = _pad_to(v, nk * kb, 1)
    kv_pos = _pad_to(kv_pos.to(torch.int32), nk * kb, 0, _INT_MAX)
    outs, lses = [], []
    for i in range(nq):
        qi = q[:, :, :, i * qb:(i + 1) * qb].to(F32)
        qp = q_pos[i * qb:(i + 1) * qb]
        m = torch.full((B, KV, G, qb), float("-inf"), dtype=F32, device=q.device)
        lsum = torch.zeros((B, KV, G, qb), dtype=F32, device=q.device)
        acc = torch.zeros((B, KV, G, qb, hd), dtype=F32, device=q.device)
        for j in range(nk):
            ki = k[:, j * kb:(j + 1) * kb].to(F32)          # (B, kb, KV, hd)
            vi = v[:, j * kb:(j + 1) * kb].to(F32)
            s = _scores(qi, ki, qp, kv_pos[j * kb:(j + 1) * kb], scale, causal, window)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p, vi)
            m = m_new
        lsum = torch.clamp(lsum, min=1e-30)
        outs.append(acc / lsum[..., None])
        lses.append(torch.where(torch.isfinite(m), m + torch.log(lsum), 0.0))
    out = torch.cat(outs, dim=3)[:, :, :, :S].to(q.dtype)
    return out, torch.cat(lses, dim=3)[..., :S]


def _backward(q, k, v, q_pos, kv_pos, out, lse, dout, scale, causal, window,
              q_block, kv_block):
    """(dq, dk, dv) in the inputs' dtypes, block by block from the residuals:
    ``delta = sum(dout * out)``, ``p = exp(s - lse)``, ``ds = p (dp - delta)
    scale``; dk and dv accumulate in f32 over the q blocks."""
    B, KV, G, S, hd = q.shape
    T = k.shape[1]
    qb, kb, nq, nk = _blocks(S, T, q_block, kv_block)
    delta = (dout.to(F32) * out.to(F32)).sum(-1)                    # (B, KV, G, S)
    qs = _pad_to(q, nq * qb, 3)
    dos = _pad_to(dout, nq * qb, 3)
    lses = _pad_to(lse, nq * qb, 3)
    dels = _pad_to(delta, nq * qb, 3)
    qps = _pad_to(q_pos.to(torch.int32), nq * qb, 0, -1)
    ks = _pad_to(k, nk * kb, 1)
    vs = _pad_to(v, nk * kb, 1)
    kps = _pad_to(kv_pos.to(torch.int32), nk * kb, 0, _INT_MAX)
    dk = torch.zeros((B, nk * kb, KV, hd), dtype=F32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    for i in range(nq):
        rows = slice(i * qb, (i + 1) * qb)
        qi, doi = qs[:, :, :, rows].to(F32), dos[:, :, :, rows].to(F32)
        lsei, deli, qp = lses[..., rows], dels[..., rows], qps[rows]
        dq = torch.zeros((B, KV, G, qb, hd), dtype=F32, device=q.device)
        for j in range(nk):
            cols = slice(j * kb, (j + 1) * kb)
            ki, vi = ks[:, cols].to(F32), vs[:, cols].to(F32)
            s = _scores(qi, ki, qp, kps[cols], scale, causal, window)
            p = torch.exp(s - lsei[..., None])                      # (B, KV, G, qb, kb)
            dp = torch.einsum("bkgqd,btkd->bkgqt", doi, vi)
            ds = p * (dp - deli[..., None]) * scale
            dq = dq + torch.einsum("bkgqt,btkd->bkgqd", ds, ki)
            dk[:, cols] += torch.einsum("bkgqt,bkgqd->btkd", ds, qi)
            dv[:, cols] += torch.einsum("bkgqt,bkgqd->btkd", p, doi)
        dqs.append(dq)
    dq = torch.cat(dqs, dim=3)[:, :, :, :S]
    return dq.to(q.dtype), dk[:, :T].to(k.dtype), dv[:, :T].to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, scale, causal, window, q_block, kv_block):
        out, lse = _forward(q, k, v, q_pos, kv_pos, scale, causal, window, q_block, kv_block)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.args = (scale, causal, window, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, q_pos, kv_pos, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, scale: float,
                    causal: bool, window: int, q_block: int, kv_block: int
                    ) -> torch.Tensor:
    """Blocked attention.  Returns (B, KV, G, S, hd) in q's dtype;
    differentiable in q, k and v through the flash backward.

    Padding query rows (``q_pos`` -1) see only masked keys; their output is
    finite (an average of values) and their lse 0.
    """
    return _FlashAttention.apply(q, k, v, q_pos, kv_pos, scale, causal, window,
                                 q_block, kv_block)
