"""Plain PyTorch versions of the port's kernels (the correctness reference).

Counterpart of ``repro/kernels/ref.py``.  They run on any device; the CPU
tests use them, and ``chip_smoke.py`` holds each CUDA kernel against them.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid_len: torch.Tensor) -> torch.Tensor:
    """GQA decode attention.

    q: (B, KV, G, hd) -- one new token's queries, grouped onto KV heads.
    k, v: (B, C, KV, hd) -- KV cache; only the first ``valid_len`` slots count.
    valid_len: (B,) int32.  Products are exact in f32 and sums accumulate in
    f32 (JAX's ``preferred_element_type=F32``).  Returns (B, KV, G, hd).
    """
    B, KV, G, hd = q.shape
    C = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bkgd,bckd->bkgc", q.to(F32), k.to(F32)) * scale
    vl = valid_len.to(q.device).reshape(-1).expand(B)
    mask = torch.arange(C, device=q.device)[None] < vl[:, None]        # (B, C)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p.to(v.dtype).to(F32), v.to(F32))
    return out.to(q.dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, page_table: torch.Tensor,
                               valid_len: torch.Tensor) -> torch.Tensor:
    """Paged decode attention: gather blocks through the page table, then dense.

    q: (B, KV, G, hd); k_pool, v_pool: (NB, page_size, KV, hd); page_table:
    (B, num_pages) int32 (unmapped entries point at scratch block 0, masked by
    ``valid_len``); valid_len: (B,) int32.  Returns (B, KV, G, hd).
    """
    B = q.shape[0]
    num_pages, ps = page_table.shape[1], k_pool.shape[1]
    idx = page_table.long()
    kg = k_pool[idx].reshape(B, num_pages * ps, *k_pool.shape[2:])
    vg = v_pool[idx].reshape(B, num_pages * ps, *v_pool.shape[2:])
    return decode_attention_ref(q, kg, vg, valid_len)


def mamba_scan_ref(dt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
                   x: torch.Tensor, a_log: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan, one time step after another in f32.

    dt, x: (B, S, di) -- softplus'd step sizes and conv'd inputs; b_in, c_in:
    (B, S, N); a_log: (di, N).  With A = -exp(a_log):
    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t and y_t = <h_t, C_t>.
    Returns (y (B, S, di) f32, the last state h (B, di, N) f32).
    """
    B, S, di = dt.shape
    A = -torch.exp(a_log.to(F32))
    h = torch.zeros((B, di, a_log.shape[-1]), dtype=F32, device=dt.device)
    ys = []
    for t in range(S):
        a_t = torch.exp(dt[:, t, :, None].to(F32) * A[None])
        b_t = (dt[:, t] * x[:, t]).to(F32)[..., None] * b_in[:, t].to(F32)[:, None, :]
        h = a_t * h + b_t
        ys.append(torch.einsum("bdn,bn->bd", h, c_in[:, t].to(F32)))
    y = torch.stack(ys, dim=1) if ys else torch.zeros((B, 0, di), dtype=F32, device=dt.device)
    return y, h
