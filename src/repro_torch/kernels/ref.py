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
