"""Dispatch for the model code: plain version on CPU tensors, kernel on CUDA tensors.

Counterpart of ``repro/kernels/ops.py``.  There is no switch: the device of
the tensors decides, and a CUDA tensor that the kernel cannot take raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           page_table: torch.Tensor, valid_len) -> torch.Tensor:
    """Paged decode: q (B,KV,G,hd) vs block pools (NB,ps,KV,hd) read through a
    (B,num_pages) page table; ``valid_len`` is an int or (B,) int32 tensor."""
    B = q.shape[0]
    vl = torch.as_tensor(valid_len, dtype=torch.int32, device=q.device)
    vl = vl.reshape(-1).expand(B).contiguous()
    return decode_attention.paged_decode_attention(q, k_pool, v_pool, page_table, vl)
