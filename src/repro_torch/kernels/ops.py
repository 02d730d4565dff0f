"""Dispatch for the model code: plain version on CPU tensors, kernel on CUDA tensors.

Counterpart of ``repro/kernels/ops.py``.  There is no switch: the device of
the tensors decides, and a CUDA tensor that the kernel cannot take raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as kernels
from repro_torch.kernels import mamba_scan as scan_kernel


def _valid_len(q: torch.Tensor, valid_len) -> torch.Tensor:
    """An int or any tensor broadcastable to (B,) -> a contiguous (B,) int32
    tensor on q's device."""
    vl = torch.as_tensor(valid_len, dtype=torch.int32, device=q.device)
    return vl.reshape(-1).expand(q.shape[0]).contiguous()


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           page_table: torch.Tensor, valid_len) -> torch.Tensor:
    """Paged decode: q (B,KV,G,hd) vs block pools (NB,ps,KV,hd) read through a
    (B,num_pages) page table; ``valid_len`` is an int or (B,) int32 tensor."""
    return kernels.paged_decode_attention(q, k_pool, v_pool, page_table,
                                         _valid_len(q, valid_len))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len) -> torch.Tensor:
    """Dense decode: q (B,KV,G,hd) vs one period's cache (B,C,KV,hd);
    ``valid_len`` is an int or (B,) int32 tensor."""
    return kernels.decode_attention(q, k, v, _valid_len(q, valid_len))


def mamba_scan(dt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor, x: torch.Tensor,
               a_log: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused selective scan: dt (B,S,di) f32, b_in/c_in (B,S,N), x (B,S,di),
    a_log (di,N).  Returns (y (B,S,di) f32, last state (B,di,N) f32).  The
    projections ``b_in``/``c_in`` are usually column slices of one product;
    they are made contiguous here, as the kernel reads them.

    It has no backward: under grad mode with any input requiring grad it
    raises ``NotImplementedError`` on every device (the kernel's outputs carry
    no ``grad_fn``, so the gradients would be silently wrong; the plain
    version could differentiate, but then the device would change what the
    model computes)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, b_in, c_in, x, a_log)):
        raise NotImplementedError(
            "mamba_scan has no backward: training through the Mamba mixer is queued "
            "(ROADMAP.md Queue 1, slice 6 item 3: a backward for the selective scan)")
    return scan_kernel.mamba_scan(dt.contiguous(), b_in.contiguous(), c_in.contiguous(),
                                  x.contiguous(), a_log.contiguous())
