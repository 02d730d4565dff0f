"""Dispatch for the model code: plain version on CPU tensors, kernel on CUDA tensors.

Counterpart of ``repro/kernels/ops.py``.  There is no switch: the device of
the tensors decides, and a CUDA tensor that the kernel cannot take raises.
On ``meta`` tensors (the dry run) the kernels' shape functions run
(``meta.py``).
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


class _MambaScan(torch.autograd.Function):
    """The scan with its backward: the forward kernel (or plain version) runs
    as without autograd and saves only its five inputs; the backward kernel
    recomputes the states from them (``kernels/mamba_scan.py::mamba_scan_bwd``)."""

    @staticmethod
    def forward(ctx, dt, b_in, c_in, x, a_log):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dt, b_in, c_in, x, a_log)
        return scan_kernel.mamba_scan(dt, b_in, c_in, x, a_log)

    @staticmethod
    def backward(ctx, g_y, g_h):
        grads = [None if g is None else g.float().contiguous() for g in (g_y, g_h)]
        return scan_kernel.mamba_scan_bwd(*ctx.saved_tensors, *grads)


def mamba_scan(dt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor, x: torch.Tensor,
               a_log: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused selective scan: dt (B,S,di) f32, b_in/c_in (B,S,N), x (B,S,di),
    a_log (di,N).  Returns (y (B,S,di) f32, last state (B,di,N) f32).  The
    projections ``b_in``/``c_in`` are usually column slices of one product;
    they are made contiguous here, as the kernel reads them.  Under autograd
    the gradients of all five inputs come from the backward kernel on CUDA
    tensors and from the plain backward on CPU tensors."""
    return _MambaScan.apply(dt.contiguous(), b_in.contiguous(), c_in.contiguous(),
                            x.contiguous(), a_log.contiguous())
