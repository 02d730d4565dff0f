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


def mamba_scan_bwd_ref(dt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
                       x: torch.Tensor, a_log: torch.Tensor, g_y: torch.Tensor | None,
                       g_h: torch.Tensor | None = None):
    """The selective scan's backward, one time step after another in f32.

    Takes ``mamba_scan_ref``'s inputs and the gradients of its two outputs,
    ``g_y`` (B, S, di) and ``g_h`` (B, di, N), either None for zeros.  With
    a_t = exp(dt_t A) and u_t = dt_t x_t it recomputes every state h_t
    (B S di N floats: a reference for small shapes), then runs the adjoint
    lambda_t = dL/dh_t backwards in time:

        lambda_{S-1} = g_y,S-1 (x) C_{S-1} + g_h
        lambda_t     = g_y,t (x) C_t + a_{t+1} lambda_{t+1}
        dC_t[n]  = sum_d g_y,t[d] h_t[d, n]      dB_t[n] = sum_d lambda_t[d, n] u_t[d]
        dx_t[d]  = dt_t[d] sum_n lambda_t[d, n] B_t[n]
        ddt_t[d] = sum_n lambda_t[d, n] (A[d, n] a_t h_{t-1} + x_t[d] B_t[n])
        dA_log   = A sum_{b, t} lambda_t dt_t a_t h_{t-1}

    Returns (d dt, dB, dC, dx, dA_log): d dt and dA_log in f32, the others
    in their inputs' dtypes (summed in f32, cast once at the end).
    """
    B, S, di = dt.shape
    N = a_log.shape[-1]
    dev = dt.device
    A = -torch.exp(a_log.to(F32))
    dtf, xf, bf, cf = (t.to(F32) for t in (dt, x, b_in, c_in))
    gy = torch.zeros((B, S, di), dtype=F32, device=dev) if g_y is None else g_y.to(F32)
    u = dtf * xf
    h = torch.zeros((B, di, N), dtype=F32, device=dev)
    states = [h]                                       # states[t + 1] = h_t
    for t in range(S):
        h = torch.exp(dtf[:, t, :, None] * A) * h + u[:, t, :, None] * bf[:, t, None, :]
        states.append(h)
    d_dt = torch.empty((B, S, di), dtype=F32, device=dev)
    d_x = torch.empty((B, S, di), dtype=F32, device=dev)
    d_b = torch.empty((B, S, N), dtype=F32, device=dev)
    d_c = torch.empty((B, S, N), dtype=F32, device=dev)
    d_a = torch.zeros((di, N), dtype=F32, device=dev)
    carry = torch.zeros((B, di, N), dtype=F32, device=dev) if g_h is None else g_h.to(F32)
    for t in reversed(range(S)):
        a_t = torch.exp(dtf[:, t, :, None] * A)
        lam = gy[:, t, :, None] * cf[:, t, None, :] + carry
        d_c[:, t] = torch.einsum("bdn,bd->bn", states[t + 1], gy[:, t])
        d_b[:, t] = torch.einsum("bdn,bd->bn", lam, u[:, t])
        du = torch.einsum("bdn,bn->bd", lam, bf[:, t])
        d_x[:, t] = dtf[:, t] * du
        q = lam * a_t * states[t]
        d_dt[:, t] = torch.einsum("bdn,dn->bd", q, A) + xf[:, t] * du
        d_a += torch.einsum("bdn,bd->dn", q, dtf[:, t])
        carry = a_t * lam
    return (d_dt, d_b.to(b_in.dtype), d_c.to(c_in.dtype), d_x.to(x.dtype), A * d_a)
