"""Selective scan: the hand-written Hopper kernel and its wrapper.

``mamba_scan`` (``csrc/mamba_scan.cu``) replaces the TPU kernel
``repro/kernels/mamba_scan.py::mamba_scan_pallas``.  It is compiled by
``nvcc`` on first use into the port's one kernel library (``build.py``) and
called through ``ctypes`` on PyTorch's current stream.

On CPU tensors the wrapper returns the plain version (``ref.py``); on CUDA
tensors it launches the kernel or raises.  ``launches["mamba_scan"]`` counts
the kernel's launches, and nothing else.

``_scan_plan`` chooses, from the shapes and addresses alone, the copy width
of each operand into and out of the kernel's shared-memory tile ring; the
launch passes its choice to the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import KERNELS

launches = {"mamba_scan": 0}

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_STATE_DIMS = (4, 8, 16, 32)          # N built (csrc/mamba_scan.cu's launch)
PLAN_KEYS = ("w_dt", "w_x", "w_b", "w_c", "w_y")


def _copy_width(ptr: int, stride_bytes: int, item: int) -> int:
    """The widest copy in {16, 8, 4} bytes that divides the address and the
    row stride, else the element size (plain loads of a bf16 row that is not
    4-byte aligned)."""
    for w in (16, 8, 4):
        if (ptr | stride_bytes) % w == 0:
            return w
    return min(item, 4)


def _scan_plan(S: int, di: int, N: int, item: int, ptrs) -> dict:
    """The copy widths in bytes of dt, x, B and C (global -> the shared tile
    ring) and of y (the y tile -> global), from the addresses ``ptrs`` = (dt,
    B, C, x, y) and the row strides; x, B and C have ``item`` bytes an
    element, dt and y 4."""
    dt_p, b_p, c_p, x_p, y_p = ptrs
    return {"w_dt": _copy_width(dt_p, 4 * di, 4), "w_x": _copy_width(x_p, item * di, item),
            "w_b": _copy_width(b_p, item * S * N, item),
            "w_c": _copy_width(c_p, item * S * N, item),
            "w_y": _copy_width(y_p, 4 * di, 4)}


def mamba_scan(dt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor, x: torch.Tensor,
               a_log: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """dt (B,S,di), b_in and c_in (B,S,N), x (B,S,di), a_log (di,N).  Returns
    (y (B,S,di) f32, last state (B,di,N) f32).  The kernel takes dt and a_log
    in f32 and x, b_in, c_in all in bf16 or all in f32, contiguous."""
    name = "mamba_scan"
    dev = dt.device
    if dev.type == "cpu":
        return ref.mamba_scan_ref(dt, b_in, c_in, x, a_log)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    tensors = {"dt": dt, "b_in": b_in, "c_in": c_in, "x": x, "a_log": a_log}
    for n, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {n} is on {t.device}, dt on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous (strides {t.stride()})")
    if dt.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise TypeError(f"{name}: dt and a_log must be float32")
    if x.dtype not in _SUFFIX or b_in.dtype != x.dtype or c_in.dtype != x.dtype:
        raise TypeError(f"{name}: x, b_in and c_in must share one dtype, bfloat16 or float32")
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"{name}: want dt and x (B,S,di) of one shape")
    B, S, di = dt.shape
    N = a_log.shape[-1]
    if b_in.shape != (B, S, N) or c_in.shape != (B, S, N) or a_log.shape != (di, N):
        raise ValueError(f"{name}: b_in/c_in (B,S,N) or a_log (di,N) do not fit dt "
                         f"{tuple(dt.shape)}")
    if N not in _STATE_DIMS:
        raise ValueError(f"{name}: state size N = {N} not built ({_STATE_DIMS})")
    y = torch.empty((B, S, di), dtype=torch.float32, device=dev)
    h = torch.empty((B, di, N), dtype=torch.float32, device=dev)
    plan = _scan_plan(S, di, N, x.element_size(),
                      [t.data_ptr() for t in (dt, b_in, c_in, x, y)])
    fn = KERNELS.function(f"{name}_{_SUFFIX[x.dtype]}", 7, 4 + len(PLAN_KEYS))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(dt.data_ptr(), b_in.data_ptr(), c_in.data_ptr(), x.data_ptr(),
                 a_log.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, di, N,
                 *(plan[k] for k in PLAN_KEYS), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1
    return y, h
