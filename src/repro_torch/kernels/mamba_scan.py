"""Selective scan: the hand-written Hopper kernels and their wrappers.

``mamba_scan`` (``csrc/mamba_scan.cu``) replaces the TPU kernel
``repro/kernels/mamba_scan.py::mamba_scan_pallas``.  ``mamba_scan_bwd``
(``csrc/mamba_scan_bwd.cu``) is its backward, the port's own: the JAX package
differentiates its plain chunked scan (``repro/models/layers.py:530``) and
has no Pallas backward.  Both are compiled by ``nvcc`` on first use into the
port's one kernel library (``build.py``) and called through ``ctypes`` on
PyTorch's current stream.

On CPU tensors each wrapper returns the plain version (``ref.py``); on CUDA
tensors it launches the kernel or raises; on ``meta`` tensors it runs the
kernel's shape function (``meta.py``: the outputs and scratch of the
kernel's shapes and dtypes, and the call's operations and bytes to the dry
run's tally).  ``launches["mamba_scan"]`` and ``launches["mamba_scan_bwd"]``
count the kernels' real launches, and nothing else.

``_scan_plan`` and ``_scan_bwd_plan`` choose, from the shapes and addresses
alone, the copy width of each operand into and out of the kernels'
shared-memory tile rings; the launch passes the choice to the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import meta, ref
from repro_torch.kernels.build import KERNELS

launches = {"mamba_scan": 0, "mamba_scan_bwd": 0}

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_STATE_DIMS = (4, 8, 16, 32)          # N built (both kernels' launch)
PLAN_KEYS = ("w_dt", "w_x", "w_b", "w_c", "w_y")
BWD_PLAN_KEYS = ("w_dt", "w_x", "w_b", "w_c", "w_gy", "w_ddt", "w_dx")


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


def _scan_bwd_plan(S: int, di: int, N: int, item: int, ptrs) -> dict:
    """The backward's copy widths in bytes: dt, x, B, C and g_y into its tile
    ring, d_dt and d_x out of it, from the addresses ``ptrs`` = (dt, B, C, x,
    g_y, d_dt, d_x) and the row strides (dt, g_y, d_dt f32; x, d_x, B, C
    ``item`` bytes).  With no g_y give dt's address for it: the kernel then
    zero-fills g_y's slots from dt's tile and reads nothing."""
    dt_p, b_p, c_p, x_p, gy_p, ddt_p, dx_p = ptrs
    return {"w_dt": _copy_width(dt_p, 4 * di, 4), "w_x": _copy_width(x_p, item * di, item),
            "w_b": _copy_width(b_p, item * S * N, item),
            "w_c": _copy_width(c_p, item * S * N, item),
            "w_gy": _copy_width(gy_p, 4 * di, 4), "w_ddt": _copy_width(ddt_p, 4 * di, 4),
            "w_dx": _copy_width(dx_p, item * di, item)}


def _check(name: str, dt, b_in, c_in, x, a_log, **grads) -> tuple[int, int, int, int]:
    """Raise unless the kernel takes these CUDA (or ``meta``) tensors: dt and
    a_log (and the gradients ``grads``, None allowed) f32, x, b_in and c_in of
    one dtype, bfloat16 or float32, all contiguous on dt's device.  Returns
    (B, S, di, N)."""
    dev = dt.device
    tensors = {"dt": dt, "b_in": b_in, "c_in": c_in, "x": x, "a_log": a_log,
               **{n: t for n, t in grads.items() if t is not None}}
    for n, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {n} is on {t.device}, dt on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous (strides {t.stride()})")
    if any(t.dtype != torch.float32 for n, t in tensors.items()
           if n not in ("b_in", "c_in", "x")):
        raise TypeError(f"{name}: dt, a_log and the gradients must be float32")
    if x.dtype not in _SUFFIX or b_in.dtype != x.dtype or c_in.dtype != x.dtype:
        raise TypeError(f"{name}: x, b_in and c_in must share one dtype, bfloat16 or float32")
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"{name}: want dt and x (B,S,di) of one shape")
    B, S, di = dt.shape
    N = a_log.shape[-1]
    if b_in.shape != (B, S, N) or c_in.shape != (B, S, N) or a_log.shape != (di, N):
        raise ValueError(f"{name}: b_in/c_in (B,S,N) or a_log (di,N) do not fit dt "
                         f"{tuple(dt.shape)}")
    want = {"g_y": (B, S, di), "g_h": (B, di, N)}
    for n, t in grads.items():
        if t is not None and t.shape != want[n]:
            raise ValueError(f"{name}: {n} {tuple(t.shape)}, want {want[n]}")
    if N not in _STATE_DIMS:
        raise ValueError(f"{name}: state size N = {N} not built ({_STATE_DIMS})")
    return B, S, di, N


def mamba_scan(dt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor, x: torch.Tensor,
               a_log: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """dt (B,S,di), b_in and c_in (B,S,N), x (B,S,di), a_log (di,N).  Returns
    (y (B,S,di) f32, last state (B,di,N) f32).  The kernel takes dt and a_log
    in f32 and x, b_in, c_in all in bf16 or all in f32, contiguous."""
    name = "mamba_scan"
    route = meta.arm(name, dt.device)
    if route == "plain":
        return ref.mamba_scan_ref(dt, b_in, c_in, x, a_log)
    B, S, di, N = _check(name, dt, b_in, c_in, x, a_log)
    dev = dt.device
    y = dt.new_empty((B, S, di))
    h = dt.new_empty((B, di, N))
    if route == "meta":
        meta.report(name, *meta.scan_cost(B, S, di, N, x.element_size()), dt)
        return y, h
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


def bwd_tile(N: int) -> int:
    """Time steps a tile of the backward kernel (``kTile`` in
    ``csrc/mamba_scan_bwd.cu``): 32, or 16 at N 32, so that a tile's states
    take at most 64 KB of shared memory."""
    return min(32, 512 // N)


def bwd_scratch_bytes(B: int, S: int, di: int, N: int) -> int:
    """Bytes of f32 scratch the backward kernel takes: the state entering each
    tile (B, tiles, di, N), the per-channel-tile partials of dB and dC (B,
    ceil(di / 32), S, N) each, and dA_log's per-row partials (B, di, N)
    (``csrc/mamba_scan_bwd.cu``)."""
    tiles = -(-S // bwd_tile(N))
    return 4 * B * (tiles * di * N + 2 * -(-di // 32) * S * N + di * N)


def bwd_occupancy(dtype: torch.dtype, N: int) -> dict:
    """The backward's two passes at x's ``dtype`` and state size N on the
    current CUDA device: each one's dynamic shared memory in bytes a block and
    the blocks an SM that this allows.  Launches nothing."""
    out = (ctypes.c_int * 4)()
    err = KERNELS.function("mamba_scan_bwd_occupancy", 0, 2)(
        int(dtype == torch.float32), N, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"mamba_scan_bwd_occupancy failed: cudaError {err}")
    return {"states_smem": out[0], "states_blocks_per_sm": out[1], "kernel_smem": out[2],
            "kernel_blocks_per_sm": out[3]}


def mamba_scan_bwd(dt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
                   x: torch.Tensor, a_log: torch.Tensor, g_y: torch.Tensor | None,
                   g_h: torch.Tensor | None) -> tuple[torch.Tensor, ...]:
    """Backward of ``mamba_scan``: its inputs and the gradients of its outputs,
    g_y (B,S,di) and g_h (B,di,N) in f32, either None for zeros.  Returns (d
    dt, dB, dC, dx, dA_log): d dt and dA_log f32, the others in x's dtype.
    The same dtype and contiguity contract as ``mamba_scan``."""
    name = "mamba_scan_bwd"
    route = meta.arm(name, dt.device)
    if route == "plain":
        return ref.mamba_scan_bwd_ref(dt, b_in, c_in, x, a_log, g_y, g_h)
    B, S, di, N = _check(name, dt, b_in, c_in, x, a_log, g_y=g_y, g_h=g_h)
    dev = dt.device
    d_dt = dt.new_empty((B, S, di))
    d_x = torch.empty_like(x)
    d_b, d_c = torch.empty_like(b_in), torch.empty_like(c_in)
    d_alog = dt.new_empty((di, N))
    scratch = dt.new_empty(bwd_scratch_bytes(B, S, di, N) // 4)
    if route == "meta":
        meta.report(name, *meta.scan_bwd_cost(B, S, di, N, x.element_size()), dt)
        return d_dt, d_b, d_c, d_x, d_alog
    plan = _scan_bwd_plan(S, di, N, x.element_size(),
                          [t.data_ptr() for t in (dt, b_in, c_in, x, dt if g_y is None else g_y,
                                                  d_dt, d_x)])
    fn = KERNELS.function(f"{name}_{_SUFFIX[x.dtype]}", 13, 4 + len(BWD_PLAN_KEYS))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(dt.data_ptr(), b_in.data_ptr(), c_in.data_ptr(), x.data_ptr(),
                 a_log.data_ptr(), None if g_y is None else g_y.data_ptr(),
                 None if g_h is None else g_h.data_ptr(), d_dt.data_ptr(), d_b.data_ptr(),
                 d_c.data_ptr(), d_x.data_ptr(), d_alog.data_ptr(), scratch.data_ptr(),
                 B, S, di, N, *(plan[k] for k in BWD_PLAN_KEYS), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1
    return d_dt, d_b, d_c, d_x, d_alog
