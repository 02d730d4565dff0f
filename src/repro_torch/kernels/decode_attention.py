"""Paged decode attention: the hand-written Hopper kernel and its wrapper.

The kernel (``csrc/paged_decode_attention.cu``) replaces the TPU kernel
``repro/kernels/decode_attention.py::paged_decode_attention_pallas``.  It is
compiled by ``nvcc`` on first use (``build.py``) and called through ``ctypes``
on PyTorch's current stream.

On CPU tensors the wrapper returns the plain version
(``ref.paged_decode_attention_ref``); on CUDA tensors it launches the kernel or
raises.  ``launches`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import PAGED_DECODE

launches = 0

_ENTRY = {torch.bfloat16: "paged_decode_attention_bf16",
          torch.float32: "paged_decode_attention_f32"}
_SUPPORTED = {(1, 64), (1, 128), (1, 256), (2, 64), (2, 128), (2, 256),
              (4, 64), (4, 128), (4, 256), (8, 64), (8, 128)}   # (G, hd), as built


_FUNCTIONS: dict = {}


def _function(dtype: torch.dtype):
    fn = _FUNCTIONS.get(dtype)
    if fn is None:
        fn = getattr(PAGED_DECODE.load(), _ENTRY[dtype])
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FUNCTIONS[dtype] = fn
    return fn


def _check(q, k_pool, v_pool, page_table, valid_len) -> None:
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("page_table", page_table),
                    ("valid_len", valid_len)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"paged_decode_attention: dtype {q.dtype} not supported "
                        "(bfloat16 or float32)")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("paged_decode_attention: q, k_pool and v_pool differ in dtype")
    if page_table.dtype != torch.int32 or valid_len.dtype != torch.int32:
        raise TypeError("paged_decode_attention: page_table and valid_len must be int32")
    if q.dim() != 4 or k_pool.dim() != 4 or page_table.dim() != 2:
        raise ValueError("paged_decode_attention: want q (B,KV,G,hd), pools "
                         "(NB,ps,KV,hd), page_table (B,num_pages)")
    B, KV, G, hd = q.shape
    if k_pool.shape != v_pool.shape or k_pool.shape[2:] != (KV, hd):
        raise ValueError(f"pool shape {tuple(k_pool.shape)} does not fit q {tuple(q.shape)}")
    if page_table.shape[0] != B or valid_len.shape != (B,):
        raise ValueError("page_table / valid_len batch does not match q")
    if (G, hd) not in _SUPPORTED:
        raise ValueError(f"paged_decode_attention: (G, hd) = ({G}, {hd}) not built")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("valid_len", valid_len)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous "
                             f"(strides {t.stride()})")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           page_table: torch.Tensor, valid_len: torch.Tensor
                           ) -> torch.Tensor:
    """q (B,KV,G,hd) against one period's block pools (NB,ps,KV,hd), read
    through page_table (B,num_pages) int32; valid_len (B,) int32, each >= 1.
    Returns (B,KV,G,hd) in q's dtype."""
    global launches
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, page_table, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device {q.device}")
    _check(q, k_pool, v_pool, page_table, valid_len)
    B, KV, G, hd = q.shape
    out = torch.empty_like(q)
    fn = _function(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 page_table.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
                 B, KV, G, hd, page_table.shape[1], k_pool.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out
