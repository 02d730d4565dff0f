"""Decode attention, paged and dense: the hand-written Hopper kernels and their wrappers.

``paged_decode_attention`` (``csrc/paged_decode_attention.cu``) replaces the
TPU kernel ``repro/kernels/decode_attention.py::paged_decode_attention_pallas``;
``decode_attention`` (``csrc/decode_attention.cu``) replaces
``decode_attention_pallas``.  Both share one device body
(``csrc/decode_attention.cuh``), are compiled by ``nvcc`` on first use into
the port's one kernel library (``build.py``) and are called through
``ctypes`` on PyTorch's current stream.

On CPU tensors a wrapper returns the plain version (``ref.py``); on CUDA
tensors it launches its kernel or raises.  ``launches[name]`` counts each
kernel's launches, and nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import KERNELS

launches = {"paged_decode_attention": 0, "decode_attention": 0}

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
# (G, hd) as built: REPRO_DECODE_SHAPES in csrc/decode_attention.cuh
_SUPPORTED = {(g, hd) for g in range(1, 9) for hd in (64, 128, 256) if g * hd <= 1024}


def _check(name: str, q, kv: tuple, ints: dict) -> None:
    """Device, type, layout and (G, hd) checks shared by both wrappers: ``kv``
    are the K/V tensors (q's dtype), ``ints`` the int32 tensors by name."""
    dev = q.device
    tensors = {"k": kv[0], "v": kv[1], **ints}
    for n, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {n} is on {t.device}, q on {dev}")
    if q.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (bfloat16 or float32)")
    if any(t.dtype != q.dtype for t in kv):
        raise TypeError(f"{name}: q, k and v differ in dtype")
    if any(t.dtype != torch.int32 for t in ints.values()):
        raise TypeError(f"{name}: {' and '.join(ints)} must be int32")
    if q.dim() != 4 or any(t.dim() != 4 for t in kv):
        raise ValueError(f"{name}: want q (B,KV,G,hd) and 4-d K/V")
    B, KV, G, hd = q.shape
    if kv[0].shape != kv[1].shape or kv[0].shape[2:] != (KV, hd):
        raise ValueError(f"{name}: K/V shape {tuple(kv[0].shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if (G, hd) not in _SUPPORTED:
        raise ValueError(f"{name}: (G, hd) = ({G}, {hd}) not built")
    for n, t in {"q": q, **tensors}.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous (strides {t.stride()})")


def _launch(name: str, q: torch.Tensor, ptrs: list, ints: list) -> torch.Tensor:
    out = torch.empty_like(q)
    fn = KERNELS.function(f"{name}_{_SUFFIX[q.dtype]}", len(ptrs) + 1, len(ints))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in ptrs), out.data_ptr(), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1
    return out


def _on_cuda(name: str, q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    return True


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           page_table: torch.Tensor, valid_len: torch.Tensor
                           ) -> torch.Tensor:
    """q (B,KV,G,hd) against one period's block pools (NB,ps,KV,hd), read
    through page_table (B,num_pages) int32; valid_len (B,) int32, each >= 1.
    Returns (B,KV,G,hd) in q's dtype."""
    name = "paged_decode_attention"
    if not _on_cuda(name, q):
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, page_table, valid_len)
    _check(name, q, (k_pool, v_pool), {"page_table": page_table, "valid_len": valid_len})
    B, KV, G, hd = q.shape
    if page_table.dim() != 2 or page_table.shape[0] != B or valid_len.shape != (B,):
        raise ValueError(f"{name}: page_table (B,num_pages) / valid_len (B,) do not match q")
    return _launch(name, q, [q, k_pool, v_pool, page_table, valid_len],
                   [B, KV, G, hd, page_table.shape[1], k_pool.shape[1]])


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor) -> torch.Tensor:
    """q (B,KV,G,hd) against one period's dense cache k, v (B,C,KV,hd);
    valid_len (B,) int32, each >= 1 (values above C count as C).  Returns
    (B,KV,G,hd) in q's dtype."""
    name = "decode_attention"
    if not _on_cuda(name, q):
        return ref.decode_attention_ref(q, k, v, valid_len)
    _check(name, q, (k, v), {"valid_len": valid_len})
    B, KV, G, hd = q.shape
    if k.shape[0] != B or valid_len.shape != (B,):
        raise ValueError(f"{name}: k (B,C,KV,hd) / valid_len (B,) do not match q")
    return _launch(name, q, [q, k, v, valid_len], [B, KV, G, hd, k.shape[1]])
