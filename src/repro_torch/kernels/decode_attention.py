"""Decode attention, paged and dense: the hand-written Hopper kernels and their wrappers.

``paged_decode_attention`` (``csrc/paged_decode_attention.cu``) replaces the
TPU kernel ``repro/kernels/decode_attention.py::paged_decode_attention_pallas``;
``decode_attention`` (``csrc/decode_attention.cu``) replaces
``decode_attention_pallas``.  Both share one device body
(``csrc/decode_attention.cuh``), are compiled by ``nvcc`` on first use into
the port's one kernel library (``build.py``) and are called through
``ctypes`` on PyTorch's current stream.

On CPU tensors a wrapper returns the plain version (``ref.py``); on CUDA
tensors it launches its kernel or raises; on ``meta`` tensors it runs the
kernel's shape function (``meta.py``: the output's shape and dtype, the
workspace, and the call's operations and bytes to the dry run's tally, every
slot counted valid).  ``launches[name]`` counts each kernel's real launches,
and nothing else.

Each call is one launch, split over the sequence: ``_split_plan`` cuts a
lane's C token slots into ``n_split`` pieces of L tokens from the shapes
alone (``valid_len`` is read on neither host nor device), one block per
(lane, KV head, piece).  The pieces' partial softmax states go to an f32
workspace taken from PyTorch's caching allocator for the call; the last
piece of a (lane, KV head) to finish merges them, found through an int32
counter that the kernel leaves at 0.  A counter buffer belongs to one stream
of one device (``_counter_buffer``): two launches in flight on one buffer
at once would share counts.  Nothing here synchronises, so a call can be
captured in a CUDA graph.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import meta, ref
from repro_torch.kernels.build import KERNELS

launches = {"paged_decode_attention": 0, "decode_attention": 0}

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
# (G, hd) as built: REPRO_DECODE_SHAPES in csrc/decode_attention.cuh
_SUPPORTED = {(g, hd) for g in range(1, 9) for hd in (64, 128, 256) if g * hd <= 1024}
MAX_SPLITS = 64                       # kMaxSplits in csrc/decode_attention.cuh
_counters: dict[tuple[int, int], torch.Tensor] = {}   # (device index, stream) -> int32 counts


def _split_plan(B: int, KV: int, C: int, page_size: int, sms: int) -> tuple[int, int]:
    """(L, n_split) for B x KV heads over C token slots (C = num_pages *
    page_size for the paged kernel, page_size 1 for the dense one) on
    ``sms`` SMs: about four blocks an SM, at least 64 tokens a piece, at most
    ``MAX_SPLITS`` pieces, L a multiple of 64 and of page_size.  Pieces
    [s * L, min((s + 1) * L, C)) for s < n_split cover each slot once."""
    C = max(C, 1)
    n = max(1, min(_cdiv(4 * sms, max(B * KV, 1)), _cdiv(C, 64), MAX_SPLITS))
    step = math.lcm(64, page_size)
    L = _cdiv(_cdiv(C, n), step) * step
    return L, _cdiv(C, L)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _counter_buffer(device: torch.device, stream: torch.cuda.Stream, n: int) -> torch.Tensor:
    """The int32 counters of ``stream`` on ``device``, at least ``n`` of them:
    zeroed on that stream when made or grown, kept at 0 by the kernels."""
    key = (device.index, stream.cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = _counters[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return buf


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
    for n, t in zip("kv", kv):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {n} is not 16-byte aligned (the kernel's row loads)")


def _launch(name: str, q: torch.Tensor, ptrs: list, ints: list, C: int,
            page_size: int) -> torch.Tensor:
    """One launch over ``ptrs`` (the inputs) and ``ints``, split over the C
    token slots (a multiple of ``page_size``) as ``_split_plan`` says."""
    B, KV, G, hd = q.shape
    out = torch.empty_like(q)
    fn = KERNELS.function(f"{name}_{_SUFFIX[q.dtype]}", len(ptrs) + 3, len(ints) + 2)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device)
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        L, n_split = _split_plan(B, KV, C, page_size, sms)
        ws = (torch.empty(B * KV * n_split * G * (hd + 2), dtype=torch.float32,
                          device=q.device) if n_split > 1 else None)
        counters = _counter_buffer(q.device, stream, B * KV)
        err = fn(*(t.data_ptr() for t in ptrs), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), counters.data_ptr(), *ints, L, n_split,
                 stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1
    return out


def _shape_fn(name: str, q: torch.Tensor, C: int, page_size: int, pages: int = 0
              ) -> torch.Tensor:
    """The launch's shape function on ``meta`` tensors: the output and the
    split's workspace as ``_launch`` takes them (on an H100's SMs), and the
    call's operations and bytes with all B x C slots valid (the page table's
    ``pages`` entries read)."""
    B, KV, G, hd = q.shape
    out = torch.empty_like(q)
    _, n_split = _split_plan(B, KV, C, page_size, meta.LAYOUT_SMS)
    if n_split > 1:
        q.new_empty(B * KV * n_split * G * (hd + 2), dtype=torch.float32)
    meta.report(name, *meta.decode_cost(B, KV, G, hd, B * C, q.element_size(), pages), q)
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           page_table: torch.Tensor, valid_len: torch.Tensor
                           ) -> torch.Tensor:
    """q (B,KV,G,hd) against one period's block pools (NB,ps,KV,hd), read
    through page_table (B,num_pages) int32; valid_len (B,) int32, each >= 1.
    Returns (B,KV,G,hd) in q's dtype."""
    name = "paged_decode_attention"
    route = meta.arm(name, q.device)
    if route == "plain":
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, page_table, valid_len)
    _check(name, q, (k_pool, v_pool), {"page_table": page_table, "valid_len": valid_len})
    B, KV, G, hd = q.shape
    if page_table.dim() != 2 or page_table.shape[0] != B or valid_len.shape != (B,):
        raise ValueError(f"{name}: page_table (B,num_pages) / valid_len (B,) do not match q")
    num_pages, ps = page_table.shape[1], k_pool.shape[1]
    if route == "meta":
        return _shape_fn(name, q, num_pages * ps, ps, B * num_pages)
    return _launch(name, q, [q, k_pool, v_pool, page_table, valid_len],
                   [B, KV, G, hd, num_pages, ps], num_pages * ps, ps)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor) -> torch.Tensor:
    """q (B,KV,G,hd) against one period's dense cache k, v (B,C,KV,hd);
    valid_len (B,) int32, each >= 1 (values above C count as C).  Returns
    (B,KV,G,hd) in q's dtype."""
    name = "decode_attention"
    route = meta.arm(name, q.device)
    if route == "plain":
        return ref.decode_attention_ref(q, k, v, valid_len)
    _check(name, q, (k, v), {"valid_len": valid_len})
    B, KV, G, hd = q.shape
    if k.shape[0] != B or valid_len.shape != (B,):
        raise ValueError(f"{name}: k (B,C,KV,hd) / valid_len (B,) do not match q")
    if route == "meta":
        return _shape_fn(name, q, k.shape[1], 1)
    return _launch(name, q, [q, k, v, valid_len], [B, KV, G, hd, k.shape[1]], k.shape[1], 1)
