"""Layer primitives of the dense and paged planes (counterpart of ``repro/models/layers.py``).

The casts sit where the JAX package puts them, so the two agree in f32 to
rounding and round bf16 at the same places:

  * ``rmsnorm`` casts back to the input dtype before it multiplies by the scale;
  * ``rope`` computes its angles in f32 and casts the result;
  * ``_plain_attention`` forms scores in the input dtype, softmaxes in f32 and
    casts the probabilities to ``v``'s dtype.

The attention layers that write a cache (dense or paged) update it **in
place** (the JAX versions return new caches); they return the same tensors
for symmetry.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.flash import flash_attention

F32 = torch.float32


# ----------------------------------------------------------------- norms / rope

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def block_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(half, dtype=F32, device=x.device)
                      / half)
    ang = positions.to(F32)[..., None] * freqs               # (..., S, half)
    if ang.dim() == 2:                                       # (S, half) -> broadcast batch
        ang = ang[None]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activate(h: torch.Tensor, g: torch.Tensor | None, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(g) * h
    if kind == "relu2":
        return torch.square(F.relu(h))
    if kind == "gelu":
        return F.gelu(h, approximate="tanh")              # jax.nn.gelu's default
    raise ValueError(f"unknown activation {kind!r}")


# ----------------------------------------------------------------- full attention

FLASH_THRESHOLD = 2048
_QBLK, _KBLK = 512, 1024


def _plain_attention(q, k, v, mask, scale):
    # q: (B,S,KV,G,hd)  k,v: (B,T,KV,hd)  mask: broadcastable to (B,KV,G,S,T) or None
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).to(F32) * scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dnk->bsnk", x, p["wk"])
    v = torch.einsum("bsd,dnk->bsnk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attention_full(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                   *, window: int = 0) -> torch.Tensor:
    """Full-sequence causal self-attention (GQA), optionally windowed.
    x: (B, S, d); positions: (S,).

    At ``S >= FLASH_THRESHOLD`` the blocked flash forward runs (no S x S
    score tensor), below it the plain masked softmax.  Returns (B, S, d_model).
    """
    B, S, _ = x.shape
    KV, hd, H = cfg.n_kv_heads, cfg.hd, cfg.n_heads
    G = H // KV
    q, k, v = _qkv(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, KV, G, hd)
    if S >= FLASH_THRESHOLD:
        out = flash_attention(qg.permute(0, 2, 3, 1, 4), k, v, positions, positions, scale,
                              True, window, _QBLK, _KBLK).permute(0, 3, 1, 2, 4)
    else:
        mask = positions[:, None] >= positions[None, :]
        if window:
            mask &= positions[:, None] - positions[None, :] < window
        out = _plain_attention(qg, k, v, mask[None, None, None], scale)
    out = out.reshape(B, S, H, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# ----------------------------------------------------------------- dense decode / chunk

def attention_decode(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token dense decode: write the new KV at ``pos``'s slot, attend (the
    hand-written dense kernel on CUDA tensors).

    cache_k/v: (B, C, KV, hd), updated in place; pos: (B,) int32 per-lane
    positions.  The slot is ``pos % C`` with a sliding window (a ring) and
    ``min(pos, C - 1)`` without one (a full linear lane overwrites its last
    slot).  Each lane writes only its own row, so no two writes collide.
    Returns (out (B,1,d_model), cache_k, cache_v).
    """
    B = x.shape[0]
    KV, hd, H = cfg.n_kv_heads, cfg.hd, cfg.n_heads
    q, k, v = _qkv(p, x, cfg)
    pos = pos.expand(B)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)
    C = cache_k.shape[1]
    slot = (pos % C if window else torch.clamp(pos, max=C - 1)).long()
    bidx = torch.arange(B, device=x.device)
    cache_k[bidx, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot] = v[:, 0].to(cache_v.dtype)
    valid_len = torch.clamp(pos + 1, max=C).to(torch.int32)
    out = kops.decode_attention(q.reshape(B, KV, H // KV, hd), cache_k, cache_v, valid_len)
    out = out.reshape(B, 1, H, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache_k, cache_v


def attention_prefill_chunk(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    off: torch.Tensor,
    length: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-shape chunk prefill for one lane: ``C`` tokens at offset ``off``.

    x: (1, C, d) normed hidden states (rows >= ``length`` are padding);
    cache_k/v: (1, cap, KV, hd) with positions ``[0, off)`` resident, updated
    in place; ``off``: a 0-d tensor (read on the device, no host sync).
    Every valid row ``j < length`` with ``off + j < cap`` lands at its
    absolute slot ``off + j``; every other slot keeps its old contents.  The
    write goes through a window of ``min(C, cap)`` distinct slots inside the
    lane that covers every valid row, so no two writes hit one slot.  (The
    JAX version scatters every row, clipped to ``cap - 1``; when a chunk
    fills the lane exactly while its window runs past capacity, a padding
    row's write-back of the old contents lands on ``cap - 1`` after the valid
    row's and the new key is lost.  The port keeps the documented semantics.)
    Then each query ``i`` attends to slots ``t <= off + i``.  Linear caches
    only.  Returns (out (1, C, d_model), cache_k, cache_v).
    """
    B, Cn, _ = x.shape
    KV, hd, H = cfg.n_kv_heads, cfg.hd, cfg.n_heads
    G = H // KV
    q, k, v = _qkv(p, x, cfg)
    rows = off + torch.arange(Cn, device=x.device)            # (C,) absolute
    q = rope(q, rows[None], cfg.rope_theta)
    k = rope(k, rows[None], cfg.rope_theta)
    cap = cache_k.shape[1]
    W = min(Cn, cap)
    slots = torch.clamp(off, 0, cap - W) + torch.arange(W, device=x.device)
    src = slots - off                                         # chunk row at each slot
    take = ((src >= 0) & (src < length))[:, None, None]
    src = torch.clamp(src, 0, Cn - 1).long()
    slots = slots.long()
    for cache, new in ((cache_k, k), (cache_v, v)):
        cache[0, slots] = torch.where(take, new[0, src].to(cache.dtype), cache[0, slots])
    mask = torch.arange(cap, device=x.device)[None, :] <= rows[:, None]   # (C, cap)
    qg = q.reshape(B, Cn, KV, G, hd)
    out = _plain_attention(qg, cache_k, cache_v, mask[None, None, None], 1.0 / math.sqrt(hd))
    out = out.reshape(B, Cn, H, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache_k, cache_v


# ----------------------------------------------------------------- paged decode / chunk

def attention_decode_paged(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    pos: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token paged decode: write the new KV into the lane's current block,
    attend through the page table (the hand-written kernel on CUDA tensors).

    k_pool/v_pool: (NB, page_size, KV, hd), updated in place; page_table:
    (B, num_pages) int32 (block 0 = scratch); pos: (B,) int32.  A lane writes
    at block ``page_table[b, pos//ps]``, offset ``pos % ps``; a lane whose pos
    is past capacity writes into scratch, and so does a free lane (its row is
    unmapped).  Several lanes may write the same scratch slot: the order of
    those writes is undefined on CUDA and harmless, since scratch is never
    read inside ``valid_len``.  Returns (out (B,1,d_model), k_pool, v_pool).
    """
    B = x.shape[0]
    KV, hd, H = cfg.n_kv_heads, cfg.hd, cfg.n_heads
    q, k, v = _qkv(p, x, cfg)
    pos = pos.expand(B)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)
    ps = k_pool.shape[1]
    num_pages = page_table.shape[1]
    cap = num_pages * ps
    bidx = torch.arange(B, device=x.device)
    page = torch.clamp(pos // ps, 0, num_pages - 1).long()
    blk = torch.where(pos < cap, page_table[bidx, page], 0).long()   # overflow -> scratch
    off = (pos % ps).long()
    k_pool[blk, off] = k[:, 0].to(k_pool.dtype)
    v_pool[blk, off] = v[:, 0].to(v_pool.dtype)
    valid_len = torch.clamp(pos + 1, max=cap).to(torch.int32)
    out = kops.paged_decode_attention(q.reshape(B, KV, H // KV, hd), k_pool, v_pool,
                                      page_table, valid_len)
    out = out.reshape(B, 1, H, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), k_pool, v_pool


def attention_prefill_chunk_paged(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    pt_row: torch.Tensor,
    off: torch.Tensor,
    length: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-shape chunk prefill straight into a lane's pages.

    x: (1, C, d) normed hidden states (rows >= ``length`` are padding); pt_row:
    (num_pages,) int32, mapped far enough to cover ``off + length`` tokens;
    ``off``: the lane's position, a 0-d tensor (read on the device, no host
    sync).  The chunk's K/V rows scatter to their absolute (block, offset)
    slots in place -- padding and out-of-capacity rows go to scratch block 0
    -- then each query ``i`` attends to positions ``t <= off + i`` through the
    gathered page view.  Returns (out (1, C, d_model), k_pool, v_pool).
    """
    B, Cn, _ = x.shape
    KV, hd, H = cfg.n_kv_heads, cfg.hd, cfg.n_heads
    G = H // KV
    q, k, v = _qkv(p, x, cfg)
    rows = off + torch.arange(Cn, device=x.device)            # (C,) absolute
    q = rope(q, rows[None], cfg.rope_theta)
    k = rope(k, rows[None], cfg.rope_theta)
    ps = k_pool.shape[1]
    num_pages = pt_row.shape[0]
    cap = num_pages * ps
    valid = (torch.arange(Cn, device=x.device) < length) & (rows < cap)
    page = torch.clamp(rows // ps, 0, num_pages - 1).long()
    blk = torch.where(valid, pt_row[page], 0).long()          # padding -> scratch
    slot = (rows % ps).long()
    k_pool[blk, slot] = k[0].to(k_pool.dtype)
    v_pool[blk, slot] = v[0].to(v_pool.dtype)
    idx = pt_row.long()
    kg = k_pool[idx].reshape(1, cap, KV, hd)
    vg = v_pool[idx].reshape(1, cap, KV, hd)
    mask = torch.arange(cap, device=x.device)[None, :] <= rows[:, None]   # (C, cap)
    qg = q.reshape(B, Cn, KV, G, hd)
    out = _plain_attention(qg, kg, vg, mask[None, None, None], 1.0 / math.sqrt(hd))
    out = out.reshape(B, Cn, H, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), k_pool, v_pool


# ----------------------------------------------------------------- MLP

def mlp(p: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    h = x @ p["w_in"]
    g = x @ p["w_gate"] if activation == "swiglu" else None
    return activate(h, g, activation) @ p["w_out"]
