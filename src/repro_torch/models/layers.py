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


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, kv_input: torch.Tensor | None = None):
    """q from ``x``; k, v from ``kv_input`` when given (cross-attention), else
    from ``x``; qk-norm on both sides when the config sets it."""
    src = x if kv_input is None else kv_input
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dnk->bsnk", src, p["wk"])
    v = torch.einsum("bsd,dnk->bsnk", src, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attention_full(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                   *, causal: bool = True, use_rope: bool = True,
                   kv_input: torch.Tensor | None = None, window: int = 0) -> torch.Tensor:
    """Full-sequence GQA attention, optionally windowed; cross-attention when
    ``kv_input`` (B, T, d) gives the keys and values.  x: (B, S, d);
    positions: (S,).

    RoPE applies when ``use_rope`` holds and the call is not cross-attention.
    Self-attention at ``max(S, T) >= FLASH_THRESHOLD`` takes the blocked
    flash forward (no S x T score tensor); cross-attention never does, and
    below the threshold the plain softmax runs, masked only when causal.
    Returns (B, S, d_model).
    """
    B, S, _ = x.shape
    KV, hd, H = cfg.n_kv_heads, cfg.hd, cfg.n_heads
    G = H // KV
    q, k, v = _qkv(p, x, cfg, kv_input)
    is_cross = kv_input is not None
    if use_rope and not is_cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    T = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, KV, G, hd)
    if max(S, T) >= FLASH_THRESHOLD and not is_cross:
        out = flash_attention(qg.permute(0, 2, 3, 1, 4), k, v, positions, positions, scale,
                              causal, window, _QBLK, _KBLK).permute(0, 3, 1, 2, 4)
    else:
        mask = None
        if causal and not is_cross:
            mask = positions[:, None] >= positions[None, :]
            if window:
                mask &= positions[:, None] - positions[None, :] < window
            mask = mask[None, None, None]
        out = _plain_attention(qg, k, v, mask, scale)
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
    use_rope: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token dense decode: write the new KV at ``pos``'s slot, attend (the
    hand-written dense kernel on CUDA tensors).

    cache_k/v: (B, C, KV, hd), updated in place; pos: (B,) int32 per-lane
    positions.  The slot is ``pos % C`` with a sliding window (a ring) and
    ``min(pos, C - 1)`` without one (a full linear lane overwrites its last
    slot).  Each lane writes only its own row, so no two writes collide.
    Without ``use_rope`` the key is written and the query used as projected.
    Returns (out (B,1,d_model), cache_k, cache_v).
    """
    B = x.shape[0]
    KV, hd, H = cfg.n_kv_heads, cfg.hd, cfg.n_heads
    q, k, v = _qkv(p, x, cfg)
    pos = pos.expand(B)
    if use_rope:
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


def cross_attention_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                           cross_k: torch.Tensor, cross_v: torch.Tensor) -> torch.Tensor:
    """One-token cross-attention against the fixed encoder or image K/V.

    x: (B, 1, d) normed hidden states; cross_k/v: (B, T, KV, hd), every slot
    valid (``valid_len = T``, the hand-written dense kernel on CUDA tensors;
    made on the device, since a host integer copied to the card would hold
    the host until the stream drains).  The query takes no RoPE and no
    qk-norm, as in the reference.  Returns (B, 1, d_model).
    """
    B = x.shape[0]
    KV, hd, H = cfg.n_kv_heads, cfg.hd, cfg.n_heads
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    valid_len = torch.full((B,), cross_k.shape[1], dtype=torch.int32, device=x.device)
    out = kops.decode_attention(q.reshape(B, KV, H // KV, hd), cross_k, cross_v, valid_len)
    out = out.reshape(B, 1, H, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


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


def moe(p: dict, x: torch.Tensor, cfg: ModelConfig, e0: int = 0, experts: bool = True,
        side: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based top-k MoE with sort dispatch, one dispatch group.

    Each expert takes at most ``cap = ceil(T * K / E * capacity_factor)``
    (token, choice) pairs, in token order; the rest drop (their contribution
    is 0).  Every expert's product runs over its ``cap`` buffer rows, as in
    the JAX package.  Batched decode is not independent per lane: masked
    lanes compete for capacity too.  With ``shared_d_ff`` a sigmoid-gated
    shared SwiGLU MLP (qwen2-moe) and with ``dense_residual_ff`` a dense
    SwiGLU MLP (arctic) add to every token's output; neither enters the aux
    loss.  Returns (output (B, S, d), Switch load-balance aux loss).

    On a tensor-parallel shard, ``p`` holds experts ``[e0, e0 + E_l)`` of the
    E that the router scores (``E_l = we_in.shape[0]``): the routing,
    capacity and drops are computed over all E, as one device computes them,
    and only the pairs routed to the shard's experts are run and combined,
    so the shards' outputs sum to the whole layer's.  ``experts=False``
    leaves the experts out and ``side=False`` the shared and dense-residual
    MLPs (a shard whose copy of a replicated group is another shard's to
    add)."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    cap = max(1, int(math.ceil(T * K / E * cfg.capacity_factor)))
    xf = x.reshape(T, D)
    dev = x.device

    logits = xf.to(p["router"].dtype) @ p["router"]                  # f32 router
    gates = torch.softmax(logits.to(F32), dim=-1)                     # (T, E)
    top_g, top_e = torch.topk(gates, K, dim=-1)                       # (T, K)
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
    eid = top_e.reshape(-1)                                           # (T*K,)

    y = torch.zeros((T, D), dtype=x.dtype, device=dev)
    if experts:
        El = p["we_in"].shape[0]
        tid = torch.arange(T, device=dev).repeat_interleave(K)
        order = torch.argsort(eid, stable=True)
        eid_s, tid_s, gat_s = eid[order], tid[order], top_g.reshape(-1)[order]
        counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
            0, eid_s, torch.ones_like(eid_s))
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(T * K, device=dev) - starts[eid_s]
        local = eid_s - e0                                            # the shard's rows
        keep = ((rank < cap) & (local >= 0) & (local < El)).to(x.dtype)
        local = torch.clamp(local, 0, El - 1)
        rank_c = torch.clamp(rank, 0, cap - 1)
        # a dropped (or another shard's) pair adds zero into a clamped row,
        # as the reference's scatter-add does for a dropped one
        buf = torch.zeros((El, cap, D), dtype=x.dtype, device=dev)
        buf.index_put_((local, rank_c), xf[tid_s] * keep[:, None], accumulate=True)

        h = torch.einsum("ecd,edf->ecf", buf, p["we_in"])
        g = (torch.einsum("ecd,edf->ecf", buf, p["we_gate"]) if cfg.activation == "swiglu"
             else None)
        out_buf = torch.einsum("ecf,efd->ecd", activate(h, g, cfg.activation), p["we_out"])

        yflat = out_buf[local, rank_c] * (gat_s.to(out_buf.dtype) * keep)[:, None]
        y = y.index_add_(0, tid_s, yflat)

    assigned = torch.zeros(E, dtype=F32, device=dev).scatter_add_(
        0, eid, torch.ones(T * K, dtype=F32, device=dev))
    frac_tokens = assigned / torch.clamp(assigned.sum(), min=1.0)
    aux = E * torch.sum(frac_tokens * gates.mean(0))

    if side and cfg.shared_d_ff:              # qwen2-moe's shared experts, one SwiGLU MLP
        s_out = (F.silu(xf @ p["ws_gate"]) * (xf @ p["ws_in"])) @ p["ws_out"]
        # the gate's product runs in the model dtype, is cast to f32 for the
        # sigmoid and back before it scales the shared output
        gate = torch.sigmoid((xf @ p["shared_gate"]).to(F32))[:, None]
        y = y + gate.to(xf.dtype) * s_out
    if side and cfg.dense_residual_ff:        # arctic's dense residual beside the experts
        y = y + mlp({"w_in": p["wd_in"], "w_gate": p["wd_gate"], "w_out": p["wd_out"]},
                    xf, "swiglu")
    return y.reshape(B, S, D), aux


# ----------------------------------------------------------------- Mamba (SSM)

# Each Mamba form is two halves around the ``m_xproj`` product, so that a
# tensor-parallel shard (``models/model.py``) holding 1/d of ``d_inner`` can
# sum the partial (dt, B, C) projections of all shards between them: the
# first half runs on the shard's channels up to its partial ``dbc``, the
# second takes the whole ``dbc`` and runs the scan on the shard's channels.
# Unsharded, ``dbc`` is the whole product and the halves compose to the mixer.

def _mamba_proj(p: dict, dbc: torch.Tensor, cfg: ModelConfig):
    """dt (..., di) f32 from this shard's ``m_dtproj`` columns, and B, C (...,
    N), from the whole projection ``dbc`` (..., R + 2N)."""
    R = p["m_dtproj"].shape[0]
    N = cfg.ssm_state_dim
    dt = F.softplus(dbc[..., :R] @ p["m_dtproj"]).to(F32)
    return dt, dbc[..., R:R + N], dbc[..., R + N:]


def mamba_full_in(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The full form's first half.  x: (B, S, d).  Returns (xc (B, S, di) the
    conv'd channels, z (B, S, di), the conv state (B, W-1, di), dbc (B, S,
    R + 2N) this shard's partial of the projection)."""
    S = x.shape[1]
    xi = x @ p["m_in"]                                                # (B, S, di)
    z = x @ p["m_z"]
    W = cfg.ssm_conv_width
    xp = F.pad(xi, (0, 0, W - 1, 0))                                  # causal conv
    xc = F.silu(sum(xp[:, i:i + S] * p["m_conv"][i] for i in range(W)))
    return xc, z, xp[:, S:S + W - 1], xc @ p["m_xproj"]


def mamba_full_out(p: dict, xc: torch.Tensor, z: torch.Tensor, dbc: torch.Tensor,
                   cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The full form's second half: the selective scan over this shard's
    channels (``ops.mamba_scan``: the hand-written kernel on CUDA tensors,
    and under autograd its backward), the skip, the gate and this shard's
    partial ``m_out`` product.  Returns (out (B, S, d), the last state (B,
    di, N) f32)."""
    dt, Bm, Cm = _mamba_proj(p, dbc, cfg)
    y, h_last = kops.mamba_scan(dt, Bm, Cm, xc, p["m_Alog"])
    y = (y + p["m_D"].to(F32) * xc.to(F32)).to(xc.dtype)
    y = y * F.silu(z)
    return y @ p["m_out"], h_last


def mamba_full(p: dict, x: torch.Tensor, cfg: ModelConfig
               ) -> tuple[torch.Tensor, dict]:
    """Full-sequence Mamba mixer.  x: (B, S, d).  The selective scan goes
    through ``ops.mamba_scan`` (the hand-written kernel on CUDA tensors),
    which also returns the last state, and under autograd through its
    backward (the hand-written backward kernel on CUDA tensors), where the
    JAX package differentiates its chunked scan.  Returns (out (B, S, d),
    state {"h": (B, di, N) f32, "conv": (B, W-1, di)}), the state a decode
    step continues from."""
    xc, z, conv, dbc = mamba_full_in(p, x, cfg)
    out, h_last = mamba_full_out(p, xc, z, dbc, cfg)
    return out, {"h": h_last, "conv": conv}


def mamba_step_in(p: dict, x: torch.Tensor, state: dict):
    """The step's first half.  x: (B, 1, d); state = {"h", "conv": (B, W-1,
    di)}.  Returns (xc (B, di), z (B, di), the conv window (B, W, di), dbc
    (B, R + 2N) this shard's partial of the projection)."""
    xi = x[:, 0] @ p["m_in"]                                          # (B, di)
    z = x[:, 0] @ p["m_z"]
    hist = torch.cat([state["conv"], xi[:, None]], dim=1)             # (B, W, di)
    xc = F.silu(torch.einsum("bwd,wd->bd", hist, p["m_conv"]))
    return xc, z, hist, xc @ p["m_xproj"]


def mamba_step_out(p: dict, xc: torch.Tensor, z: torch.Tensor, hist: torch.Tensor,
                   dbc: torch.Tensor, state: dict, cfg: ModelConfig
                   ) -> tuple[torch.Tensor, dict]:
    """The step's second half from the whole ``dbc``: one recurrence step
    on this shard's channels.  Returns (out (B, 1, d), new state)."""
    dt, Bm, Cm = _mamba_proj(p, dbc, cfg)
    A = -torch.exp(p["m_Alog"].to(F32))                               # (di, N)
    a = torch.exp(dt[..., None] * A)
    b = (dt * xc.to(F32))[..., None] * Bm.to(F32)[..., None, :]
    h = a * state["h"] + b
    y = torch.einsum("bdn,bn->bd", h, Cm.to(F32))
    y = (y + p["m_D"].to(F32) * xc.to(F32)).to(xc.dtype)
    y = y * F.silu(z)
    return (y @ p["m_out"])[:, None], {"h": h, "conv": hist[:, 1:]}


def mamba_step(p: dict, x: torch.Tensor, cfg: ModelConfig, state: dict
               ) -> tuple[torch.Tensor, dict]:
    """One-token decode.  x: (B, 1, d); state = {"h": (B, di, N) f32,
    "conv": (B, W-1, di)}.  Returns (out (B, 1, d), new state); the state
    passed in is not changed."""
    xc, z, hist, dbc = mamba_step_in(p, x, state)
    return mamba_step_out(p, xc, z, hist, dbc, state, cfg)


# ----------------------------------------------------------------- xLSTM

def _mlstm_qkv(p: dict, xi: torch.Tensor):
    """q, k, v (..., H, hd) in the model dtype; input and forget gate
    pre-activations (..., H) in f32."""
    q = torch.einsum("...d,dhk->...hk", xi, p["l_q"])
    k = torch.einsum("...d,dhk->...hk", xi, p["l_k"])
    v = torch.einsum("...d,dhk->...hk", xi, p["l_v"])
    i_pre = torch.einsum("...d,dh->...h", xi, p["l_ig"]).to(F32)
    f_pre = torch.einsum("...d,dh->...h", xi, p["l_fg"]).to(F32)
    return q, k, v, i_pre, f_pre


MLSTM_CHUNK = 256


def fresh_mlstm_state(B: int, H: int, hd: int, device) -> dict:
    """The mLSTM state before any token: C, n zero and the stabiliser m at
    -1e30 (so the first token's input gate sets it), all f32."""
    return {"C": torch.zeros((B, H, hd, hd), dtype=F32, device=device),
            "n": torch.zeros((B, H, hd), dtype=F32, device=device),
            "m": torch.full((B, H), -1e30, dtype=F32, device=device)}


def fresh_slstm_state(B: int, H: int, hd: int, device) -> dict:
    """The sLSTM state before any token: h, c, n zero and m at -1e30, f32."""
    st = {k: torch.zeros((B, H, hd), dtype=F32, device=device) for k in ("h", "c", "n")}
    st["m"] = torch.full((B, H, hd), -1e30, dtype=F32, device=device)
    return st


# Each mLSTM form is two halves around the q/k/v/gate products, so that a
# tensor-parallel shard holding 1/d of ``d_inner`` (``l_up``/``l_z`` columns,
# the products' rows) can sum the partial products of all shards between
# them: the first half runs the shard's columns up to its partial products,
# the second takes the summed products of the shard's H/d heads -- whose
# ``(..., H, hd) -> (..., di)`` columns are exactly the shard's -- and runs
# the cell, the gate and the skip on them, ending in the shard's partial
# ``l_down`` product.  Unsharded, the halves compose to the mixer.

def mlstm_in(p: dict, x: torch.Tensor):
    """The first half of either form.  x: (..., d).  Returns (xi (..., di)
    the up-projected columns, z (..., di) their silu'd gate, and this shard's
    partial products (q, k, v (..., H, hd), i_pre, f_pre (..., H) f32) over
    its ``d_inner`` rows)."""
    xi = x @ p["l_up"]
    return xi, F.silu(x @ p["l_z"]), _mlstm_qkv(p, xi)


def mlstm_full_out(p: dict, xi: torch.Tensor, z: torch.Tensor, qkv: tuple
                   ) -> tuple[torch.Tensor, dict]:
    """The full form's second half on the heads of ``qkv`` (the summed
    products, cut to this shard's heads): the chunk-recurrent cell, then
    ``h z + l_skip xi`` and this shard's partial ``l_down`` product.  xi, z:
    (B, S, di) the heads' columns.  Returns (out (B, S, d), the carry)."""
    B, S, di = xi.shape
    q, k, v, i_pre, f_pre = qkv                               # (B,S,H,hd), (B,S,H)
    H, hd = q.shape[-2:]
    q = q.transpose(1, 2)                                     # (B,H,S,hd)
    k = k.transpose(1, 2) / math.sqrt(hd)
    v = v.transpose(1, 2)
    i_pre = i_pre.transpose(1, 2)                             # (B,H,S)
    logf = F.logsigmoid(f_pre.transpose(1, 2))

    cs = min(MLSTM_CHUNK, S)
    nc = -(-S // cs)
    pad = nc * cs - S
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        i_pre = F.pad(i_pre, (0, pad), value=-1e30)
        logf = F.pad(logf, (0, pad))
    causal = torch.tril(torch.ones((cs, cs), dtype=torch.bool, device=xi.device))
    st = fresh_mlstm_state(B, H, hd, xi.device)
    hs = []
    for c in range(nc):
        sl = slice(c * cs, (c + 1) * cs)
        qi, ki, vi = q[:, :, sl].to(F32), k[:, :, sl].to(F32), v[:, :, sl].to(F32)
        ii, fi = i_pre[:, :, sl], logf[:, :, sl]
        Cst, nst, mst = st["C"], st["n"], st["m"]
        fcum = torch.cumsum(fi, dim=-1)                       # sum_{u<=t} log f_u
        ftot = fcum[..., -1]
        # per-query stabiliser m_out_t = fcum_t + max(m, cummax(i - fcum))
        runmax = torch.cummax(ii - fcum, dim=-1).values
        m_out = fcum + torch.maximum(mst[..., None], runmax)  # (B,H,cs)
        dec_q = torch.exp(mst[..., None] + fcum - m_out)      # inter-chunk decay per query
        inter = torch.einsum("bhsd,bhde->bhse", qi, Cst) * dec_q[..., None]
        n_inter = torch.einsum("bhsd,bhd->bhs", qi, nst) * dec_q
        # intra weights D[t1, t2] = exp(i_t2 + fcum_t1 - fcum_t2 - m_out_t1), t2 <= t1;
        # masked before the exp (exp(-inf) = 0): above the diagonal the exponent
        # can overflow, and inf times where()'s zero gradient is NaN under
        # autograd (the JAX package masks after the exp: Queue 3 of ROADMAP.md)
        dlog = (ii - fcum)[..., None, :] + (fcum - m_out)[..., :, None]
        dmat = torch.exp(torch.where(causal, dlog, float("-inf")))
        sd = torch.einsum("bhsd,bhtd->bhst", qi, ki) * dmat
        intra = torch.einsum("bhst,bhtd->bhsd", sd, vi)
        n_vec = n_inter + sd.sum(-1)
        hs.append((inter + intra)
                  / torch.maximum(torch.abs(n_vec), torch.exp(-m_out))[..., None])
        # the state at the chunk's end: key t weighs log w_t = i_t + ftot - fcum_t
        wlog = ii + (ftot[..., None] - fcum)
        m_new = torch.maximum(mst + ftot, wlog.max(dim=-1).values)
        wk = torch.exp(wlog - m_new[..., None])
        decay = torch.exp(mst + ftot - m_new)
        st = {"C": Cst * decay[..., None, None]
                   + torch.einsum("bhtd,bhte->bhde", ki * wk[..., None], vi),
              "n": nst * decay[..., None] + torch.einsum("bhtd,bht->bhd", ki, wk),
              "m": m_new}
    h = torch.cat(hs, dim=2)[:, :, :S]                        # (B,H,S,hd)
    h = h.transpose(1, 2).reshape(B, S, di).to(xi.dtype)
    out = h * z + p["l_skip"] * xi
    return out @ p["l_down"], st


def mlstm_full(p: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Chunk-recurrent mLSTM (matrix memory, exponential gating, stabilised).

    Within a chunk of ``MLSTM_CHUNK`` steps the outputs come from a decay-
    weighted attention-like product; across chunks the (C, n, m) state
    carries, all in f32.  x: (B, S, d).  Returns (out (B, S, d), the carry
    after the last token {"C": (B, H, hd, hd), "n": (B, H, hd), "m": (B, H)}),
    the state a decode step continues from.  (The JAX package reruns the
    sequential recurrence for that state; the carry equals it in exact
    arithmetic, padding rows having a zero input weight and a unit forget
    gate.)"""
    return mlstm_full_out(p, *mlstm_in(p, x))


def mlstm_step_out(p: dict, xi: torch.Tensor, z: torch.Tensor, qkv: tuple, state: dict
                   ) -> tuple[torch.Tensor, dict]:
    """The step's second half on the heads of ``qkv`` (as ``mlstm_full_out``);
    xi, z: (B, di); ``state`` the heads' {"C", "n", "m"}.  Returns (out (B, 1,
    d) this shard's partial, new state); the state passed in is not changed."""
    B, di = xi.shape
    q, k, v, i_pre, f_pre = qkv                               # (B,H,hd), (B,H)
    k = k / math.sqrt(q.shape[-1])
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    fw = torch.exp(logf + state["m"] - m_new)[..., None]
    iw = torch.exp(i_pre - m_new)[..., None]
    kf, qf = k.to(F32), q.to(F32)
    C = state["C"] * fw[..., None] + iw[..., None] * torch.einsum(
        "bhd,bhe->bhde", kf, v.to(F32))
    n = state["n"] * fw + iw * kf
    num = torch.einsum("bhde,bhd->bhe", C, qf)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, qf)), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, di).to(xi.dtype)
    out = h * z + p["l_skip"] * xi
    return (out @ p["l_down"])[:, None], {"C": C, "n": n, "m": m_new}


def mlstm_step(p: dict, x: torch.Tensor, cfg: ModelConfig, state: dict
               ) -> tuple[torch.Tensor, dict]:
    """One-token mLSTM.  x: (B, 1, d); state = {"C": (B,H,hd,hd), "n":
    (B,H,hd), "m": (B,H)}, f32.  Returns (out (B, 1, d), new state); the
    state passed in is not changed."""
    return mlstm_step_out(p, *mlstm_in(p, x[:, 0]), state)


def _slstm_cell(p: dict, xt: torch.Tensor, state: dict) -> dict:
    """xt: (B, 4, H, hd) input pre-activations; state h/c/n/m: (B, H, hd) f32."""
    rh = torch.einsum("bhd,ghde->bghe", state["h"].to(F32), p["s_r"].to(F32))
    pre = xt.to(F32) + rh + p["s_b"].to(F32)
    i_pre, f_pre, z_pre, o_pre = pre[:, 0], pre[:, 1], pre[:, 2], pre[:, 3]
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(logf + state["m"] - m_new)
    c = f_g * state["c"] + i_g * torch.tanh(z_pre)
    n = f_g * state["n"] + i_g
    h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
    return {"h": h, "c": c, "n": n, "m": m_new}


def slstm_full(p: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Full-sequence sLSTM, a sequential loop over S (its recurrence runs
    through h, so no chunked form exists).  x: (B, S, d).  Returns (out (B,
    S, d), the state after the last token {"h", "c", "n", "m": (B, H, hd)}).
    The heads are ``s_w``'s: on a tensor-parallel shard its H/d heads,
    whose h is the rows of its ``s_out``, and ``out`` the shard's partial."""
    B, S, _ = x.shape
    H, hd = p["s_w"].shape[-2:]
    xt = torch.einsum("bsd,dghe->bsghe", x, p["s_w"])         # (B,S,4,H,hd)
    st = fresh_slstm_state(B, H, hd, x.device)
    hs = []
    for t in range(S):
        st = _slstm_cell(p, xt[:, t], st)
        hs.append(st["h"])
    h = torch.stack(hs, dim=1).reshape(B, S, H * hd).to(x.dtype)
    return h @ p["s_out"], st


def slstm_step(p: dict, x: torch.Tensor, cfg: ModelConfig, state: dict
               ) -> tuple[torch.Tensor, dict]:
    """One-token sLSTM.  x: (B, 1, d); state h/c/n/m: (B, H, hd) f32, on
    ``s_w``'s heads (a shard's, as ``slstm_full``).  Returns (out (B, 1, d),
    new state)."""
    B = x.shape[0]
    xt = torch.einsum("bd,dghe->bghe", x[:, 0], p["s_w"])
    st = _slstm_cell(p, xt, state)
    h = st["h"].reshape(B, -1).to(x.dtype)
    return (h @ p["s_out"])[:, None], st
