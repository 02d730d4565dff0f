"""Plain float32 layers of the reference: no kernel, no cache, no batching.

Written from the published descriptions (Qwen3: arXiv:2505.09388; Jamba:
arXiv:2403.19887; Mamba: arXiv:2312.00752; top-k routing with a capacity:
Switch Transformer, arXiv:2101.03961) as the configuration files state them.
Every function takes one sequence, or a few of them stacked, in float32.

``Precision`` decides what a matrix product sees.  ``"float32"`` multiplies
as it is (TF32 must be off: ``reference.strict_float32``).  ``"fp8"`` is
the control: both operands of every weight product are rounded to
float8 e4m3, the weight by output column and the activation by row, each
scaled to the format's largest value, then multiplied in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0                 # the largest finite float8 e4m3 (e4m3fn) value


class Precision:
    """How weight products are computed: ``float32`` or the ``fp8`` control."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def weight(self, w: torch.Tensor, in_dims: int = 1) -> torch.Tensor:
        """A weight leaf in float32 (rounded through fp8 per output column for
        the control); its first ``in_dims`` dimensions are the input."""
        w = w.to(F32)
        if self.name == "float32":
            return w
        return _fp8_round(w, dims=tuple(range(in_dims)))

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation entering a weight product (rounded through fp8 by row
        for the control)."""
        if self.name == "float32":
            return x
        return _fp8_round(x, dims=(-1,))


def _fp8_round(x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    amax = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(F32) / scale


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale.to(F32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last dimension, its halves rotated
    (x: (S, H, hd), pos: (S,))."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = pos.to(F32)[:, None] * inv                       # (S, half)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, x: torch.Tensor, cfg: dict, prec: Precision,
              q_block: int = 1024) -> torch.Tensor:
    """Causal grouped-query attention of one sequence x (S, d), RoPE on q
    and k, qk-norm where the config sets it."""
    S = x.shape[0]
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    xa = prec.act(x)
    q = (xa @ prec.weight(p["wq"]).reshape(-1, H * hd)).reshape(S, H, hd)
    k = (xa @ prec.weight(p["wk"]).reshape(-1, KV * hd)).reshape(S, KV, hd)
    v = (xa @ prec.weight(p["wv"]).reshape(-1, KV * hd)).reshape(S, KV, hd)
    if cfg["qk_norm"]:
        q = rmsnorm(q, p["q_norm"], cfg["norm_eps"])
        k = rmsnorm(k, p["k_norm"], cfg["norm_eps"])
    pos = torch.arange(S, device=x.device)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    G = H // KV
    kh = k.permute(1, 0, 2)                                  # (KV, S, hd)
    vh = v.permute(1, 0, 2)
    out = torch.empty((S, H, hd), dtype=F32, device=x.device)
    for s0 in range(0, S, q_block):
        s1 = min(S, s0 + q_block)
        qb = q[s0:s1].reshape(s1 - s0, KV, G, hd).permute(1, 2, 0, 3)   # (KV, G, s, hd)
        scores = torch.einsum("kgsd,ktd->kgst", qb, kh[:, :s1]) / math.sqrt(hd)
        mask = torch.arange(s1, device=x.device)[None, :] <= torch.arange(
            s0, s1, device=x.device)[:, None]
        scores = scores.masked_fill(~mask, float("-inf"))
        o = torch.einsum("kgst,ktd->kgsd", torch.softmax(scores, dim=-1), vh[:, :s1])
        out[s0:s1] = o.permute(2, 0, 1, 3).reshape(s1 - s0, H, hd)
    wo = prec.weight(p["wo"], in_dims=2).reshape(H * hd, -1)
    return prec.act(out.reshape(S, H * hd)) @ wo


def swiglu(p: dict, x: torch.Tensor, prec: Precision, names=("w_in", "w_gate", "w_out")
           ) -> torch.Tensor:
    w_in, w_gate, w_out = (prec.weight(p[n]) for n in names)
    xa = prec.act(x)
    return prec.act(F.silu(xa @ w_gate) * (xa @ w_in)) @ w_out


def moe(p: dict, x: torch.Tensor, cfg: dict, prec: Precision, group_len: int
        ) -> torch.Tensor:
    """Top-k routing over ``n_experts`` SwiGLU experts of one sequence x (S, d).

    The router's softmax picks each position's top ``top_k`` experts, their
    gates renormalised to sum to 1.  The first ``group_len`` positions were
    dispatched together (one admission): an expert takes at most ``ceil(
    group_len * top_k / n_experts * capacity_factor)`` of their (position,
    choice) pairs, in position order, and drops the rest.  Every later
    position went out alone or in a group it could not overflow, and keeps
    both choices."""
    E, K = cfg["n_experts"], cfg["top_k"]
    S = x.shape[0]
    gates = torch.softmax(x @ p["router"].to(F32), dim=-1)             # the router is f32
    top_g, top_e = torch.topk(gates, K, dim=-1)
    top_g = top_g / top_g.sum(-1, keepdim=True)
    keep = torch.ones((S, K), dtype=torch.bool, device=x.device)
    if group_len:
        cap = math.ceil(group_len * K / E * cfg["capacity_factor"])
        g_e = top_e[:group_len]
        onehot = F.one_hot(g_e, E)                                     # (T, K, E)
        # pairs an expert took before this one, in position order
        before = onehot.sum(1).cumsum(0) - onehot.sum(1)               # (T, E)
        rank = torch.gather(before, 1, g_e)                            # (T, K)
        keep[:group_len] = rank < cap
    y = torch.zeros_like(x)
    xa = prec.act(x)
    for e in range(E):
        rows, slot = torch.nonzero((top_e == e) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        w_in = prec.weight(p["we_in"][e])
        w_gate = prec.weight(p["we_gate"][e])
        w_out = prec.weight(p["we_out"][e])
        xe = xa[rows]
        he = prec.act(F.silu(xe @ w_gate) * (xe @ w_in)) @ w_out
        y.index_add_(0, rows, he * top_g[rows, slot][:, None])
    return y


def mamba(p: dict, x: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    """The Mamba mixer of a batch x (B, S, d), as the configuration models it:
    in and gate projections, a causal depthwise conv of width
    ``ssm_conv_width`` then SiLU, dt (rank ``ceil(d / 16)``) through softplus,
    B and C from one projection, A = -exp(A_log), and a sequential scan
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, y_t = C_t h_t + D x_t, gated by
    SiLU(z), then the out projection."""
    Bsz, S, _ = x.shape
    N, W = cfg["ssm_state_dim"], cfg["ssm_conv_width"]
    xa = prec.act(x)
    xi = xa @ prec.weight(p["m_in"])
    z = xa @ prec.weight(p["m_z"])
    conv = p["m_conv"].to(F32)                                          # (W, di)
    xp = F.pad(xi, (0, 0, W - 1, 0))
    xc = F.silu(sum(xp[:, i:i + S] * conv[i] for i in range(W)))
    dbc = prec.act(xc) @ prec.weight(p["m_xproj"])
    R = p["m_dtproj"].shape[0]
    dt = F.softplus(prec.act(dbc[..., :R]) @ prec.weight(p["m_dtproj"]))
    Bm, Cm = dbc[..., R:R + N], dbc[..., R + N:]
    A = -torch.exp(p["m_Alog"].to(F32))                                 # (di, N)
    h = torch.zeros((Bsz, A.shape[0], N), dtype=F32, device=x.device)
    ys = torch.empty_like(xc)
    for t in range(S):
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * xc[:, t])[..., None] \
            * Bm[:, t, None, :]
        ys[:, t] = torch.einsum("bdn,bn->bd", h, Cm[:, t])
    y = (ys + p["m_D"].to(F32) * xc) * F.silu(z)
    return prec.act(y) @ prec.weight(p["m_out"])


def logits(params: dict, h: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    """Final norm and the untied head over rows h (n, d)."""
    hn = rmsnorm(h, params["final_norm"]["scale"], cfg["norm_eps"])
    return prec.act(hn) @ prec.weight(params["lm_head"])
