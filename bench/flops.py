"""The yardstick's arithmetic: model FLOPs of a token, the bytes a paged decode
launch needs, and the least time of a selective scan.  Plain Python over the
configuration file's ``model`` dict; nothing here reads the program.

The FLOPs are a copy of the JAX package's ``benchmarks/roofline.py``
analytic functions (written anew here, with no import), with the MoE counted
at its ``top_k`` experts a token (not the capacity buffers).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def _dt_rank(cfg: dict) -> int:
    return cfg["ssm_dt_rank"] or -(-cfg["d_model"] // 16)


def attn_linear_flops(cfg: dict) -> float:
    """q, k, v and output projections of one token."""
    d, H, KV, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    return 2 * d * (H + 2 * KV) * hd + 2 * H * hd * d


def attn_context_flops(cfg: dict, ctx: int) -> float:
    """QK^T and PV of one token over ``ctx`` positions."""
    return 4 * cfg["n_heads"] * cfg["head_dim"] * ctx


def mamba_flops(cfg: dict) -> float:
    d = cfg["d_model"]
    di = cfg["ssm_expand"] * d
    N = cfg["ssm_state_dim"]
    R = _dt_rank(cfg)
    return (2 * 2 * d * di + 2 * cfg["ssm_conv_width"] * di + 2 * di * (R + 2 * N)
            + 2 * R * di + 10 * di * N + 2 * di * d)


def mlp_flops(cfg: dict) -> float:
    return 3 * 2 * cfg["d_model"] * cfg["d_ff"]


def moe_flops(cfg: dict) -> float:
    """Router and the ``top_k`` SwiGLU experts a token is routed to."""
    d = cfg["d_model"]
    return 2 * d * cfg["n_experts"] + cfg["top_k"] * 3 * 2 * d * cfg["moe_d_ff"]


def token_flops(cfg: dict, ctx: int, head: bool) -> float:
    """Model FLOPs of one token attending over ``ctx`` positions (itself
    included), with the output head when ``head`` (a decoded token, whose
    logits are drawn from; an admitted or absorbed token's are not needed)."""
    f = 0.0
    for kind in cfg["block_pattern"]:
        mixer, _, mlp = kind.partition("+")
        if mixer == "attn":
            f += attn_linear_flops(cfg) + attn_context_flops(cfg, ctx)
        elif mixer == "mamba":
            f += mamba_flops(cfg)
        else:
            raise ValueError(f"no FLOPs for mixer {mixer!r}")
        f += mlp_flops(cfg) if mlp == "mlp" else moe_flops(cfg)
    f *= cfg["n_periods"]
    if head:
        f += 2 * cfg["d_model"] * cfg["vocab"]
    return f


def span_flops(cfg: dict, start: int, end: int) -> float:
    """Model FLOPs of teacher-forcing positions [start, end) (no head): the
    per-token part times the count, the attention part summed over contexts."""
    n = end - start
    if n <= 0:
        return 0.0
    flat = token_flops(cfg, 0, head=False)
    n_attn = cfg["n_periods"] * sum(1 for k in cfg["block_pattern"] if k.startswith("attn"))
    ctx_sum = (start + 1 + end) * n / 2                      # sum of p + 1 over the span
    return flat * n + n_attn * 4 * cfg["n_heads"] * cfg["head_dim"] * ctx_sum


def itemsize(cfg: dict) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[cfg["dtype"]]


def paged_decode_bytes(cfg: dict, distinct_pages: int, live: int, page_size: int) -> int:
    """Bytes one paged decode launch needs: K and V of every distinct page the
    live lanes' valid tokens reference (once, however many lanes share it),
    and each live lane's query and output."""
    item = itemsize(cfg)
    kv = 2 * distinct_pages * page_size * cfg["n_kv_heads"] * cfg["head_dim"] * item
    return kv + 2 * live * cfg["n_heads"] * cfg["head_dim"] * item


def scan_bound_s(cfg: dict, B: int, S: int) -> float:
    """The least time of one selective scan over (B, S) tokens: the larger of
    its bytes (dt and y in f32, x, B, C in the model dtype, A_log and the last
    state in f32, each once) at the HBM rate, one exponential a (t, d, n) on
    the special-function units, and 6 f32 operations a (t, d, n) at the f32
    peak (a frozen copy of ``chip_smoke.py::_scan_bound``)."""
    di, N, item = cfg["ssm_expand"] * cfg["d_model"], cfg["ssm_state_dim"], itemsize(cfg)
    nbytes = (B * S * di * (4 + item + 4) + 2 * B * S * N * item + di * N * 4
              + B * di * N * 4)
    n = B * S * di * N
    return max(nbytes / PEAKS["hbm_bytes_per_s"], n / PEAKS["sfu_exp_per_s"],
               6 * n / PEAKS["f32_flops_per_s"])


def pages(n_tokens: int, page_size: int) -> int:
    return math.ceil(n_tokens / page_size)
