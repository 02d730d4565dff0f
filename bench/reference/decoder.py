"""The plain reference of both configurations: the dense Qwen3 decoder
(arXiv:2505.09388: RMSNorm, grouped-query attention with qk-norm and RoPE,
SwiGLU MLP, untied head) and Jamba's period (arXiv:2403.19887: Mamba layers
with a sequential scan, attention, dense SwiGLU and top-2 MoE layers), as
the configuration files state them: embeddings, periods of layers, the head.

Streams are processed one layer at a time, so each layer's weights are
rounded to float32 (or through fp8 for the control) once and dropped before
the next: the reference fits beside the program's bf16 weights.  A stream
is the token ids the model was fed at positions 0, 1, ..., in order; only
the logits at the positions asked for are formed.
"""

from __future__ import annotations

import torch

from bench.reference import layers as L

F32 = torch.float32


def _layer(tree, period: int):
    if isinstance(tree, dict):
        return {k: _layer(v, period) for k, v in tree.items()}
    return tree[period]


KINDS = ("attn+mlp", "attn+moe", "mamba+mlp", "mamba+moe")


def forward(params: dict, cfg: dict, streams: list[list[int]], read: list[list[int]],
            prec: L.Precision, admitted: list[int]) -> list[torch.Tensor]:
    """Logits (float32, one row a position of ``read[b]``) of each stream.

    ``admitted[b]`` is the length of stream b's first dispatch group, the
    admission forward whose MoE pairs share the experts' capacity (0 where
    admission dispatched no MoE layer together)."""
    unknown = set(cfg["block_pattern"]) - set(KINDS)
    if unknown:
        raise NotImplementedError(f"the reference has no layer of kind {sorted(unknown)}")
    dev = params["tok_embed"].device
    xs = [params["tok_embed"][torch.as_tensor(s, device=dev)].to(F32) for s in streams]
    for period in range(cfg["n_periods"]):
        for i, kind in enumerate(cfg["block_pattern"]):
            p = _layer(params["blocks"][f"{i:02d}_{kind}"], period)
            mixer, _, mlp = kind.partition("+")
            hs = [L.rmsnorm(x, p["norm1"]["scale"], cfg["norm_eps"]) for x in xs]
            if mixer == "attn":
                outs = [L.attention(p["mixer"], h, cfg, prec) for h in hs]
            else:
                outs = _mamba_batched(p["mixer"], hs, cfg, prec)
            xs = [x + o for x, o in zip(xs, outs)]
            hs = [L.rmsnorm(x, p["norm2"]["scale"], cfg["norm_eps"]) for x in xs]
            if mlp == "mlp":
                sizes = [h.shape[0] for h in hs]
                outs = list(L.swiglu(p["mlp"], torch.cat(hs), prec).split(sizes))
            else:
                outs = [L.moe(p["mlp"], h, cfg, prec, n) for h, n in zip(hs, admitted)]
            xs = [x + o for x, o in zip(xs, outs)]
            del p, hs, outs
    return [L.logits(params, x[torch.as_tensor(r, device=dev)], cfg, prec)
            for x, r in zip(xs, read)]


def _mamba_batched(p: dict, hs: list[torch.Tensor], cfg: dict, prec: L.Precision
                   ) -> list[torch.Tensor]:
    """The Mamba mixer over streams of different lengths, zero-padded at
    the end (a causal mixer: padding never reaches an earlier position)."""
    S = max(h.shape[0] for h in hs)
    batch = torch.stack([torch.nn.functional.pad(h, (0, 0, 0, S - h.shape[0])) for h in hs])
    out = L.mamba(p, batch, cfg, prec)
    return [out[b, :h.shape[0]] for b, h in enumerate(hs)]
