"""Model assembly for the dense and paged planes (counterpart of ``repro/models/model.py``).

Parameters and caches keep the JAX package's layout: nested dicts keyed
``blocks/<ii>_<kind>/...`` with a leading ``n_periods`` axis on every stacked
leaf.  JAX's ``lax.scan`` over periods becomes a Python loop that indexes that
axis.  The kinds of ``PORTED_KINDS`` run: attention, Mamba, mLSTM and sLSTM
mixers, the audio decoder's ``dec`` (causal self-attention, then
cross-attention to the encoder's output) and the VLM's gated cross-attention
``xattn``; dense MLP or MoE (with qwen2-moe's shared experts or arctic's
dense residual).  Audio configs run a non-causal encoder (``enc_blocks``)
over frame embeddings and use sinusoidal positions in place of RoPE; VLM
configs project patch embeddings through ``enc_proj``.  Both take their
embeddings in the model's dtype and live on the dense plane only.

A dense cache (a "slot pool" when its batch axis holds a worker's lanes) is
``{"pos": (B,) int32, "blocks": {key: leaves}}``, where an attention layer's
leaves are ``{"k", "v": (P, B, C, KV, hd)}`` (a ``dec`` layer adds, and an
``xattn`` layer holds only, the cross K/V ``{"xk", "xv": (P, B, T, KV,
hd)}`` over the T encoder frames or image patches) and a recurrent layer's
are its state: Mamba ``{"h": (P, B, di, N) f32, "conv": (P, B, W-1,
di)}``, mLSTM ``{"C": (P, B, H, hd, hd), "n": (P, B, H, hd), "m": (P, B,
H)}`` and sLSTM
``{"h", "c", "n", "m": (P, B, H, hd)}``, the xLSTM leaves f32 with ``m``
starting at -1e30; with
a sliding window the attention leaves are a ring (token ``t`` at slot
``t % C``).  The paged pool is ``{"pos": (B,) int32, "page_table": (B,
num_pages) int32, "blocks": ...}`` where attention leaves are block pools
``{"k", "v": (P, NB, page_size, KV, hd)}`` and recurrent state keeps its
dense per-lane layout.  Functions that the JAX package writes as pure
(returning a new cache) update the cache's tensors **in place** here and
return the same dict; functions that must enlarge a tensor (``grow_*``,
``concat_pools``) put new tensors into the dict or return a new one, and the
gathers (``gather_slots``, ``paged_gather_*``) return copies.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import shard_config, shard_params, tp_split
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

PORTED_KINDS = ("attn+mlp", "attn+moe", "attn+moe_dr", "mamba+mlp", "mamba+moe",
                "mlstm", "slstm", "dec+mlp", "xattn+mlp")
CROSS_ARCHS = ("audio", "vlm")     # configs whose layers attend to embeddings
# recurrent mixers: (full-sequence function, one-token step)
RECURRENT = {"mamba": (L.mamba_full, L.mamba_step), "mlstm": (L.mlstm_full, L.mlstm_step),
             "slstm": (L.slstm_full, L.slstm_step)}
F32 = torch.float32


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless every layer kind of ``cfg`` is one the port runs."""
    missing = sorted(set(cfg.block_pattern) - set(PORTED_KINDS))
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {missing} are not ported yet (ported kinds: "
            f"{', '.join(PORTED_KINDS)})")


# ------------------------------------------------------------------ init

def _init_attn(cfg: ModelConfig, normal, ones, cross: bool = False) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = 0.02
    p = {"wq": normal((d, H, hd), s), "wk": normal((d, KV, hd), s),
         "wv": normal((d, KV, hd), s), "wo": normal((H, hd, d), s / math.sqrt(2 * cfg.n_layers))}
    if cfg.qk_norm and not cross:
        p["q_norm"] = ones((hd,))
        p["k_norm"] = ones((hd,))
    if cross:
        p["xgate"] = _then(ones(()), torch.Tensor.zero_)   # tanh(0) = 0: the gate starts closed
    return p


def _init_mlp(cfg: ModelConfig, normal) -> dict:
    d, s = cfg.d_model, 0.02
    p = {"w_in": normal((d, cfg.d_ff), s),
         "w_out": normal((cfg.d_ff, d), s / math.sqrt(2 * cfg.n_layers))}
    if cfg.activation == "swiglu":
        p["w_gate"] = normal((d, cfg.d_ff), s)
    return p


def _init_moe(cfg: ModelConfig, normal) -> dict:
    d, E, eff, s = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, 0.02
    p = {"router": normal((d, E), s, F32), "we_in": normal((E, d, eff), s),
         "we_out": normal((E, eff, d), s / math.sqrt(2 * cfg.n_layers))}
    if cfg.activation == "swiglu":
        p["we_gate"] = normal((E, d, eff), s)
    if cfg.shared_d_ff:
        sff = cfg.shared_d_ff
        p.update(ws_in=normal((d, sff), s), ws_gate=normal((d, sff), s),
                 ws_out=normal((sff, d), s), shared_gate=normal((d,), s))
    if cfg.dense_residual_ff:
        dff = cfg.dense_residual_ff
        p.update(wd_in=normal((d, dff), s), wd_gate=normal((d, dff), s),
                 wd_out=normal((dff, d), s))
    return p


def _init_mamba(cfg: ModelConfig, normal, ones) -> dict:
    d, s = cfg.d_model, 0.02
    di, N, W = cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_conv_width
    R = cfg.ssm_dt_rank or -(-d // 16)
    return {"m_in": normal((d, di), s), "m_z": normal((d, di), s),
            "m_conv": normal((W, di), 1.0 / math.sqrt(W)),
            "m_xproj": normal((di, R + 2 * N), s),
            "m_dtproj": normal((R, di), 1.0 / math.sqrt(R)),
            "m_Alog": _then(ones((di, N), F32), lambda t: torch.log(t.cumsum(-1))),  # log(1..N)
            "m_D": ones((di,), F32),
            "m_out": normal((di, d), s / math.sqrt(2 * cfg.n_layers))}


def _init_mlstm(cfg: ModelConfig, normal, ones) -> dict:
    d, H, s = cfg.d_model, cfg.n_heads, 0.02
    di = cfg.xlstm_expand * d
    hd = di // H
    return {"l_up": normal((d, di), s), "l_z": normal((d, di), s),
            "l_q": normal((di, H, hd), s), "l_k": normal((di, H, hd), s),
            "l_v": normal((di, H, hd), s), "l_ig": normal((di, H), s),
            "l_fg": _then(normal((di, H), s), lambda t: t.add_(1.0)),  # biased toward remembering
            "l_skip": ones((di,)),
            "l_down": normal((di, d), s / math.sqrt(2 * cfg.n_layers))}


def _init_slstm(cfg: ModelConfig, normal, ones) -> dict:
    d, H, s = cfg.d_model, cfg.n_heads, 0.02
    hd = d // H
    return {"s_w": normal((d, 4, H, hd), s), "s_r": normal((4, H, hd, hd), s),
            "s_b": _then(ones((4, H, hd)), torch.Tensor.zero_),
            "s_out": normal((d, d), s / math.sqrt(2 * cfg.n_layers))}


_MIXER_INIT = {"attn": _init_attn, "dec": _init_attn, "enc_attn": _init_attn,
               "xattn": lambda cfg, normal, ones: _init_attn(cfg, normal, ones, cross=True),
               "mamba": _init_mamba, "mlstm": _init_mlstm, "slstm": _init_slstm}


def _init_layer(cfg: ModelConfig, kind: str, normal, ones, norm) -> dict:
    """One layer kind's leaves, stacked as ``normal``/``ones``/``norm`` stack
    them.  A ``dec`` layer adds ``norm_x`` and its cross-attention ``xattn``."""
    mixer, _, mlp_kind = kind.partition("+")
    layer = {"norm1": norm(), "mixer": _MIXER_INIT[mixer](cfg, normal, ones)}
    if mixer == "dec":
        layer["norm_x"] = norm()
        layer["xattn"] = _init_attn(cfg, normal, ones, cross=True)
    if mlp_kind:
        layer["norm2"] = norm()
        layer["mlp"] = _init_mlp(cfg, normal) if mlp_kind == "mlp" else _init_moe(cfg, normal)
    return layer


def init_params(cfg: ModelConfig, seed: int = 0, device=None, mesh=None):
    """Random parameters with ``model.init_params``'s names, shapes, dtypes
    and scales.

    Drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``, so the
    numbers differ from ``jax.random``'s; to hold the port against the JAX
    package, convert the JAX pytree with ``repro_torch.params.from_jax``.

    With a ``mesh`` (``launch.mesh.WorkerMesh``) the weights are made already
    cut for it, as ``distributed.sharding.ShardedParams``: each leaf is drawn
    in the same order with the same generator on ``mesh.devices[0]`` (which
    takes the place of ``device``), cut as ``shard_params`` cuts it, its
    pieces moved to their devices, and dropped before the next is drawn.
    The result equals ``shard_params(init_params(cfg, seed,
    mesh.devices[0]), tp_split(cfg, mesh.degree), mesh)`` bit for bit, and
    device 0 holds its own shard and at most one whole leaf.
    """
    check_ported(cfg)
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(seed)
    draws = _param_draws(cfg, gen, dev)
    if mesh is not None:
        return shard_params(draws, tp_split(cfg, mesh.degree), mesh)
    return tree_map(lambda draw: draw(), draws)


def _param_draws(cfg: ModelConfig, gen: torch.Generator, dev) -> dict:
    """The params tree with every leaf a function that makes it.  Called in
    the tree's order (its insertion order), they draw from ``gen`` in the
    order a tree built at once would."""
    dtype = torch_dtype(cfg)
    d = cfg.d_model

    def randn(shape, scale, dt=dtype):
        return lambda: torch.randn(shape, generator=gen, device=dev, dtype=dt).mul_(scale)

    def full(shape, value, dt=dtype):
        return lambda: torch.full(shape, value, device=dev, dtype=dt)

    def norm(lead=()):                           # LayerNorm also has a bias
        p = {"scale": full(lead + (d,), 1.0)}
        if cfg.norm == "layernorm":
            p["bias"] = full(lead + (d,), 0.0)
        return p

    def stack(kinds, n):                         # leaves stacked over n layers
        def normal(shape, scale, dt=dtype):
            return randn((n,) + shape, scale, dt)

        def ones(shape, dt=dtype):
            return full((n,) + shape, 1.0, dt)

        return {f"{i:02d}_{kind}": _init_layer(cfg, kind, normal, ones, lambda: norm((n,)))
                for i, kind in enumerate(kinds)}

    params: dict[str, Any] = {"tok_embed": randn((cfg.vocab, d), 0.02), "final_norm": norm()}
    if not cfg.tie_embeddings:
        params["lm_head"] = randn((d, cfg.vocab), 0.02)
    params["blocks"] = stack(cfg.block_pattern, cfg.n_periods)
    if cfg.arch_type == "audio":
        params["enc_blocks"] = stack(("enc_attn+mlp",), cfg.encoder_layers)
        params["enc_norm"] = norm()
    if cfg.arch_type == "vlm":
        params["enc_proj"] = randn((d, d), 0.02)
    return params


def _then(draw, fn):
    """A leaf made by ``draw``, then passed through ``fn``."""
    return lambda: fn(draw())


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def tree_leaves(tree):
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def tree_items(tree, prefix: str = ""):
    """(path, tensor) of a nested dict's leaves in insertion order, the
    path its keys joined by ``/``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_to(tree, device):
    """A nested dict of tensors moved to ``device`` (tensors already there are
    returned as they are, not copied)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _period(tree, p: int):
    """View of one period's slice of a stacked parameter or cache tree."""
    if isinstance(tree, dict):
        return {k: _period(v, p) for k, v in tree.items()}
    return tree[p]


def _logits(cfg: ModelConfig, params, x) -> torch.Tensor:
    x = L.block_norm(cfg, params["final_norm"], x)
    head = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def _use_rope(cfg: ModelConfig) -> bool:
    """Audio configs take sinusoidal positions at the embedding, not RoPE."""
    return cfg.arch_type != "audio"


def _sin_cos(pos: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """Sinusoidal embeddings of f32 positions (..., 1) -> (..., d), computed
    in f32 and cast to ``dtype``."""
    dim = torch.arange(d // 2, dtype=F32, device=pos.device)
    ang = pos / torch.pow(10_000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _sinusoidal(seq: int, d: int, dtype, device) -> torch.Tensor:
    """(seq, d): positions 0 .. seq - 1."""
    return _sin_cos(torch.arange(seq, dtype=F32, device=device)[:, None], d, dtype)


def _sinusoidal_at(pos: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """(B, 1, d): each lane's position of ``pos`` (B,)."""
    return _sin_cos(pos.to(F32)[:, None], d, dtype)[:, None]


def _encoder(cfg: ModelConfig, params, embeds: torch.Tensor) -> torch.Tensor:
    """The audio encoder over precomputed frame embeddings (B, T, d):
    sinusoidal positions, then per encoder layer non-causal self-attention
    and the MLP, then ``enc_norm``."""
    B, T, D = embeds.shape
    x = embeds + _sinusoidal(T, D, embeds.dtype, embeds.device)[None]
    positions = torch.arange(T, device=embeds.device)
    stack = params["enc_blocks"]["00_enc_attn+mlp"]
    for li in range(cfg.encoder_layers):
        lp = _period(stack, li)
        h = L.block_norm(cfg, lp["norm1"], x)
        x = x + L.attention_full(lp["mixer"], h, cfg, positions, causal=False, use_rope=False)
        h = L.block_norm(cfg, lp["norm2"], x)
        x = x + L.mlp(lp["mlp"], h, cfg.activation)
    return L.block_norm(cfg, params["enc_norm"], x)


def _cross_source(cfg: ModelConfig, params, batch: dict) -> torch.Tensor | None:
    """What cross-attention attends to: the encoder's output over
    ``batch["encoder_embeds"]`` (audio) or ``batch["image_embeds"] @
    enc_proj`` (VLM); None for other configs.  The embeddings must be in the
    model's dtype: the port does not promote (the reference's f32 patch
    embeddings against bf16 weights would give f32 cross K/V beside bf16
    queries, which the decode kernel refuses)."""
    if cfg.arch_type not in CROSS_ARCHS:
        return None
    embeds = _cross_embeds(cfg, batch)
    if cfg.arch_type == "audio":
        return _encoder(cfg, params, embeds)
    return embeds @ params["enc_proj"]


def _cross_embeds(cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """The batch's frame (audio) or patch (VLM) embeddings, checked to be in
    the model's dtype."""
    name = "encoder_embeds" if cfg.arch_type == "audio" else "image_embeds"
    embeds = batch[name]
    if embeds.dtype != torch_dtype(cfg):
        raise TypeError(f"{cfg.name}: batch[{name!r}] is {embeds.dtype}, the model "
                        f"takes {torch_dtype(cfg)}")
    return embeds


# ------------------------------------------------------------------ gates

def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill serves linear (non-ring) caches without cross-attention or MoE."""
    for kind in cfg.block_pattern:
        mixer, _, mlp_kind = kind.partition("+")
        if mixer not in ("attn", "mamba", "mlstm", "slstm"):
            return False
        if mlp_kind not in ("", "mlp"):
            return False
    return cfg.sliding_window == 0 and cfg.arch_type not in CROSS_ARCHS


def supports_prefix_reuse(cfg: ModelConfig) -> bool:
    """Prefix KV implanting needs position-sliceable caches: attention-only stacks."""
    return supports_chunked_prefill(cfg) and all(
        k.partition("+")[0] == "attn" for k in cfg.block_pattern)


def supports_paged_kv(cfg: ModelConfig) -> bool:
    """Paged KV serves linear (non-ring) decoder-only stacks."""
    for kind in cfg.block_pattern:
        if kind.partition("+")[0] not in ("attn", "mamba", "mlstm", "slstm"):
            return False
    return cfg.sliding_window == 0 and cfg.arch_type not in CROSS_ARCHS


def _paged_kind(kind: str) -> bool:
    return kind.partition("+")[0] == "attn"


# ------------------------------------------------------------------ full forward

def _kv_from_full(cfg: ModelConfig, p: dict, h: torch.Tensor, positions: torch.Tensor,
                  lane: dict) -> None:
    """Write the K/V of a full forward into ``lane`` ({"k", "v": (B, C, KV, hd)},
    in place): positions ``[0, S)`` when ``C >= S``, else the last ``C``
    tokens at ring slots ``t % C`` (with or without a window)."""
    S = h.shape[1]
    k = torch.einsum("btd,dnk->btnk", h, p["wk"])
    v = torch.einsum("btd,dnk->btnk", h, p["wv"])
    if cfg.qk_norm:
        k = L.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if _use_rope(cfg):
        k = L.rope(k, positions, cfg.rope_theta)
    C = lane["k"].shape[1]
    if C >= S:
        lane["k"][:, :S] = k
        lane["v"][:, :S] = v
    else:
        keep = torch.arange(S - C, S, device=h.device)
        lane["k"][:, keep % C] = k[:, keep]
        lane["v"][:, keep % C] = v[:, keep]


def _cross_kv(p: dict, enc_out: torch.Tensor, lane: dict) -> None:
    """Write a cross-attention layer's K/V over ``enc_out`` (B, T, d) into
    ``lane``'s ``xk``/``xv`` (B, T, KV, hd), in place."""
    lane["xk"].copy_(torch.einsum("btd,dnk->btnk", enc_out, p["wk"]))
    lane["xv"].copy_(torch.einsum("btd,dnk->btnk", enc_out, p["wv"]))


def _mamba_state_from_full(cfg: ModelConfig, p: dict, h: torch.Tensor) -> dict:
    """A Mamba layer's recurrent state after a full-sequence forward over its
    normed input ``h`` (B, S, d): {"h": (B, di, N) f32, "conv": (B, W-1, di)}.
    The scan kernel writes its last state, so this is ``mamba_full``'s second
    output, and ``_layer_full`` takes it from the one ``mamba_full`` call it
    makes anyway (the JAX package re-runs a chunked scan here)."""
    return L.mamba_full(p, h, cfg)[1]


def _layer_full(cfg, kind, p, x, positions, lane, enc_out=None):
    """One layer over the full sequence; writes its cache leaves into ``lane``
    (when given) in place.  Cross-attention attends to ``enc_out`` (B, T, d).
    Returns (x, aux loss)."""
    mixer, _, mlp_kind = kind.partition("+")
    aux = torch.zeros((), dtype=F32, device=x.device)
    h = L.block_norm(cfg, p["norm1"], x)
    if mixer in ("attn", "dec"):
        x = x + L.attention_full(p["mixer"], h, cfg, positions, use_rope=_use_rope(cfg),
                                 window=cfg.sliding_window)
        if lane is not None:
            _kv_from_full(cfg, p["mixer"], h, positions, lane)
        if mixer == "dec":
            hx = L.block_norm(cfg, p["norm_x"], x)
            x = x + L.attention_full(p["xattn"], hx, cfg, positions, causal=False,
                                     use_rope=False, kv_input=enc_out)
            if lane is not None:
                _cross_kv(p["xattn"], enc_out, lane)
    elif mixer == "xattn":
        out = L.attention_full(p["mixer"], h, cfg, positions, causal=False, use_rope=False,
                               kv_input=enc_out)
        x = x + torch.tanh(p["mixer"]["xgate"]) * out
        if lane is not None:
            _cross_kv(p["mixer"], enc_out, lane)
    else:
        out, state = RECURRENT[mixer][0](p["mixer"], h, cfg)
        x = x + out
        if lane is not None:
            for name, leaf in lane.items():
                leaf.copy_(state[name])
    if mlp_kind:
        h = L.block_norm(cfg, p["norm2"], x)
        if mlp_kind == "mlp":
            x = x + L.mlp(p["mlp"], h, cfg.activation)
        else:
            out, aux = L.moe(p["mlp"], h, cfg)
            x = x + out
    return x, aux


def forward_full(cfg: ModelConfig, params, batch: dict, capacity: int | None = None,
                 remat: bool = False, return_hidden: bool = False, mesh=None):
    """Full-sequence forward.  batch["tokens"]: (B, S); audio configs also take
    ``batch["encoder_embeds"]`` (B, T, d) and VLM configs
    ``batch["image_embeds"]`` (B, T, d), in the model's dtype.

    Returns (logits (B, S, V), aux_loss) or, with ``capacity``, (logits,
    aux_loss, cache), where the dense cache of ``capacity`` slots decodes from
    position S onward (with the cross K/V over the T embeddings, for audio
    and VLM).  ``aux_loss`` sums the MoE layers' load-balance losses (0
    without MoE).  ``remat=True`` checkpoints each period under autograd
    (only the residual stream between periods is kept; the period is run
    again in the backward).  ``return_hidden=True`` returns the final-normed
    hidden states (B, S, d) in place of the logits, for the chunked
    cross-entropy of ``rl/grpo.py``, which never forms the full logits.

    With a ``mesh`` (``launch.mesh.WorkerMesh``), ``params`` is a list of its
    shards and the forward is a tensor-parallel worker's whole-prompt
    admission (or, for audio and VLM configs, the model API's admission
    over their embeddings): no autograd, no remat; the logits come back on
    the mesh's device 0 and the cache, with ``capacity``, as a list of one
    cache per shard (the shard's kv heads, cross K/V heads, Mamba channels
    and xLSTM heads).
    """
    if mesh is not None:
        if remat or return_hidden:
            raise ValueError("forward_full on a mesh is admission only (no remat, no hidden "
                             "states): the training plane runs at MP degree 1")
        return _forward_full_tp(cfg, params, batch, capacity, mesh)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, device=dev)
    x = params["tok_embed"][tokens.long()]
    if cfg.arch_type == "audio":
        x = x + _sinusoidal(S, cfg.d_model, x.dtype, dev)[None]
    enc_out = _cross_source(cfg, params, batch)
    cache = None if capacity is None else init_cache(
        cfg, B, capacity, dev, start_pos=S, enc_len=None if enc_out is None else enc_out.shape[1])

    def period(pi, x, aux):
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i:02d}_{kind}"
            lane = None if cache is None else _period(cache["blocks"][key], pi)
            x, a = _layer_full(cfg, kind, _period(params["blocks"][key], pi), x, positions,
                               lane, enc_out)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=F32, device=dev)
    for pi in range(cfg.n_periods):
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(period, pi, x, aux, use_reentrant=False)
        else:
            x, aux = period(pi, x, aux)
    if return_hidden:
        return L.block_norm(cfg, params["final_norm"], x), aux
    logits = _logits(cfg, params, x)
    return (logits, aux) if cache is None else (logits, aux, cache)


# ------------------------------------------------------------------ decode

def _merge_state(active: torch.Tensor | None, new: dict, cache: dict) -> None:
    """Write a recurrent layer's ``new`` state into ``cache`` in place, on
    active lanes only (all lanes without a mask): a masked lane keeps its
    state, since a recurrent update is destructive.  Attention KV needs no
    merge (a masked step writes the frozen ``pos`` slot, overwritten when the
    lane resumes)."""
    for name, leaf in cache.items():
        val = new[name].to(leaf.dtype)
        if active is not None:
            m = active.reshape(active.shape + (1,) * (val.dim() - 1))
            val = torch.where(m, val, leaf)
        leaf.copy_(val)


def _mlp_step(cfg, mlp_kind, p, x):
    if not mlp_kind:
        return x
    h = L.block_norm(cfg, p["norm2"], x)
    if mlp_kind == "mlp":
        return x + L.mlp(p["mlp"], h, cfg.activation)
    return x + L.moe(p["mlp"], h, cfg)[0]


def _layer_step(cfg, kind, p, x, cache, pos, page_table, active):
    mixer, _, mlp_kind = kind.partition("+")
    h = L.block_norm(cfg, p["norm1"], x)
    if mixer in RECURRENT:
        out, new = RECURRENT[mixer][1](p["mixer"], h, cfg, cache)
        _merge_state(active, new, cache)
    elif mixer == "xattn":
        out = torch.tanh(p["mixer"]["xgate"]) * L.cross_attention_decode(
            p["mixer"], h, cfg, cache["xk"], cache["xv"])
    elif page_table is None:
        out, _, _ = L.attention_decode(p["mixer"], h, cfg, cache["k"], cache["v"], pos,
                                       window=cfg.sliding_window, use_rope=_use_rope(cfg))
    else:
        out, _, _ = L.attention_decode_paged(p["mixer"], h, cfg, cache["k"], cache["v"],
                                             page_table, pos)
    x = x + out
    if mixer == "dec":
        hx = L.block_norm(cfg, p["norm_x"], x)
        x = x + L.cross_attention_decode(p["xattn"], hx, cfg, cache["xk"], cache["xv"])
    return _mlp_step(cfg, mlp_kind, p, x)


def decode_step(cfg: ModelConfig, params, cache: dict, tokens: torch.Tensor,
                active: torch.Tensor | None = None, mesh=None):
    """One decode step.  tokens: (B, 1) int; cache: a dense cache or a paged
    pool (it has a ``page_table``).  Returns (logits (B, V), cache), the cache
    updated in place.

    With a ``mesh`` (``launch.mesh.WorkerMesh``), ``params`` and ``cache`` are
    lists of its shards (``shard_params``, and one pool or cache per shard
    with the shard's kv heads); the logits come back on the mesh's device 0.

    ``active``: optional (B,) bool lane mask.  Inactive lanes do not advance
    ``pos`` and keep their recurrent state; their KV write lands at the
    frozen ``pos`` slot (their own slot or page, or scratch) and is
    overwritten when the lane resumes.  Their logits are garbage and the
    caller masks them.  (With MoE, masked lanes still compete for expert
    capacity, as in the JAX package.)
    """
    if mesh is not None:
        return _decode_step_tp(cfg, params, cache, tokens, active, mesh)
    pos = cache["pos"]
    page_table = cache.get("page_table")
    x = params["tok_embed"][tokens.long()]
    if cfg.arch_type == "audio":
        x = x + _sinusoidal_at(pos, cfg.d_model, x.dtype)
    for pi in range(cfg.n_periods):
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i:02d}_{kind}"
            x = _layer_step(cfg, kind, _period(params["blocks"][key], pi), x,
                            _period(cache["blocks"][key], pi), pos, page_table, active)
    logits = _logits(cfg, params, x)
    cache["pos"] = pos + 1 if active is None else pos + active.to(torch.int32)
    return logits[:, 0], cache


# ------------------------------------------------------------------ dense cache

def _state_leaves(cfg: ModelConfig, kind: str, lanes: int, device) -> dict:
    """Fresh recurrent state of one layer kind for ``lanes`` lanes: Mamba's
    zeroed, xLSTM's as the layers start it (``m`` at -1e30)."""
    mixer = kind.partition("+")[0]
    P, H = cfg.n_periods, cfg.n_heads
    if mixer == "mamba":
        di = cfg.d_inner
        return {"h": torch.zeros((P, lanes, di, cfg.ssm_state_dim), dtype=F32, device=device),
                "conv": torch.zeros((P, lanes, cfg.ssm_conv_width - 1, di),
                                    dtype=torch_dtype(cfg), device=device)}
    if mixer == "mlstm":
        st = L.fresh_mlstm_state(P * lanes, H, cfg.mlstm_inner // H, device)
    else:
        st = L.fresh_slstm_state(P * lanes, H, cfg.slstm_inner // H, device)
    return {name: t.reshape((P, lanes) + tuple(t.shape[1:])) for name, t in st.items()}


def init_cache(cfg: ModelConfig, batch_size: int, capacity: int, device,
               start_pos: int = 0, enc_len: int | None = None) -> dict:
    """Empty dense cache: ``capacity`` zeroed KV slots per lane and attention
    layer (with a sliding window, the ring's size), ``enc_len`` zeroed cross
    K/V slots per lane and cross-attention layer (required where the config
    has one), fresh recurrent state per lane and recurrent layer."""
    check_ported(cfg)
    dtype = torch_dtype(cfg)

    def zeros(slots):
        return torch.zeros((cfg.n_periods, batch_size, slots, cfg.n_kv_heads, cfg.hd),
                           dtype=dtype, device=device)

    blocks = {}
    for i, kind in enumerate(cfg.block_pattern):
        mixer = kind.partition("+")[0]
        if mixer in RECURRENT:
            c = _state_leaves(cfg, kind, batch_size, device)
        else:
            c = {} if mixer == "xattn" else {"k": zeros(capacity), "v": zeros(capacity)}
        if mixer in ("dec", "xattn"):
            if enc_len is None:
                raise ValueError(f"{cfg.name}: a cross-attention cache needs enc_len, the "
                                 "number of encoder frames or image patches")
            c.update(xk=zeros(enc_len), xv=zeros(enc_len))
        blocks[f"{i:02d}_{kind}"] = c
    return {"pos": torch.full((batch_size,), start_pos, dtype=torch.int32, device=device),
            "blocks": blocks}


def _recurrent_chunk(step_fn, cfg, p, h, state, length):
    """Run a recurrent mixer's one-token ``step_fn`` over a (1, C) chunk; rows
    >= ``length`` are padding and keep the previous state.  ``state`` (a
    lane's leaves, batch 1) is updated in place.  Returns the chunk's mixer
    output."""
    outs = []
    for j in range(h.shape[1]):
        out, new = step_fn(p, h[:, j:j + 1], cfg, state)
        if j < length:
            _merge_state(None, new, state)
        outs.append(out)
    return torch.cat(outs, dim=1)


def _chunk_mlp(cfg, mlp_kind, p, x):
    if mlp_kind not in ("", "mlp"):
        raise ValueError("prefill_chunk: MoE layers are not chunk-safe "
                         "(padding rows would consume expert capacity)")
    return _mlp_step(cfg, mlp_kind, p, x)


def _layer_chunk(cfg, kind, p, x, cache, off, length):
    mixer, _, mlp_kind = kind.partition("+")
    h = L.block_norm(cfg, p["norm1"], x)
    if mixer in RECURRENT:
        out = _recurrent_chunk(RECURRENT[mixer][1], cfg, p["mixer"], h, cache, length)
    else:
        out, _, _ = L.attention_prefill_chunk(p["mixer"], h, cfg, cache["k"], cache["v"],
                                              off, length)
    return _chunk_mlp(cfg, mlp_kind, p, x + out)


def prefill_chunk(cfg: ModelConfig, params, cache: dict, tokens: torch.Tensor,
                  length: int, mesh=None) -> dict:
    """Teacher-force a fixed-shape (1, C) chunk into a batch-1 dense lane.

    Rows >= ``length`` of ``tokens`` are padding.  The chunk lands at positions
    ``pos .. pos + length`` where ``pos = cache["pos"][0]`` (read on the
    device).  Updates the lane in place, advances ``pos`` by ``length`` and
    returns it.  Linear (non-ring) lanes without MoE only
    (``supports_chunked_prefill``).  With a ``mesh``, ``params`` and ``cache``
    are lists of its shards (as for ``decode_step``).
    """
    if tokens.shape[0] != 1:
        raise ValueError("prefill_chunk operates on one lane (batch 1)")
    if mesh is not None:
        return _prefill_chunk_tp(cfg, params, cache, tokens, length, mesh)
    off = cache["pos"][0].clone()
    x = params["tok_embed"][tokens.long()]
    for pi in range(cfg.n_periods):
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i:02d}_{kind}"
            x = _layer_chunk(cfg, kind, _period(params["blocks"][key], pi), x,
                             _period(cache["blocks"][key], pi), off, length)
    cache["pos"] += length
    return cache


def _lane_leaves(pool: dict, lane: dict):
    """(pool leaf, lane leaf) pairs of two caches with the same layer keys."""
    for key, c in pool["blocks"].items():
        for name, leaf in c.items():
            yield leaf, lane["blocks"][key][name]


def copy_prefix(pool: dict, src_slot: int, lane: dict, n: int) -> dict:
    """Implant the first ``n`` positions of pool lane ``src_slot`` into the
    batch-1 ``lane`` (radix-cache prefix reuse), in place; positions from
    ``n`` on keep the lane's contents.  Sets ``lane["pos"] = n``.
    Attention-only caches (``supports_prefix_reuse``)."""
    for src, dst in _lane_leaves(pool, lane):
        dst[:, 0, :n] = src[:, src_slot, :n]
    lane["pos"].fill_(n)
    return lane


def write_slot(pool: dict, lane: dict, slot: int) -> dict:
    """Write a batch-1 cache ``lane`` (from any device) into lane ``slot`` of a
    slot pool, in place."""
    for dst, src in _lane_leaves(pool, lane):
        dst[:, slot] = src[:, 0].to(device=dst.device, dtype=dst.dtype)
    pool["pos"][slot] = lane["pos"][0].to(pool["pos"].device)
    return pool


def gather_slots(pool: dict, idx) -> dict:
    """Copy lanes ``idx`` out of a slot pool as a standalone batch-len(idx)
    cache on the pool's device."""
    idx = torch.as_tensor(idx, dtype=torch.long).to(pool["pos"].device)
    return {"pos": pool["pos"][idx],
            "blocks": {key: {name: leaf[:, idx] for name, leaf in c.items()}
                       for key, c in pool["blocks"].items()}}


def concat_pools(a: dict, b: dict) -> dict:
    """A new slot pool: ``a``'s lanes then ``b``'s (pool growth)."""
    return {"pos": torch.cat([a["pos"], b["pos"]]),
            "blocks": {key: {name: torch.cat([leaf, b["blocks"][key][name]], dim=1)
                             for name, leaf in c.items()}
                       for key, c in a["blocks"].items()}}


# ------------------------------------------------------------------ paged pool

def init_paged_pool(cfg: ModelConfig, max_lanes: int, num_blocks: int, page_size: int,
                    num_pages: int, device) -> dict:
    """Empty paged pool: zeroed block pools for every attention kind, fresh
    dense per-lane state for every recurrent kind.  Audio and VLM configs
    live on the dense plane only (``supports_paged_kv``)."""
    check_ported(cfg)
    if cfg.arch_type in CROSS_ARCHS:
        raise ValueError(f"{cfg.name}: cross-attention caches have no paged layout")
    dtype = torch_dtype(cfg)
    shape = (cfg.n_periods, num_blocks, page_size, cfg.n_kv_heads, cfg.hd)
    blocks = {}
    for i, kind in enumerate(cfg.block_pattern):
        blocks[f"{i:02d}_{kind}"] = (
            {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)} if _paged_kind(kind)
            else _state_leaves(cfg, kind, max_lanes, device))
    return {"pos": torch.zeros((max_lanes,), dtype=torch.int32, device=device),
            "page_table": torch.zeros((max_lanes, num_pages), dtype=torch.int32,
                                      device=device),
            "blocks": blocks}


def _paged_blocks(pool: dict):
    """(key, leaves) of the paged (attention) layers."""
    return [(key, c) for key, c in pool["blocks"].items() if _paged_kind(key[3:])]


def _state_blocks(pool: dict):
    """(key, leaves) of the layers whose state stays dense per lane."""
    return [(key, c) for key, c in pool["blocks"].items() if not _paged_kind(key[3:])]


def _layer_chunk_paged(cfg, kind, p, x, cache, pt_row, slot, off, length):
    mixer, _, mlp_kind = kind.partition("+")
    h = L.block_norm(cfg, p["norm1"], x)
    if mixer in RECURRENT:                   # the lane's dense state row, a view
        state = {name: leaf[slot:slot + 1] for name, leaf in cache.items()}
        out = _recurrent_chunk(RECURRENT[mixer][1], cfg, p["mixer"], h, state, length)
    else:
        out, _, _ = L.attention_prefill_chunk_paged(p["mixer"], h, cfg, cache["k"],
                                                    cache["v"], pt_row, off, length)
    return _chunk_mlp(cfg, mlp_kind, p, x + out)


def prefill_chunk_paged(cfg: ModelConfig, params, pool: dict, slot: int,
                        tokens: torch.Tensor, length: int, mesh=None) -> dict:
    """Teacher-force a fixed-shape (1, C) chunk straight into lane ``slot``'s pages.

    Rows >= ``length`` of ``tokens`` are padding.  The chunk lands at positions
    ``pos[slot] .. pos[slot] + length``; ``pos[slot]`` is read on the device.
    K/V scatter to the lane's mapped blocks and queries attend through the
    gathered page view (resident prefix, possibly shared pages, plus the
    chunk's own causal keys); recurrent state updates the lane's dense row.
    Updates the pool in place and returns it.  With a ``mesh``, ``params`` and
    ``pool`` are lists of its shards (as for ``decode_step``).
    """
    if tokens.shape[0] != 1:
        raise ValueError("prefill_chunk_paged operates on one lane (batch 1)")
    if mesh is not None:
        return _prefill_chunk_tp(cfg, params, pool, tokens, length, mesh, slot)
    off = pool["pos"][slot].clone()
    pt_row = pool["page_table"][slot]
    x = params["tok_embed"][tokens.long()]
    for pi in range(cfg.n_periods):
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i:02d}_{kind}"
            x = _layer_chunk_paged(cfg, kind, _period(params["blocks"][key], pi), x,
                                   _period(pool["blocks"][key], pi), pt_row, slot, off,
                                   length)
    pool["pos"][slot] += length
    return pool


def _row(pool: dict, row) -> torch.Tensor:
    return torch.as_tensor(row, dtype=torch.int32).to(pool["page_table"].device)


def paged_set_lane(pool: dict, slot: int, row, pos0: int) -> dict:
    """Map lane ``slot``: write its page-table row and reset its position."""
    pool["pos"][slot] = pos0
    pool["page_table"][slot] = _row(pool, row)
    return pool


def paged_fresh_state(cfg: ModelConfig, pool: dict, slot: int) -> dict:
    """Give lane ``slot`` a fresh recurrent state (``init_cache``'s), in
    place, so that a chunked admission into a reused lane starts as a dense
    admission does.  (The JAX package's paged admission leaves the previous
    occupant's state in the row, so a reused lane starts from it.)"""
    dev = pool["pos"].device
    _write_state_row(pool, {key: _state_leaves(cfg, key[3:], 1, dev)
                            for key, _ in _state_blocks(pool)}, slot)
    return pool


def paged_set_row(pool: dict, slot: int, row) -> dict:
    """Rewrite one page-table row without touching ``pos``."""
    pool["page_table"][slot] = _row(pool, row)
    return pool


def paged_copy_block(pool: dict, dst: int, src: int) -> dict:
    """Device-to-device copy of one physical block across every paged leaf."""
    for _, c in _paged_blocks(pool):
        for leaf in c.values():
            leaf[:, dst] = leaf[:, src]
    return pool


def _index(pool: dict, blocks_idx) -> torch.Tensor:
    return torch.as_tensor(blocks_idx, dtype=torch.long).to(pool["pos"].device)


def paged_gather_pages(pool: dict, blocks_idx) -> dict:
    """Copy physical blocks ``blocks_idx`` out of every paged leaf as compact
    (P, n, page_size, KV, hd) stacks (the D2D migration payload)."""
    idx = _index(pool, blocks_idx)
    return {key: {name: leaf[:, idx] for name, leaf in c.items()}
            for key, c in _paged_blocks(pool)}


def paged_gather_state(pool: dict, slot: int) -> dict:
    """A batch-1 copy of lane ``slot``'s dense (non-paged) leaves and ``pos``."""
    return {"pos": pool["pos"][slot:slot + 1].clone(),
            "blocks": {key: {name: leaf[:, slot:slot + 1].clone() for name, leaf in c.items()}
                       for key, c in _state_blocks(pool)}}


def paged_scatter_pages(pool: dict, pages: dict, blocks_idx) -> dict:
    """Write page stacks (from :func:`paged_gather_pages`) into blocks ``blocks_idx``."""
    idx = _index(pool, blocks_idx)
    for key, pg in pages.items():
        for name, leaf in pool["blocks"][key].items():
            leaf[:, idx] = torch.as_tensor(pg[name]).to(device=leaf.device, dtype=leaf.dtype)
    return pool


def _write_state_row(pool: dict, blocks: dict, slot: int) -> None:
    """Lane ``slot`` of every dense leaf <- the batch-1 leaves ``blocks``."""
    for key, c in _state_blocks(pool):
        for name, leaf in c.items():
            leaf[:, slot] = torch.as_tensor(blocks[key][name][:, 0]).to(
                device=leaf.device, dtype=leaf.dtype)


def paged_write_state(pool: dict, state: dict, slot: int, row) -> dict:
    """Write a lane's ``state`` (from :func:`paged_gather_state`, on any
    device) into lane ``slot`` and map its page-table row."""
    _write_state_row(pool, state["blocks"], slot)
    pool["pos"][slot] = torch.as_tensor(state["pos"]).to(pool["pos"].device)[0]
    pool["page_table"][slot] = _row(pool, row)
    return pool


def paged_write_lane(pool: dict, lane: dict, slot: int, row, n: int) -> dict:
    """Implant a dense batch-1 ``lane`` (from any device) into the paged pool,
    in place: its first ``n`` KV positions scatter into the blocks mapped by
    ``row`` (num_pages,), its recurrent state goes to lane ``slot``'s dense
    rows, and lane ``slot`` takes its ``pos`` and ``row``.  Positions past
    ``n`` (and past the row's pages) are not written.  Serves full-sequence
    admission and the cross-layout migration ingress."""
    row_t = _row(pool, row)
    num_pages = row_t.shape[0]
    dev = pool["pos"].device
    for key, c in _paged_blocks(pool):
        ps = c["k"].shape[2]
        j = torch.arange(min(n, lane["blocks"][key]["k"].shape[2], num_pages * ps), device=dev)
        blk, off = row_t[j // ps].long(), j % ps
        for name, leaf in c.items():
            src = lane["blocks"][key][name][:, 0].to(device=dev, dtype=leaf.dtype)
            leaf[:, blk, off] = src[:, j]
    _write_state_row(pool, lane["blocks"], slot)
    pool["pos"][slot] = lane["pos"][0].to(dev)
    pool["page_table"][slot] = row_t
    return pool


def pages_to_lane(pages: dict, state: dict, capacity: int) -> dict:
    """Reassemble a dense batch-1 lane from gathered pages and lane state
    (cross-layout migration and restore): the page stacks flatten back to a
    contiguous (P, 1, capacity, KV, hd) lane, zero-padded past the resident
    span, on the pages' device; the recurrent state is carried as it is."""
    blocks = {key: dict(c) for key, c in state["blocks"].items()}
    for key, pg in pages.items():
        out = {}
        for name, x in pg.items():
            P, n, ps = x.shape[:3]
            flat = x.reshape((P, n * ps) + tuple(x.shape[3:]))
            if capacity > n * ps:
                pad = flat.new_zeros((P, capacity - n * ps) + tuple(x.shape[3:]))
                flat = torch.cat([flat, pad], dim=1)
            out[name] = flat[:, None, :capacity]             # add the lane axis
        blocks[key] = out
    return {"pos": torch.as_tensor(state["pos"]), "blocks": blocks}


def grow_paged_blocks(pool: dict, extra: int) -> dict:
    """Append ``extra`` zeroed physical blocks to every paged leaf (block ids stay)."""
    for _, c in _paged_blocks(pool):
        for name, leaf in c.items():
            pad = leaf.new_zeros((leaf.shape[0], extra) + tuple(leaf.shape[2:]))
            c[name] = torch.cat([leaf, pad], dim=1)
    return pool


def grow_paged_lanes(cfg: ModelConfig, pool: dict, extra: int) -> dict:
    """Append ``extra`` empty lanes: ``pos``, page-table rows and the dense
    per-lane state (fresh, as ``init_cache``'s) grow, the block pools are
    untouched."""
    pool["pos"] = torch.cat([pool["pos"], pool["pos"].new_zeros((extra,))])
    pt = pool["page_table"]
    pool["page_table"] = torch.cat([pt, pt.new_zeros((extra, pt.shape[1]))])
    for key, c in _state_blocks(pool):
        fresh = _state_leaves(cfg, key[3:], extra, pool["pos"].device)
        for name, leaf in c.items():
            c[name] = torch.cat([leaf, fresh[name]], dim=1)
    return pool


# ------------------------------------------------------------------ tensor parallel
# A worker of MP degree d on a mesh of d shards (``distributed/sharding.py``):
# each shard runs the layer functions on its own params, K/V, cross K/V and
# recurrent state with a shard config (H/d, KV/d, d_ff/d, Mamba's and the
# xLSTM's inner widths over d and the shared / dense-residual widths over d
# when cut; every expert routed, its E/d run), and the partial outputs are
# summed in shard order by ``mesh.reduce``: the self- and cross-attention's
# ``wo``, the MLP's and MoE's output products, Mamba's ``m_xproj`` (between
# the layer's two halves) and ``m_out`` products, the mLSTM's q/k/v/gate
# (between its halves) and ``l_down`` products and the sLSTM's ``s_out``
# product.  The residual stream is replicated: every shard holds the same
# hidden states, the audio encoder's and the VLM's projected patches too.
# Every config has a split; a group whose widths do not divide by d is
# replicated.


def _tp_setup(cfg: ModelConfig, mesh):
    split = tp_split(cfg, mesh.degree)
    return split, shard_config(cfg, split)


def _tp_embed(cfg, split, mesh, params: list, tokens: torch.Tensor, pos: list | None = None
              ) -> list:
    """Every shard's copy of the embedded tokens.  With the vocabulary cut,
    each shard looks the tokens up in its slice (zero outside it) and the
    slices are summed: one of them is non-zero, so the sum is exact.  Audio
    configs add the sinusoidal positions: each lane's of ``pos`` (every
    shard's (B,) positions, a decode step) or the prompt's 0 .. S - 1."""
    toks = mesh.broadcast(tokens.long())
    if not split.vocab:
        xs = [p["tok_embed"][t] for p, t in zip(params, toks)]
    else:
        parts = []
        for r, (p, t) in enumerate(zip(params, toks)):
            n = p["tok_embed"].shape[0]
            local = t - r * n
            rows = p["tok_embed"][local.clamp(0, n - 1)]
            parts.append(torch.where(((local >= 0) & (local < n))[..., None], rows,
                                     torch.zeros_like(rows)))
        xs = mesh.reduce(parts)
    if cfg.arch_type != "audio":
        return xs
    if pos is None:
        return [x + _sinusoidal(x.shape[1], cfg.d_model, x.dtype, x.device)[None] for x in xs]
    return [x + _sinusoidal_at(q, cfg.d_model, x.dtype) for x, q in zip(xs, pos)]


def _tp_sum(mesh, parts: list, cut: bool) -> list:
    """Every shard's copy of the sum of a cut group's partials (in shard
    order); a replicated group's outputs, the same on every shard, as they
    are."""
    return mesh.reduce(parts) if cut else parts


def _tp_add(mesh, xs: list, outs: list, cut: bool) -> list:
    """The residual add of a cut layer's summed partials, or of a replicated
    layer's output (the same on every shard)."""
    return [x + o for x, o in zip(xs, _tp_sum(mesh, outs, cut))]


# the TPSplit group that decides whether a mixer's output is a partial
_MIXER_GROUP = {"attn": "attn", "dec": "attn", "xattn": "attn", "enc_attn": "attn",
                "mamba": "ssm", "mlstm": "xlstm", "slstm": "xlstm"}


def _tp_moe(cfg, split, r: int, p: dict, h: torch.Tensor):
    """Shard ``r``'s part of an MoE layer: its experts' pairs when the
    experts are cut, its ``d_ff`` slice of the shared / dense-residual MLP
    when those are; a replicated group is added by shard 0 alone when the
    layer's partials are summed, and by every shard when nothing is cut.
    Returns (output, aux loss)."""
    lead = r == 0 or not split.any_moe()
    e0 = r * p["we_in"].shape[0] if split.experts else 0
    return L.moe(p, h, cfg, e0=e0, experts=split.experts or lead, side=split.moe_ff or lead)


def _tp_layer(cfg, split, mesh, kind: str, ps: list, xs: list, mix, cross=None):
    """One layer on every shard: ``mix(hs)`` gives every shard's mixer
    output on its normed input (its part of the output product where the
    mixer is cut; a gated ``xattn`` layer's gate scales the sum), then a
    ``dec`` layer's ``cross(hxs)`` gives its cross-attention's on the
    ``norm_x``-normed stream, then the dense MLP or MoE runs on its shard's
    part.  Returns (xs, shard 0's MoE aux loss or None)."""
    mixer, _, mlp_kind = kind.partition("+")
    cut = getattr(split, _MIXER_GROUP[mixer])
    hs = [L.block_norm(cfg, p["norm1"], x) for p, x in zip(ps, xs)]
    outs = _tp_sum(mesh, mix(hs), cut)
    if mixer == "xattn":
        outs = [torch.tanh(p["mixer"]["xgate"]) * o for p, o in zip(ps, outs)]
    xs = [x + o for x, o in zip(xs, outs)]
    if mixer == "dec":
        xs = _tp_add(mesh, xs, cross([L.block_norm(cfg, p["norm_x"], x)
                                      for p, x in zip(ps, xs)]), cut)
    aux = None
    if mlp_kind == "mlp":
        outs = [L.mlp(p["mlp"], L.block_norm(cfg, p["norm2"], x), cfg.activation)
                for p, x in zip(ps, xs)]
        xs = _tp_add(mesh, xs, outs, split.mlp)
    elif mlp_kind:
        pairs = [_tp_moe(cfg, split, r, p["mlp"], L.block_norm(cfg, p["norm2"], x))
                 for r, (p, x) in enumerate(zip(ps, xs))]
        xs = _tp_add(mesh, xs, [o for o, _ in pairs], split.any_moe())
        aux = pairs[0][1]
    return xs, aux


def _tp_logits(cfg, split, mesh, params: list, xs: list) -> torch.Tensor:
    """Logits on device 0: each shard's vocabulary slice, gathered; with the
    vocabulary replicated, shard 0's."""
    if not split.vocab:
        return _logits(cfg, params[0], xs[0])
    return mesh.gather([_logits(cfg, p, x) for p, x in zip(params, xs)], -1)


def _tp_periods(cfg, params: list, caches: list | None):
    """(kind, each shard's layer params, each shard's layer cache or None) in order."""
    for pi in range(cfg.n_periods):
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i:02d}_{kind}"
            yield (kind, [_period(p["blocks"][key], pi) for p in params],
                   [None if c is None else _period(c["blocks"][key], pi)
                    for c in (caches or [None] * len(params))])


def _tp_encoder(cfg, split, mesh, params: list, embeds: torch.Tensor) -> list:
    """``_encoder`` on the mesh: each encoder layer's attention on the
    shard's heads and its MLP on the shard's ``d_ff``, the partials summed;
    ``enc_norm`` on every shard's copy.  Returns every shard's copy of the
    encoder's output."""
    T, D = embeds.shape[1:]
    xs = [e + _sinusoidal(T, D, e.dtype, e.device)[None] for e in mesh.broadcast(embeds)]
    positions = [torch.arange(T, device=dev) for dev in mesh.devices]
    for li in range(cfg.encoder_layers):
        ps = [_period(p["enc_blocks"]["00_enc_attn+mlp"], li) for p in params]

        def mix(hs, ps=ps):
            return [L.attention_full(p["mixer"], h, cfg, pos, causal=False, use_rope=False)
                    for p, h, pos in zip(ps, hs, positions)]
        xs, _ = _tp_layer(cfg, split, mesh, "enc_attn+mlp", ps, xs, mix)
    return [L.block_norm(cfg, p["enc_norm"], x) for p, x in zip(params, xs)]


def _tp_cross_source(cfg, split, mesh, params: list, batch: dict) -> list | None:
    """``_cross_source`` on the mesh: every shard's copy of what its
    cross-attention attends to (the VLM's ``enc_proj`` is replicated)."""
    if cfg.arch_type not in CROSS_ARCHS:
        return None
    embeds = _cross_embeds(cfg, batch)
    if cfg.arch_type == "audio":
        return _tp_encoder(cfg, split, mesh, params, embeds)
    return [e @ p["enc_proj"] for p, e in zip(params, mesh.broadcast(embeds))]


def _lane_copy(lane: dict | None, state: dict) -> None:
    """A recurrent layer's last ``state`` into its ``lane`` leaves (when given)."""
    for name, leaf in (lane or {}).items():
        leaf.copy_(state[name])


def _tp_mamba_full(cfg, split, mesh, ps: list, hs: list, lanes: list) -> list:
    """A Mamba layer's full form on every shard: the first halves, the sum
    of the partial projections, then the scan on each shard's channels;
    each shard's last state goes into its lane (when given)."""
    firsts = [L.mamba_full_in(p["mixer"], h, cfg) for p, h in zip(ps, hs)]
    dbcs = _tp_sum(mesh, [f[3] for f in firsts], split.ssm)
    outs = []
    for p, (xc, z, conv, _), dbc, lane in zip(ps, firsts, dbcs, lanes):
        out, h_last = L.mamba_full_out(p["mixer"], xc, z, dbc, cfg)
        _lane_copy(lane, {"h": h_last, "conv": conv})
        outs.append(out)
    return outs


def _tp_mamba_step(cfg, split, mesh, ps: list, hs: list, states: list):
    """One Mamba step on every shard from its ``states``.  Returns (outputs,
    new states); the states passed in are not changed."""
    firsts = [L.mamba_step_in(p["mixer"], h, st) for p, h, st in zip(ps, hs, states)]
    dbcs = _tp_sum(mesh, [f[3] for f in firsts], split.ssm)
    pairs = [L.mamba_step_out(p["mixer"], xc, z, hist, dbc, st, cfg)
             for p, (xc, z, hist, _), dbc, st in zip(ps, firsts, dbcs, states)]
    return [o for o, _ in pairs], [n for _, n in pairs]


def _tp_mlstm_qkv(split, mesh, firsts: list) -> list:
    """Every shard's (q, k, v, i_pre, f_pre) on its heads: the shards'
    partial products summed in shard order (the gates in f32), then each
    shard's H/d heads taken; uncut, each shard's own whole products."""
    if not split.xlstm:
        return [f[2] for f in firsts]
    d = split.degree
    sums = [mesh.reduce([f[2][j] for f in firsts]) for j in range(5)]
    return [tuple(s[r].chunk(d, dim=-2 if j < 3 else -1)[r] for j, s in enumerate(sums))
            for r in range(d)]


def _tp_mlstm_full(cfg, split, mesh, ps: list, hs: list, lanes: list) -> list:
    """An mLSTM layer's full form on every shard: the first halves, the sum
    of the partial q/k/v/gate products, then the cell on each shard's heads;
    each shard's carry goes into its lane (when given)."""
    firsts = [L.mlstm_in(p["mixer"], h) for p, h in zip(ps, hs)]
    outs = []
    for p, (xi, z, _), qkv, lane in zip(ps, firsts, _tp_mlstm_qkv(split, mesh, firsts), lanes):
        out, st = L.mlstm_full_out(p["mixer"], xi, z, qkv)
        _lane_copy(lane, st)
        outs.append(out)
    return outs


def _tp_mlstm_step(cfg, split, mesh, ps: list, hs: list, states: list):
    """One mLSTM step on every shard from its ``states`` (its heads').
    Returns (outputs, new states); the states passed in are not changed."""
    firsts = [L.mlstm_in(p["mixer"], h[:, 0]) for p, h in zip(ps, hs)]
    pairs = [L.mlstm_step_out(p["mixer"], xi, z, qkv, st)
             for p, (xi, z, _), qkv, st in zip(ps, firsts, _tp_mlstm_qkv(split, mesh, firsts),
                                               states)]
    return [o for o, _ in pairs], [n for _, n in pairs]


def _tp_slstm_full(cfg, split, mesh, ps: list, hs: list, lanes: list) -> list:
    """An sLSTM layer on every shard's heads (its ``s_w`` pre-activations
    need no sum); each shard's last state goes into its lane (when given)."""
    outs = []
    for p, h, lane in zip(ps, hs, lanes):
        out, st = L.slstm_full(p["mixer"], h, cfg)
        _lane_copy(lane, st)
        outs.append(out)
    return outs


def _tp_slstm_step(cfg, split, mesh, ps: list, hs: list, states: list):
    """One sLSTM step on every shard's heads.  Returns (outputs, new states)."""
    pairs = [L.slstm_step(p["mixer"], h, cfg, st) for p, h, st in zip(ps, hs, states)]
    return [o for o, _ in pairs], [n for _, n in pairs]


# a recurrent mixer on the mesh: (full form, one step), as ``RECURRENT``'s
_TP_RECURRENT = {"mamba": (_tp_mamba_full, _tp_mamba_step),
                 "mlstm": (_tp_mlstm_full, _tp_mlstm_step),
                 "slstm": (_tp_slstm_full, _tp_slstm_step)}


def _tp_recurrent_chunk(step, cfg, split, mesh, ps: list, hs: list, states: list,
                        length: int) -> list:
    """``_recurrent_chunk`` on a mesh: the chunk's tokens stepped one by one
    through ``step`` on every shard, each shard's lane ``states`` (batch 1)
    updated in place by the first ``length``."""
    outs = [[] for _ in ps]
    for j in range(hs[0].shape[1]):
        step_outs, news = step(cfg, split, mesh, ps, [h[:, j:j + 1] for h in hs], states)
        for r, (o, new, st) in enumerate(zip(step_outs, news, states)):
            if j < length:
                _merge_state(None, new, st)
            outs[r].append(o)
    return [torch.cat(o, dim=1) for o in outs]


@torch.no_grad()
def _forward_full_tp(cfg, params: list, batch: dict, capacity: int | None, mesh):
    """``forward_full`` on a mesh (see there): every layer on every shard,
    attention on its heads writing its lane's K/V (ring slots too),
    cross-attention on its heads writing its cross K/V, Mamba's and the
    mLSTM's two halves around the summed products, the sLSTM on its heads,
    MoE on its expert range."""
    split, scfg = _tp_setup(cfg, mesh)
    B, S = batch["tokens"].shape
    xs = _tp_embed(cfg, split, mesh, params, batch["tokens"])
    encs = _tp_cross_source(scfg, split, mesh, params, batch)
    positions = [torch.arange(S, device=dev) for dev in mesh.devices]
    enc_len = None if encs is None else encs[0].shape[1]
    caches = None if capacity is None else [
        init_cache(scfg, B, capacity, dev, start_pos=S, enc_len=enc_len) for dev in mesh.devices]
    encs = encs or [None] * mesh.degree
    rope = _use_rope(cfg)
    aux = torch.zeros((), dtype=F32, device=mesh.devices[0])

    def cross_attend(ps, hs, lanes, name):
        outs = []
        for p, h, pos, lane, enc in zip(ps, hs, positions, lanes, encs):
            outs.append(L.attention_full(p[name], h, scfg, pos, causal=False, use_rope=False,
                                         kv_input=enc))
            if lane is not None:
                _cross_kv(p[name], enc, lane)
        return outs

    for kind, ps, lanes in _tp_periods(cfg, params, caches):
        mixer = kind.partition("+")[0]
        if mixer in _TP_RECURRENT:
            def mix(hs, ps=ps, lanes=lanes, full=_TP_RECURRENT[mixer][0]):
                return full(scfg, split, mesh, ps, hs, lanes)
        elif mixer == "xattn":
            def mix(hs, ps=ps, lanes=lanes):
                return cross_attend(ps, hs, lanes, "mixer")
        else:
            def mix(hs, ps=ps, lanes=lanes):
                outs = []
                for p, h, pos, lane in zip(ps, hs, positions, lanes):
                    outs.append(L.attention_full(p["mixer"], h, scfg, pos, use_rope=rope,
                                                 window=scfg.sliding_window))
                    if lane is not None:
                        _kv_from_full(scfg, p["mixer"], h, pos, lane)
                return outs
        xs, a = _tp_layer(scfg, split, mesh, kind, ps, xs, mix,
                          lambda hxs, ps=ps, lanes=lanes: cross_attend(ps, hxs, lanes, "xattn"))
        if a is not None:
            aux = aux + a.to(aux.device)
    logits = _tp_logits(scfg, split, mesh, params, xs)
    return (logits, aux) if caches is None else (logits, aux, caches)


def _decode_step_tp(cfg, params: list, caches: list, tokens, active, mesh):
    split, scfg = _tp_setup(cfg, mesh)
    xs = _tp_embed(cfg, split, mesh, params, tokens, [c["pos"] for c in caches])
    paged = "page_table" in caches[0]
    acts = [None] * mesh.degree if active is None else mesh.broadcast(active)
    rope = _use_rope(cfg)

    def cross_attend(ps, hs, cs, name):
        return [L.cross_attention_decode(p[name], h, scfg, c["xk"], c["xv"])
                for p, h, c in zip(ps, hs, cs)]

    for kind, ps, cs in _tp_periods(cfg, params, caches):
        mixer = kind.partition("+")[0]
        if mixer in _TP_RECURRENT:
            def mix(hs, ps=ps, cs=cs, step=_TP_RECURRENT[mixer][1]):
                outs, news = step(scfg, split, mesh, ps, hs, cs)
                for a, new, c in zip(acts, news, cs):
                    _merge_state(a, new, c)
                return outs
        elif mixer == "xattn":
            def mix(hs, ps=ps, cs=cs):
                return cross_attend(ps, hs, cs, "mixer")
        else:
            def mix(hs, ps=ps, cs=cs):
                outs = []
                for p, h, c, pool in zip(ps, hs, cs, caches):
                    if paged:
                        outs.append(L.attention_decode_paged(
                            p["mixer"], h, scfg, c["k"], c["v"], pool["page_table"],
                            pool["pos"])[0])
                    else:
                        outs.append(L.attention_decode(p["mixer"], h, scfg, c["k"], c["v"],
                                                       pool["pos"], window=scfg.sliding_window,
                                                       use_rope=rope)[0])
                return outs
        xs, _ = _tp_layer(scfg, split, mesh, kind, ps, xs, mix,
                          lambda hxs, ps=ps, cs=cs: cross_attend(ps, hxs, cs, "xattn"))
    logits = _tp_logits(scfg, split, mesh, params, xs)
    for cache, a in zip(caches, acts):
        cache["pos"] = cache["pos"] + 1 if a is None else cache["pos"] + a.to(torch.int32)
    return logits[:, 0], caches


def _prefill_chunk_tp(cfg, params: list, caches: list, tokens, length: int, mesh,
                      slot: int | None = None):
    """``prefill_chunk`` (``slot`` None: each shard's batch-1 lane) or
    ``prefill_chunk_paged`` (lane ``slot`` of each shard's pool) on a mesh."""
    split, scfg = _tp_setup(cfg, mesh)
    if any(k.partition("+")[2] not in ("", "mlp") for k in cfg.block_pattern):
        raise ValueError("prefill_chunk: MoE layers are not chunk-safe "
                         "(padding rows would consume expert capacity)")
    row = 0 if slot is None else slot
    offs = [c["pos"][row].clone() for c in caches]
    xs = _tp_embed(cfg, split, mesh, params, tokens)
    for kind, ps, cs in _tp_periods(cfg, params, caches):
        mixer = kind.partition("+")[0]
        if mixer in _TP_RECURRENT:
            states = [{name: leaf[row:row + 1] for name, leaf in c.items()} for c in cs]

            def mix(hs, ps=ps, states=states, step=_TP_RECURRENT[mixer][1]):
                return _tp_recurrent_chunk(step, scfg, split, mesh, ps, hs, states, length)
        else:
            def mix(hs, ps=ps, cs=cs):
                if slot is None:
                    return [L.attention_prefill_chunk(p["mixer"], h, scfg, c["k"], c["v"],
                                                      off, length)[0]
                            for p, h, c, off in zip(ps, hs, cs, offs)]
                return [L.attention_prefill_chunk_paged(p["mixer"], h, scfg, c["k"], c["v"],
                                                        pool["page_table"][slot], off,
                                                        length)[0]
                        for p, h, c, pool, off in zip(ps, hs, cs, caches, offs)]
        xs, _ = _tp_layer(scfg, split, mesh, kind, ps, xs, mix)
    for c in caches:
        c["pos"][row] += length
    return caches
