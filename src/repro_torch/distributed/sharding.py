"""Logical-axis sharding rules and the tensor-parallel split (counterpart of
``repro/distributed/sharding.py``).

The JAX package names every tensor dim with a *logical* axis, maps logical
axes to mesh axes through a rules table, and lets GSPMD place each tensor on
a worker's ``("data", "model")`` sub-mesh.  Eager PyTorch has no GSPMD.  The
port keeps the reference's tables (``DEFAULT_RULES``, ``PARAM_LOGICAL_AXES``,
``CACHE_LOGICAL_AXES``) and its rules engine as pure functions over a mesh's
axis sizes (``{"data": 1, "model": d}``), which say where the reference puts
each tensor, and adds the split that a worker of MP degree ``d`` executes
itself, Megatron-style (``tp_split``):

  * attention: ``wq``/``wo`` cut on the q heads and ``wk``/``wv`` on the kv
    heads into ``d`` contiguous pieces, only when both head counts divide by
    ``d`` (q head ``h`` reads kv head ``h // G``, so shard ``r`` holds kv heads
    ``[r KV/d, (r+1) KV/d)`` and exactly the q heads that read them).  The K/V
    pool and cache follow: cut on the kv-head dim, or replicated;
  * the MLP: ``w_gate``/``w_in`` cut on ``d_ff`` (columns), ``w_out`` on its
    rows, when ``d_ff`` divides;
  * the vocabulary: ``tok_embed``'s rows and ``lm_head``'s columns, when the
    vocabulary divides;
  * Mamba on ``d_inner``, when it divides: ``m_in``, ``m_z``, ``m_conv`` and
    ``m_dtproj`` by columns, ``m_Alog`` and ``m_D`` by rows, and ``m_xproj``
    and ``m_out`` on their ``d_inner`` rows.  A shard's ``m_xproj`` product
    is a partial of the (dt, B, C) projection, which is summed before the
    scan; the scan then runs on the shard's channels.  The state follows:
    ``h`` (..., di, N) cut on ``di`` and ``conv`` (..., W-1, di) too;
  * MoE experts on ``experts``, when the count divides: shard ``r`` holds
    experts ``[r E/d, (r+1) E/d)``.  The router stays replicated, and every
    shard routes over all E experts (capacity and drops as one device
    computes them), then runs and combines only its own;
  * the shared experts' and the dense residual's ``d_ff`` (``ws_*``,
    ``wd_*``), when every such width divides; ``shared_gate`` stays
    replicated (the gate scales a sum, so it scales each partial);
  * the xLSTM on its heads, when they and the mLSTM's inner width divide:
    the mLSTM's ``l_up``, ``l_z`` by columns and ``l_skip`` with them;
    ``l_q``, ``l_k``, ``l_v``, ``l_ig``, ``l_fg`` and ``l_down`` on their
    ``d_inner`` rows.  A shard's q/k/v/gate products are partials, summed
    before the cell, which then runs on the shard's H/d heads: exactly its
    ``d_inner`` columns, head ``j`` owning columns ``[j hd, (j+1) hd)``.
    The sLSTM's ``s_w``, ``s_r`` and ``s_b`` on the heads dim and
    ``s_out`` on its rows.  The state follows on its heads dim: the
    mLSTM's ``C`` (..., H, hd, hd), ``n`` (..., H, hd), ``m`` (..., H) and
    the sLSTM's ``h``, ``c``, ``n``, ``m`` (..., H, hd);
  * cross-attention as attention (its ``wk``/``wv`` columns write the
    shard's ``xk``/``xv``), the audio encoder's layers as a decoder's;
  * everything else is replicated: the norms, ``q_norm``/``k_norm`` (they act
    on a whole head), the router, ``xgate``, the VLM's ``enc_proj``, and
    attention whose heads do not divide (smollm's 3 heads at degree 2), as
    the reference's divisibility rule degrades it.

A cache leaf's cut is decided by the layer it belongs to, not by its name
alone: Mamba's ``h`` is cut on ``d_inner`` and sLSTM's ``h`` on its heads
(the reference's table maps both names to one entry and notes the
collision).

Each shard computes its partial output and the partials are summed in shard
order (``launch.mesh.WorkerMesh.reduce``).  The placement differs from
GSPMD's where the port cuts to keep a shard's work whole:

  * the reference's cache rule gives the model axis to the first divisible
    dim of ``k``/``v``, which is ``kv_seq``; the port cuts the kv heads, so
    that each shard's decode kernel reads whole sequences;
  * the reference leaves the mLSTM's ``C`` replicated and puts ``n``/``m``
    on ``d_inner`` (``CACHE_LOGICAL_AXES``, which ``cache_pspecs`` keeps
    reporting); the port cuts all three on the heads, as the cell runs;
  * the reference leaves ``s_out`` on ``fsdp`` alone, so GSPMD gathers the
    sLSTM's ``h``; the port cuts its rows and sums the partials.

The arithmetic is the same, up to the order of f32 sums.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.models.config import ShardConfig

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": ("model",),
    "d_ff": ("model",),
    "d_inner": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "kv_seq": ("model",),     # sequence-sharded decode KV (used when heads don't divide)
    "fsdp": ("data",),        # ZeRO-3-style second param axis
    "act_seq": ("model",),    # sequence-parallel residual stream (Megatron-SP style)
    "dispatch": ("data",),    # MoE dispatch groups (per-data-shard capacity)
    "d_model": (),
    "seq": (),
    "state": (),
}

# leaf parameter name -> logical axes of its (unstacked) dims
PARAM_LOGICAL_AXES: dict[str, tuple[Optional[str], ...]] = {
    "tok_embed": ("vocab", "fsdp"),
    "lm_head": ("fsdp", "vocab"),
    "enc_proj": ("fsdp", "d_model"),
    # attention / cross-attention
    "wq": ("fsdp", "heads", "head_dim"),
    "wk": ("fsdp", "kv_heads", "head_dim"),
    "wv": ("fsdp", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "fsdp"),
    "q_norm": ("head_dim",),
    "k_norm": ("head_dim",),
    "xgate": (),
    # dense MLP
    "w_gate": ("fsdp", "d_ff"),
    "w_in": ("fsdp", "d_ff"),
    "w_out": ("d_ff", "fsdp"),
    # MoE
    "router": ("d_model", "experts"),
    "we_gate": ("experts", "fsdp", None),
    "we_in": ("experts", "fsdp", None),
    "we_out": ("experts", None, "fsdp"),
    "ws_gate": ("fsdp", "d_ff"),
    "ws_in": ("fsdp", "d_ff"),
    "ws_out": ("d_ff", "fsdp"),
    "shared_gate": ("d_model",),
    "wd_gate": ("fsdp", "d_ff"),
    "wd_in": ("fsdp", "d_ff"),
    "wd_out": ("d_ff", "fsdp"),
    # Mamba
    "m_in": ("fsdp", "d_inner"),
    "m_z": ("fsdp", "d_inner"),
    "m_conv": (None, "d_inner"),
    "m_xproj": ("d_inner", None),
    "m_dtproj": (None, "d_inner"),
    "m_Alog": ("d_inner", "state"),
    "m_D": ("d_inner",),
    "m_out": ("d_inner", "fsdp"),
    # mLSTM
    "l_up": ("fsdp", "d_inner"),
    "l_z": ("fsdp", "d_inner"),
    "l_q": ("d_inner", "heads", "head_dim"),
    "l_k": ("d_inner", "heads", "head_dim"),
    "l_v": ("d_inner", "heads", "head_dim"),
    "l_ig": ("d_inner", "heads"),
    "l_fg": ("d_inner", "heads"),
    "l_og": ("d_inner", "d_inner"),
    "l_down": ("d_inner", "fsdp"),
    "l_skip": ("d_inner",),
    # sLSTM
    "s_w": ("fsdp", None, "heads", "head_dim"),
    "s_r": (None, "heads", "head_dim", None),
    "s_b": (None, "heads", "head_dim"),
    "s_out": ("fsdp", "d_model"),
    # norms
    "scale": ("d_model",),
    "bias": ("d_model",),
}

# leaf cache name -> logical axes (right-aligned against the leaf's ndim; extra
# leading dims -- period stacking -- get None)
CACHE_LOGICAL_AXES: dict[str, tuple[Optional[str], ...]] = {
    "pos": ("batch",),
    "page_table": ("batch", None),
    "k": ("batch", "kv_seq", "kv_heads", None),
    "v": ("batch", "kv_seq", "kv_heads", None),
    "xk": ("batch", None, "kv_heads", None),
    "xv": ("batch", None, "kv_heads", None),
    "h": ("batch", "d_inner", None),
    "conv": ("batch", None, "d_inner"),
    "C": ("batch", None, None, None),
    "n": ("batch", "d_inner", None),
    "c": ("batch", "d_inner", None),
    "m": ("batch", "d_inner"),
}

Spec = tuple  # per dim: None, a mesh axis name, or a tuple of mesh axis names


# ---------------------------------------------------------------- the rules engine

def logical_pspec(shape: Sequence[int], dims: Sequence[Optional[str]],
                  sizes: Optional[dict[str, int]] = None,
                  rules: Optional[dict] = None) -> Spec:
    """Per-dim mesh axes for ``shape`` given per-dim logical names, on a mesh
    of axis sizes ``sizes`` (None: no mesh, every dim replicated).

    A mesh axis is assigned to a dim only if (a) the rules map the logical
    name to it, (b) the axis exists in the mesh, (c) the dim size is
    divisible by the (product of) axis size(s), and (d) the axis is not
    already used by an earlier dim.
    """
    rules = DEFAULT_RULES if rules is None else rules
    if sizes is None:
        return (None,) * len(shape)
    used: set[str] = set()
    spec: list = []
    for dim_size, logical in zip(shape, dims):
        assigned = None
        if logical is not None:
            axes = tuple(a for a in rules.get(logical, ()) if a in sizes and a not in used)
            if axes:
                prod = 1
                for a in axes:
                    prod *= sizes[a]
                if prod > 1 and dim_size % prod == 0:
                    assigned = axes if len(axes) > 1 else axes[0]
                    used.update(axes)
                else:
                    # each candidate axis alone (e.g. batch=("pod","data"))
                    for a in axes:
                        if sizes[a] > 1 and dim_size % sizes[a] == 0:
                            assigned = a
                            used.add(a)
                            break
        spec.append(assigned)
    return tuple(spec)


def _aligned(dims: tuple, ndim: int) -> tuple:
    """Logical dims right-aligned to ``ndim``: stacked leading dims get None."""
    if len(dims) < ndim:
        return (None,) * (ndim - len(dims)) + dims
    return dims[len(dims) - ndim:]


def _map_named(fn, tree, path: tuple = ()):
    """``fn(path of keys, leaf)`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _name(path: tuple) -> str:
    return path[-1] if path else ""


def _specs(tree, table: dict, sizes: Optional[dict[str, int]]):
    def walk(path, leaf):
        dims = table.get(_name(path))
        if sizes is None or dims is None:
            return (None,) * leaf.dim()
        return logical_pspec(tuple(leaf.shape), _aligned(tuple(dims), leaf.dim()), sizes)

    return _map_named(walk, tree)


def param_pspecs(params, sizes: Optional[dict[str, int]] = None):
    """Per-leaf specs of a params tree (leaf-name lookup in ``PARAM_LOGICAL_AXES``)."""
    return _specs(params, PARAM_LOGICAL_AXES, sizes)


def cache_pspecs(cache, sizes: Optional[dict[str, int]] = None):
    """Per-leaf specs of a dense cache or paged pool (``CACHE_LOGICAL_AXES``)."""
    return _specs(cache, CACHE_LOGICAL_AXES, sizes)


def dispatch_groups(n_tokens: int, sizes: Optional[dict[str, int]] = None,
                    rules: Optional[dict] = None) -> int:
    """MoE dispatch-group count: one group per data shard, halved until it
    divides ``n_tokens``.  1 without a mesh."""
    if sizes is None:
        return 1
    g = 1
    for a in (DEFAULT_RULES if rules is None else rules).get("batch", ()):
        g *= sizes.get(a, 1)
    while g > 1 and n_tokens % g:
        g //= 2
    return max(g, 1)


# ---------------------------------------------------------------- the executed split

# leaf -> (ndim of the unstacked leaf, the group that decides the cut, the dim cut)
_TP_LEAVES = {
    "wq": (3, "attn", 1), "wk": (3, "attn", 1), "wv": (3, "attn", 1), "wo": (3, "attn", 0),
    "w_gate": (2, "mlp", 1), "w_in": (2, "mlp", 1), "w_out": (2, "mlp", 0),
    "tok_embed": (2, "vocab", 0), "lm_head": (2, "vocab", 1),
    "m_in": (2, "ssm", 1), "m_z": (2, "ssm", 1), "m_conv": (2, "ssm", 1),
    "m_dtproj": (2, "ssm", 1), "m_Alog": (2, "ssm", 0), "m_D": (1, "ssm", 0),
    "m_xproj": (2, "ssm", 0), "m_out": (2, "ssm", 0),
    "we_gate": (3, "experts", 0), "we_in": (3, "experts", 0), "we_out": (3, "experts", 0),
    "ws_gate": (2, "moe_ff", 1), "ws_in": (2, "moe_ff", 1), "ws_out": (2, "moe_ff", 0),
    "wd_gate": (2, "moe_ff", 1), "wd_in": (2, "moe_ff", 1), "wd_out": (2, "moe_ff", 0),
    "l_up": (2, "xlstm", 1), "l_z": (2, "xlstm", 1), "l_skip": (1, "xlstm", 0),
    "l_q": (3, "xlstm", 0), "l_k": (3, "xlstm", 0), "l_v": (3, "xlstm", 0),
    "l_ig": (2, "xlstm", 0), "l_fg": (2, "xlstm", 0), "l_down": (2, "xlstm", 0),
    "s_w": (4, "xlstm", 2), "s_r": (4, "xlstm", 1), "s_b": (3, "xlstm", 1),
    "s_out": (2, "xlstm", 0),
}
KV_LEAVES = ("k", "v", "xk", "xv")          # cache leaves (..., KV, hd): cut on dim -2
# a recurrent layer's state, by mixer: the dim cut (from the end) and the group
STATE_LEAVES = {"mamba": ({"h": -2, "conv": -1}, "ssm"),          # d_inner
                "mlstm": ({"C": -3, "n": -2, "m": -1}, "xlstm"),  # heads
                "slstm": ({"h": -2, "c": -2, "n": -2, "m": -2}, "xlstm")}


def mixer_of(path: tuple) -> str:
    """The mixer of the layer a cache leaf at ``path`` belongs to: its
    parent key is the layer's (``"03_attn+moe"`` -> ``"attn"``), else ""."""
    parent = path[-2] if len(path) > 1 else ""
    head, sep, kind = parent.partition("_")
    return kind.partition("+")[0] if sep and head.isdigit() else ""


@dataclass(frozen=True)
class TPSplit:
    """Which groups of leaves a worker of MP degree ``degree`` cuts into
    ``degree`` contiguous pieces; the rest are replicated on every shard."""

    degree: int
    attn: bool              # q/kv heads (and the K/V they write)
    mlp: bool               # d_ff
    vocab: bool             # the vocabulary
    ssm: bool = False       # Mamba's d_inner (and its state)
    experts: bool = False   # the MoE experts
    moe_ff: bool = False    # the shared experts' and dense residual's d_ff
    xlstm: bool = False     # the mLSTM's and sLSTM's heads (and their state)

    def param_dim(self, name: str, ndim: int) -> int | None:
        """The dim of param leaf ``name`` (``ndim`` dims, stacked or not) that
        is cut, or None where it is replicated."""
        rule = _TP_LEAVES.get(name)
        if rule is None or not getattr(self, rule[1]):
            return None
        return rule[2] + ndim - rule[0]

    def cache_dim(self, name: str, ndim: int, mixer: str = "attn") -> int | None:
        """The cut dim of a cache leaf of a ``mixer`` layer: a K/V leaf's kv
        heads when attention is cut, a Mamba state leaf's ``d_inner`` when
        Mamba is, an xLSTM state leaf's heads when the xLSTM is; else None."""
        if name in KV_LEAVES:
            return ndim - 2 if self.attn else None
        dims, group = STATE_LEAVES.get(mixer, ({}, ""))
        if name in dims and getattr(self, group):
            return ndim + dims[name]
        return None

    def any_moe(self) -> bool:
        """Whether an MoE layer's output is a sum of per-shard partials."""
        return self.experts or self.moe_ff


def tp_split(cfg, degree: int) -> TPSplit:
    """The split of ``cfg`` over ``degree`` shards (degree 1 cuts nothing)."""
    d = int(degree)
    if d < 1:
        raise ValueError(f"MP degree must be >= 1, got {degree}")
    cut = d > 1
    mixers = {k.partition("+")[0] for k in cfg.block_pattern}
    side = [w for w in (cfg.shared_d_ff, cfg.dense_residual_ff) if w]
    heads = cfg.n_heads % d == 0
    return TPSplit(d, attn=cut and heads and cfg.n_kv_heads % d == 0,
                   mlp=cut and cfg.d_ff > 0 and cfg.d_ff % d == 0,
                   vocab=cut and cfg.vocab % d == 0,
                   ssm=cut and "mamba" in mixers and cfg.d_inner % d == 0,
                   experts=cut and cfg.n_experts > 0 and cfg.n_experts % d == 0,
                   moe_ff=cut and bool(side) and all(w % d == 0 for w in side),
                   xlstm=cut and bool(mixers & {"mlstm", "slstm"}) and heads
                   and cfg.mlstm_inner % d == 0)


def shard_config(cfg, split: TPSplit) -> ShardConfig:
    """The config one shard computes with: its heads, ``d_ff``, vocabulary,
    Mamba and xLSTM inner widths and shared / dense-residual widths
    (``head_dim``, ``ssm_inner`` and ``xlstm_inner`` kept explicit, since
    ``d_model // n_heads`` and the expansions of ``d_model`` no longer give
    them).  ``n_experts`` stays the whole count: every shard routes over all
    experts.  The heads are cut with attention or with the xLSTM."""
    d = split.degree

    def cut(width, flag):
        return width // d if flag else width

    widths = dict(n_heads=cut(cfg.n_heads, split.attn or split.xlstm),
                  n_kv_heads=cut(cfg.n_kv_heads, split.attn),
                  d_ff=cut(cfg.d_ff, split.mlp), vocab=cut(cfg.vocab, split.vocab),
                  ssm_inner=cut(cfg.d_inner, split.ssm),
                  xlstm_inner=cut(cfg.mlstm_inner, split.xlstm),
                  shared_d_ff=cut(cfg.shared_d_ff, split.moe_ff),
                  dense_residual_ff=cut(cfg.dense_residual_ff, split.moe_ff))
    return ShardConfig(**{**vars(cfg), **widths, "head_dim": cfg.hd})


def _piece(leaf: torch.Tensor, dim: int | None, r: int, d: int, device,
           share: bool) -> torch.Tensor:
    """Shard ``r`` of ``d`` of ``leaf`` on ``device``: its contiguous piece
    along ``dim``, in memory of its own.  A replicated leaf is moved as it is
    when ``share`` holds (no copy where it already lies there, so shards on
    one device share it), else copied."""
    if dim is None:
        if share:
            return leaf.to(device)
        part = leaf
    else:
        part = leaf.chunk(d, dim=dim)[r]
    return torch.empty(part.shape, dtype=part.dtype, device=device).copy_(part)


def _shard(tree, dim_of, mesh, share: bool, path: tuple = ()) -> list:
    """One tree per shard of ``mesh``, in one walk over ``tree``'s leaves in
    order.  A leaf given as a function of no arguments is made when its
    turn comes and dropped once it is cut (a sharded init draws leaf by
    leaf, never holding the whole tree on one device)."""
    if isinstance(tree, dict):
        parts = {k: _shard(v, dim_of, mesh, share, path + (k,)) for k, v in tree.items()}
        return [{k: p[r] for k, p in parts.items()} for r in range(mesh.degree)]
    leaf = tree() if callable(tree) else tree
    dim = dim_of(path, leaf.dim())
    return [_piece(leaf, dim, r, mesh.degree, dev, share) for r, dev in enumerate(mesh.devices)]


class ShardedParams(list):
    """Weights already cut for a mesh: one params tree per shard, in shard
    order (shard ``r`` on ``mesh.devices[r]``), and the ``split`` they were
    cut by.  ``RolloutWorker`` adopts them as they are, where a bare tree
    is cut for its mesh."""

    def __init__(self, shards, split: "TPSplit"):
        super().__init__(shards)
        self.split = split


def _gather(shards: list, dim_of, device=None):
    """The inverse of ``_shard``: cut leaves concatenated, replicated ones
    taken from shard 0, on ``device`` (default: shard 0's device)."""
    def walk(path, parts):
        dim = dim_of(path, parts[0].dim())
        dev = parts[0].device if device is None else device
        if dim is None:
            return parts[0].to(dev)
        return torch.cat([p.to(dev) for p in parts], dim=dim)

    return _zip_walk(walk, shards)


def _zip_walk(fn, trees: list, path: tuple = ()):
    if isinstance(trees[0], dict):
        return {k: _zip_walk(fn, [t[k] for t in trees], path + (k,)) for k in trees[0]}
    return fn(path, trees)


def _param_dims(split: TPSplit):
    return lambda path, ndim: split.param_dim(_name(path), ndim)


def _cache_dims(split: TPSplit):
    return lambda path, ndim: split.cache_dim(_name(path), ndim, mixer_of(path))


def shard_params(params, split: TPSplit, mesh) -> ShardedParams:
    """One params tree per shard of ``mesh`` (shard ``r`` on ``mesh.devices[r]``);
    shards on one device share the replicated leaves.  A leaf may be a
    function that makes it (see ``_shard``)."""
    return ShardedParams(_shard(params, _param_dims(split), mesh, share=True), split)


def gather_params(shards: list, split: TPSplit, device=None):
    """The full params tree back from its shards (``shard_params``'s inverse)."""
    return _gather(shards, _param_dims(split), device)


def shard_cache(cache, split: TPSplit, mesh) -> list:
    """One cache, lane, pool, page stack or lane state per shard: K/V leaves
    cut on their kv-head dim when attention is cut, a Mamba layer's ``h``
    and ``conv`` on ``d_inner`` when Mamba is, an xLSTM layer's state on its
    heads when the xLSTM is; ``pos``, page tables and uncut leaves
    replicated, each shard's in memory of its own, since the model updates
    caches in place."""
    return _shard(cache, _cache_dims(split), mesh, share=False)


def gather_cache(shards: list, split: TPSplit, device=None):
    """The full cache back from its shards (``shard_cache``'s inverse)."""
    return _gather(shards, _cache_dims(split), device)
