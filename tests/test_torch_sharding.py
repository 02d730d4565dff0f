"""The port's sharding rules (``repro_torch.distributed.sharding``) and worker
meshes (``repro_torch.launch.mesh``) against the JAX package's.

The JAX rules engine reads only a mesh's ``axis_names`` and ``devices.shape``
(``repro/distributed/sharding.py::_mesh_axis_sizes``), so it is called
unchanged with a stand-in that carries those two; the port's functions take
the same axis sizes as a dict.  Every config of the registry, reduced to one
period, is checked at model-axis sizes 1, 2, 4 and 8: its params, its dense
cache and (where the config pages) its paged pool, leaf by leaf, specs equal.
Then the executed split: ``gather(shard(x)) == x`` exactly for every param
and cache leaf of every config, and the shard config and carve.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.distributed import sharding as JS
from repro.launch.mesh import carve_worker_meshes as jax_carve
from repro.models import model as JM
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import WorkerMesh, carve_worker_meshes
from repro_torch.models import model as M

from _torch_parity import tree_paths

SIZES = (1, 2, 4, 8)
CPU = torch.device("cpu")


def _mesh(axes: dict[str, int]):
    """A stand-in for a jax Mesh: the two attributes the rules engine reads."""
    return SimpleNamespace(axis_names=tuple(axes), devices=np.empty(tuple(axes.values())))


def _jax_specs(tree) -> dict:
    return {k: tuple(v) for k, v in tree_paths(tree).items()}


def _enc_len(cfg):
    return cfg.encoder_seq or cfg.image_seq or None


@pytest.fixture(scope="module", params=ARCHITECTURES)
def trees(request):
    """(port config, port params on the CPU, {name: (JAX tree of shapes,
    port tree)} for the params, the dense cache and the paged pool)."""
    name = request.param
    jcfg, cfg = jax_config(name).reduced(n_periods=1), get_config(name).reduced(n_periods=1)
    params = M.init_params(cfg, seed=0, device="cpu")
    T = _enc_len(cfg)
    enc = None if T is None else jnp.zeros((2, T, jcfg.d_model), jnp.dtype(jcfg.dtype))
    out = {"params": (jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0))),
                      params),
           "cache": (jax.eval_shape(lambda: JM.init_cache(jcfg, None, 2, 16, enc_out=enc)),
                     M.init_cache(cfg, 2, 16, "meta", enc_len=T))}
    if M.supports_paged_kv(cfg):
        out["pool"] = (jax.eval_shape(lambda: JM.init_paged_pool(jcfg, None, 2, 9, 4, 4)),
                       M.init_paged_pool(cfg, 2, 9, 4, 4, "meta"))
    return cfg, params, out


@pytest.mark.parametrize("model", SIZES)
def test_pspecs_match_jax(trees, model):
    _, _, out = trees
    sizes = {"data": 1, "model": model}
    for kind, (jtree, tree) in out.items():
        jshapes = {k: tuple(v.shape) for k, v in tree_paths(jtree).items()}
        assert {k: tuple(v.shape) for k, v in tree_paths(tree).items()} == jshapes, kind
        if kind == "params":
            want, got = JS.param_pspecs(jtree, _mesh(sizes)), S.param_pspecs(tree, sizes)
        else:
            want, got = JS.cache_pspecs(jtree, _mesh(sizes)), S.cache_pspecs(tree, sizes)
        assert tree_paths(got) == _jax_specs(want), (kind, model)
    # without a mesh every dim is replicated, as the reference's
    assert all(all(a is None for a in spec)
               for spec in tree_paths(S.param_pspecs(out["params"][1])).values())


CASES = [((16, 8, 128), ("heads", "kv_heads", None)),        # an axis is used once
         ((9, 64), ("heads", "d_ff")),                         # 9 heads: the next dim takes it
         ((24, 6), ("batch", "heads")),
         ((512, 256), ("vocab", "fsdp")),
         ((4, 2048, 8, 128), ("batch", "kv_seq", "kv_heads", None)),
         ((3,), ("experts",)), ((7, 5), (None, "seq"))]


@pytest.mark.parametrize("axes", [{"data": 1, "model": 2}, {"data": 2, "model": 4},
                                  {"pod": 2, "data": 2, "model": 8},
                                  {"pod": 3, "data": 2, "model": 1}],
                         ids=lambda a: "x".join(map(str, a.values())))
def test_logical_pspec_matches_jax(axes):
    for shape, dims in CASES:
        want = tuple(JS.logical_pspec(shape, dims, _mesh(axes)))
        assert S.logical_pspec(shape, dims, axes) == want, (shape, dims)
    assert S.logical_pspec((4, 4), ("heads", None)) == (None, None)     # no mesh


@pytest.mark.parametrize("axes", [{"data": 1, "model": 4}, {"data": 4, "model": 2},
                                  {"pod": 2, "data": 2, "model": 2}],
                         ids=lambda a: "x".join(map(str, a.values())))
def test_dispatch_groups_match_jax(axes):
    with JS.axis_rules(_mesh(axes)):
        want = [JS.dispatch_groups(n) for n in (1, 2, 3, 6, 8, 12, 64)]
    assert [S.dispatch_groups(n, axes) for n in (1, 2, 3, 6, 8, 12, 64)] == want
    assert S.dispatch_groups(8) == 1


@pytest.mark.parametrize("degree", (2, 4, 8))
def test_shard_gather_round_trip(trees, degree):
    """``gather(shard(x)) == x`` bit for bit, every leaf; a cut leaf's pieces
    are 1/degree of it, in memory of their own."""
    cfg, params, out = trees
    split = S.tp_split(cfg, degree)
    mesh = WorkerMesh((CPU,) * degree)
    shards = S.shard_params(params, split, mesh)
    back = S.gather_params(shards, split)
    for path, leaf in tree_paths(params).items():
        got = tree_paths(back)[path]
        assert got.dtype == leaf.dtype and torch.equal(got, leaf), path
        dim = split.param_dim(path.rsplit("/", 1)[-1], leaf.dim())
        piece = tree_paths(shards[degree - 1])[path]
        if dim is not None:
            assert piece.shape[dim] * degree == leaf.shape[dim], path
            assert piece.untyped_storage().data_ptr() != leaf.untyped_storage().data_ptr()
        else:
            assert piece is leaf, path                    # replicated: shared, not copied
    cache = M.init_cache(cfg, 2, 16, "cpu", enc_len=_enc_len(cfg))
    for leaf in M.tree_leaves(cache):
        leaf.copy_(torch.randn(leaf.shape).to(leaf.dtype) if leaf.is_floating_point()
                   else torch.randint(0, 9, leaf.shape, dtype=leaf.dtype))
    cut = S.shard_cache(cache, split, mesh)
    back = S.gather_cache(cut, split)
    for path, leaf in tree_paths(cache).items():
        assert torch.equal(tree_paths(back)[path], leaf), path
        name, mixer = path.rsplit("/", 1)[-1], S.mixer_of(tuple(path.split("/")))
        dim = split.cache_dim(name, leaf.dim(), mixer)
        want = {"k": split.attn, "v": split.attn, "xk": split.attn, "xv": split.attn,
                "h": split.ssm if mixer == "mamba" else split.xlstm, "conv": split.ssm,
                **dict.fromkeys("Cncm", split.xlstm)}.get(name, False)
        assert (dim is not None) == want, path       # h: by its layer's group
        piece = tree_paths(cut[degree - 1])[path]
        if dim is not None:
            assert piece.shape[dim] * degree == leaf.shape[dim]
        # updated in place: no shard's leaf is another's or the source's
        ptrs = {tree_paths(c)[path].untyped_storage().data_ptr() for c in cut}
        assert len(ptrs) == degree and leaf.untyped_storage().data_ptr() not in ptrs, path


def test_tp_split_and_shard_config():
    qwen = get_config("qwen3_1_7b")                  # 16 / 8 heads, d_ff 6144, vocab 151,936
    for d in (2, 4, 8):
        split = S.tp_split(qwen, d)
        assert (split.attn, split.mlp, split.vocab) == (True, True, True)
        sc = S.shard_config(qwen, split)
        assert (sc.n_heads, sc.n_kv_heads, sc.hd, sc.d_ff, sc.vocab) == (
            16 // d, 8 // d, 128, 6144 // d, 151_936 // d)
        assert sc.q_groups == qwen.q_groups
    assert S.tp_split(qwen, 16).attn is False            # 8 kv heads do not divide by 16
    smol = get_config("smollm_135m").reduced(n_periods=1)   # 3 heads: attention replicated
    split = S.tp_split(smol, 2)
    assert (split.attn, split.mlp, split.vocab) == (False, True, True)
    assert S.shard_config(smol, split).n_heads == 3
    one = S.tp_split(qwen, 1)
    assert not (one.attn or one.mlp or one.vocab) and S.shard_config(qwen, one).hd == qwen.hd
    assert split.param_dim("wq", 4) is None and split.param_dim("w_in", 3) == 2
    assert split.param_dim("tok_embed", 2) == 0 and split.param_dim("wo", 4) is None
    assert S.tp_split(qwen, 2).param_dim("wo", 4) == 1
    assert S.tp_split(qwen, 2).cache_dim("k", 5) == 3 and split.cache_dim("k", 5) is None
    with pytest.raises(ValueError):
        S.tp_split(qwen, 0)


def test_tp_split_of_the_mixers_and_experts():
    """Mamba on d_inner, the experts on their count, the shared experts and
    dense residual on their width, each group only where it divides; a
    shard routes over every expert; the cache cut follows the layer."""
    jamba = get_config("jamba_v0_1_52b")              # di 8,192, 16 experts, d_ff 14,336
    for d in (2, 4, 8):
        split = S.tp_split(jamba, d)
        assert (split.ssm, split.experts, split.moe_ff) == (True, True, False)
        sc = S.shard_config(jamba, split)
        assert (sc.d_inner, sc.n_experts, sc.n_kv_heads) == (8192 // d, 16, 8 // d)
        assert split.any_moe()
    assert not S.tp_split(jamba, 3).ssm and not S.tp_split(jamba, 32).experts
    qwen2 = get_config("qwen2_moe_a2_7b")             # 60 experts, shared 5,632
    assert (S.tp_split(qwen2, 4).experts, S.tp_split(qwen2, 8).experts) == (True, False)
    split = S.tp_split(qwen2, 8)
    assert split.moe_ff and S.shard_config(qwen2, split).shared_d_ff == 704
    arctic = get_config("arctic_480b")                # 128 experts, dense residual 4,864
    sc = S.shard_config(arctic, S.tp_split(arctic, 4))
    assert (sc.dense_residual_ff, sc.n_experts) == (1216, 128)
    qwen = get_config("qwen3_1_7b")
    plain = S.tp_split(qwen, 2)
    assert not (plain.ssm or plain.experts or plain.moe_ff or plain.any_moe())
    assert S.shard_config(qwen, plain).d_inner == qwen.d_inner
    split = S.tp_split(jamba, 2)
    assert [split.param_dim(n, 3) for n in ("m_in", "m_xproj", "m_Alog", "m_out")] == [2, 1, 1, 1]
    assert split.param_dim("m_D", 2) == 1 and split.param_dim("we_in", 4) == 1
    assert split.param_dim("router", 3) is None and split.param_dim("shared_gate", 2) is None
    # the name h: Mamba's is cut on d_inner, sLSTM's (..., H, hd) on its heads
    # where the xLSTM is cut, which jamba has not
    assert split.cache_dim("h", 5, "mamba") == 3 and split.cache_dim("conv", 5, "mamba") == 4
    assert split.cache_dim("h", 5, "slstm") is None and split.cache_dim("h", 5) is None
    assert S.mixer_of(("blocks", "03_attn+moe", "k")) == "attn"
    assert S.mixer_of(("blocks", "00_mamba+mlp", "h")) == "mamba"
    assert S.mixer_of(("pos",)) == "" and S.mixer_of(("blocks", "h")) == ""
    xlstm = get_config("xlstm_350m")
    slstm = {"blocks": {"05_slstm": {"h": torch.zeros(1, 2, 4, 8)}}}
    cut = S.shard_cache(slstm, S.tp_split(xlstm, 2), WorkerMesh((CPU,) * 2))
    assert cut[0]["blocks"]["05_slstm"]["h"].shape == (1, 2, 2, 8)


def test_tp_split_of_the_xlstm():
    """The xLSTM on its heads where they divide: the mLSTM's up-projection
    columns and its products' ``d_inner`` rows, the sLSTM's heads and
    ``s_out``'s rows; every state leaf on its heads."""
    xlstm = get_config("xlstm_350m")                  # 4 heads, mLSTM width 2,048
    for d in (2, 4):
        split = S.tp_split(xlstm, d)
        assert split.xlstm and not (split.ssm or split.mlp or split.any_moe())
        sc = S.shard_config(xlstm, split)
        assert (sc.n_heads, sc.mlstm_inner, sc.slstm_inner) == (4 // d, 2048 // d, 1024 // d)
    assert not S.tp_split(xlstm, 8).xlstm and not S.tp_split(xlstm, 3).xlstm
    assert S.shard_config(xlstm, S.tp_split(xlstm, 8)).n_heads == 4
    split = S.tp_split(xlstm, 2)
    dims = {n: split.param_dim(n, nd + 1) for n, nd in
            (("l_up", 2), ("l_z", 2), ("l_skip", 1), ("l_q", 3), ("l_ig", 2), ("l_down", 2),
             ("s_w", 4), ("s_r", 4), ("s_b", 3), ("s_out", 2))}
    assert dims == {"l_up": 2, "l_z": 2, "l_skip": 1, "l_q": 1, "l_ig": 1, "l_down": 1,
                    "s_w": 3, "s_r": 2, "s_b": 2, "s_out": 1}
    assert [split.cache_dim(n, 5, "mlstm") for n in ("C", "n")] == [2, 3]
    assert split.cache_dim("m", 3, "mlstm") == 2
    assert [split.cache_dim(n, 4, "slstm") for n in "hcnm"] == [2] * 4
    assert S.tp_split(get_config("jamba_v0_1_52b"), 2).xlstm is False


def test_mesh_collectives():
    mesh = WorkerMesh((CPU,) * 3)
    assert mesh.degree == 3
    parts = [torch.full((2,), v, dtype=torch.bfloat16) for v in (1.0, 2.0 ** -8, 2.0 ** -8)]
    total = mesh.reduce(parts)
    assert len(total) == 3 and all(t.dtype == torch.bfloat16 for t in total)
    # added in f32 and rounded once: 1 + 2^-7 is a bf16 value; two bf16 adds
    # would round each 1 + 2^-8 back to 1
    assert float(total[0][0]) == 1.0 + 2.0 ** -7
    assert torch.equal(mesh.gather([torch.ones(2, 1), torch.zeros(2, 2)], -1),
                       torch.tensor([[1.0, 0, 0], [1.0, 0, 0]]))


def test_carve_matches_jax_contract():
    """The reference's contract: no mesh for an all-mp1 fleet or one the
    devices cannot cover; contiguous blocks in degree order otherwise, a
    one-device mesh for a degree-1 worker in a meshed fleet."""
    assert carve_worker_meshes([4, 2, 1, 1], ["cpu"]) == [None] * 4
    assert jax_carve([4, 2, 1, 1], jax.devices()[:1]) == [None] * 4
    assert carve_worker_meshes([1, 1], ["cpu"] * 4) == [None, None]
    assert jax_carve([1, 1], jax.devices()) == [None, None]
    meshes = carve_worker_meshes([4, 2, 1, 1], ["cpu"] * 8)
    assert [m.degree for m in meshes] == [4, 2, 1, 1]
    assert all(dev == CPU for m in meshes for dev in m.devices)
    assert [m.degree for m in carve_worker_meshes([2, 1], ["cpu"] * 5)] == [2, 1]


def test_carve_defaults_to_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        carve_worker_meshes([2, 1])
    with pytest.raises(RuntimeError, match="CUDA"):
        carve_worker_meshes([2, 1], ["cuda:0"] * 3)
