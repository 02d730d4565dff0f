"""The tensor-parallel Mamba, MoE and whole-prompt admission splits, every
shard on the CPU, against the JAX package.

``jamba_v0_1_52b.reduced(n_periods=1)`` (f32; d 256, di 512, N 16, 4 heads
and 4 kv heads, 4 experts top-2, d_ff 512, vocab 512: every group cut at
degree 2 and 4), ``qwen2_moe_a2_7b`` reduced (4 experts, the gated shared
experts of width 128) and ``arctic_480b`` reduced (4 experts, the dense
residual of width 128), with the JAX ``init_params`` pytree carried across
by ``from_jax`` and inputs drawn with numpy:

  * the Mamba mixer's full and step forms on 2 and 4 shards: the shards'
    partial outputs summed, and their states gathered on ``d_inner``,
    against JAX ``mamba_full`` / ``mamba_step`` and the JAX state from a
    full forward; each shard's scan runs on its own di/d channels;
  * ``moe`` on 2, 4 (and 8) shards at capacity factors 1.25 and 0.5 (drops):
    the shards' partials summed against JAX ``moe``, and the aux loss, which
    every shard computes over all experts; with the experts cut and the
    dense residual replicated, and the other way round;
  * ``forward_full(mesh=)``, the sharded worker's whole-prompt admission:
    logits and the lane (gathered) against JAX ``forward_full``, a
    sliding-window ring that wraps among them;
  * chunked prefill of a chunkable Mamba stack (jamba's first four kinds,
    every MoE a dense MLP) on a mesh, each chunk's tokens stepped through
    the split Mamba step, into a dense lane and a paged lane's state row,
    then a decode step, against JAX ``prefill_chunk[_paged]``.

Tolerances: 2e-5 for a layer's output and state (``tests/test_torch_mamba.py``
and ``tests/test_torch_moe.py``'s, f32 sums in another order; the shards'
partials add one more reordering, of a few f32 ulps at these magnitudes),
1e-6 for the aux loss, and ``LOGIT_TOL`` (5e-6, ``tests/test_torch_tp.py``'s)
for logits of magnitude up to ~4, whose f32 ulp is 4.8e-7.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (gather_cache, shard_cache, shard_config,
                                              shard_params, tp_split)
from repro_torch.kernels import mamba_scan as scan_kernel
from repro_torch.launch.mesh import WorkerMesh
from repro_torch.models import model as M
from repro_torch.params import from_jax

from _torch_parity import jax_and_port, one_torch_thread, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 2e-5
LOGIT_TOL = 5e-6
MAMBA_KEY = "00_mamba+mlp"
MODELS = {"jamba": ("jamba_v0_1_52b", {}), "qwen2_moe": ("qwen2_moe_a2_7b", {}),
          "arctic": ("arctic_480b", {}),
          # 130 is cut at 2 but not at 4, where the 4 experts still are
          "arctic-dr130": ("arctic_480b", dict(dense_residual_ff=130))}


def _mesh(d: int) -> WorkerMesh:
    return WorkerMesh((torch.device("cpu"),) * d)


@functools.cache
def _model(name):
    """(JAX config, port config, JAX params, port params) at one period, built once."""
    arch, kw = MODELS[name]
    return jax_and_port(arch, n_periods=1, **kw)


def _layer(tree, key):
    """Period 0 of one layer's subtree (either package's)."""
    if isinstance(tree, dict):
        return {k: _layer(v, key) for k, v in tree.items()}
    return tree[0]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol, rtol=0)


def _split(cfg, d):
    split = tp_split(cfg, d)
    return split, shard_config(cfg, split), _mesh(d)


@pytest.fixture
def scan_shapes(monkeypatch):
    """The (B, S, di) of every scan the model code runs."""
    calls = []
    plain = scan_kernel.mamba_scan

    def spy(dt, *args):
        calls.append(tuple(dt.shape))
        return plain(dt, *args)

    monkeypatch.setattr(scan_kernel, "mamba_scan", spy)
    return calls


# ---------------------------------------------------------------- Mamba

@pytest.mark.parametrize("S", [1, 19])
@pytest.mark.parametrize("d", [2, 4])
def test_mamba_full_on_shards_matches_jax(d, S, scan_shapes):
    jcfg, cfg, jparams, params = _model("jamba")
    split, scfg, mesh = _split(cfg, d)
    assert split.ssm and scfg.d_inner == cfg.d_inner // d
    ps = shard_params(_layer(params["blocks"][MAMBA_KEY], 0), split, mesh)
    jp = _layer(jparams["blocks"][MAMBA_KEY], 0)["mixer"]
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    lanes = [{"h": torch.zeros((2, scfg.d_inner, cfg.ssm_state_dim)),
              "conv": torch.zeros((2, cfg.ssm_conv_width - 1, scfg.d_inner))} for _ in ps]
    outs = M._tp_mamba_full(scfg, split, mesh, ps, mesh.broadcast(torch.tensor(x)), lanes)
    assert scan_shapes == [(2, S, cfg.d_inner // d)] * d      # each shard's channels
    _close(mesh.reduce(outs)[0], JL.mamba_full(jp, jnp.asarray(x), jcfg))
    state = gather_cache([{"blocks": {MAMBA_KEY: lane}} for lane in lanes], split)
    want = JM._mamba_state_from_full(jcfg, jp, jnp.asarray(x))
    for name in ("h", "conv"):
        _close(state["blocks"][MAMBA_KEY][name], want[name])


@pytest.mark.parametrize("d", [2, 4])
def test_mamba_step_on_shards_matches_jax(d):
    jcfg, cfg, jparams, params = _model("jamba")
    split, scfg, mesh = _split(cfg, d)
    ps = shard_params(_layer(params["blocks"][MAMBA_KEY], 0), split, mesh)
    jp = _layer(jparams["blocks"][MAMBA_KEY], 0)["mixer"]
    rng = np.random.default_rng(5)
    di = cfg.d_inner
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    state = {"h": rng.standard_normal((3, di, cfg.ssm_state_dim)).astype(np.float32),
             "conv": rng.standard_normal((3, cfg.ssm_conv_width - 1, di)).astype(np.float32)}
    full = {"blocks": {MAMBA_KEY: {k: torch.tensor(v) for k, v in state.items()}}}
    states = [s["blocks"][MAMBA_KEY] for s in shard_cache(full, split, mesh)]
    assert all(s["h"].shape[1] == di // d and s["conv"].shape[2] == di // d for s in states)
    outs, news = M._tp_mamba_step(scfg, split, mesh, ps, mesh.broadcast(torch.tensor(x)),
                                  states)
    jout, jnew = JL.mamba_step(jp, jnp.asarray(x), jcfg,
                               {k: jnp.asarray(v) for k, v in state.items()})
    _close(mesh.reduce(outs)[0], jout)
    new = gather_cache([{"blocks": {MAMBA_KEY: n}} for n in news], split)["blocks"][MAMBA_KEY]
    for name in ("h", "conv"):
        _close(new[name], jnew[name])
        assert torch.equal(full["blocks"][MAMBA_KEY][name], torch.tensor(state[name]))


# ---------------------------------------------------------------- MoE

MOE_CASES = [("jamba", 2), ("jamba", 4), ("qwen2_moe", 2), ("qwen2_moe", 4),
             ("qwen2_moe", 8), ("arctic", 2), ("arctic", 4), ("arctic-dr130", 4)]


def _moe_key(cfg) -> str:
    return next(f"{i:02d}_{k}" for i, k in enumerate(cfg.block_pattern) if "+moe" in k)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["default", "dropping"])
@pytest.mark.parametrize("model,d", MOE_CASES, ids=[f"{m}-d{d}" for m, d in MOE_CASES])
def test_moe_on_shards_matches_jax(model, d, capacity_factor):
    """The shards' partials sum to the JAX layer's output; every shard's
    aux loss is the JAX one (routing over all experts on every shard)."""
    jcfg, cfg, jparams, params = _model(model)
    jcfg, cfg = (replace(c, capacity_factor=capacity_factor) for c in (jcfg, cfg))
    split, scfg, mesh = _split(cfg, d)
    assert scfg.n_experts == cfg.n_experts
    key = _moe_key(cfg)
    ps = shard_params(_layer(params["blocks"][key], 0), split, mesh)
    jp = _layer(jparams["blocks"][key], 0)["mlp"]
    x = np.random.default_rng(7).standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    pairs = [M._tp_moe(scfg, split, r, p["mlp"], torch.tensor(x)) for r, p in enumerate(ps)]
    outs = [o for o, _ in pairs]
    got = mesh.reduce(outs)[0] if split.any_moe() else outs[0]
    jout, jaux = JL.moe(jp, jnp.asarray(x), jcfg)
    _close(got, jout)
    for _, aux in pairs:
        np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)
    cut = {"jamba": (True, False), "qwen2_moe": (d < 8, True), "arctic": (True, True),
           "arctic-dr130": (True, False)}[model]
    assert (split.experts, split.moe_ff) == cut
    if split.experts:
        assert ps[0]["mlp"]["we_in"].shape[0] == cfg.n_experts // d


# ---------------------------------------------------------------- admission

FULL_CASES = [("jamba", 2, 0), ("jamba", 4, 0), ("qwen2_moe", 2, 0), ("qwen3-window", 2, 16)]


@pytest.mark.parametrize("model,d,window", FULL_CASES,
                         ids=[f"{m}-d{d}" for m, d, _ in FULL_CASES])
def test_forward_full_on_mesh_matches_jax(model, d, window, scan_shapes):
    """Logits and every lane leaf of a whole-prompt admission on a mesh
    against the JAX forward; a 20-token prompt into a 16-slot ring wraps."""
    if model == "qwen3-window":
        jcfg, cfg, jparams, params = jax_and_port("qwen3_1_7b", n_periods=2)
        jcfg, cfg = jcfg.with_sliding_window(window), cfg.with_sliding_window(window)
    else:
        jcfg, cfg, jparams, params = _model(model)
    capacity = window or 32
    split = tp_split(cfg, d)
    mesh = _mesh(d)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (1, 20))
    logits, aux, lanes = M.forward_full(cfg, shard_params(params, split, mesh),
                                        {"tokens": torch.tensor(tokens)}, capacity=capacity,
                                        mesh=mesh)
    jlogits, jaux, jcache = JM.forward_full(jcfg, jparams, {"tokens": jnp.asarray(tokens)},
                                            capacity=capacity)
    assert len(lanes) == d and logits.shape == (1, 20, cfg.vocab)
    _close(logits, jlogits, LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)
    lane = gather_cache(lanes, split)
    assert np.array_equal(lane["pos"].numpy(), np.asarray(jcache["pos"]))
    for key, c in jcache["blocks"].items():
        for name, want in c.items():
            _close(lane["blocks"][key][name], want)
    n_mamba = sum(k.startswith("mamba") for k in cfg.block_pattern)
    assert scan_shapes == [(1, 20, cfg.d_inner // d)] * (d * n_mamba)


def test_forward_full_on_mesh_refuses_training():
    _, cfg, _, params = _model("jamba")
    split, _, mesh = _split(cfg, 2)
    with pytest.raises(ValueError, match="MP degree 1"):
        M.forward_full(cfg, shard_params(params, split, mesh),
                       {"tokens": torch.zeros((1, 4), dtype=torch.long)}, remat=True, mesh=mesh)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_recurrent_chunk_prefill_on_mesh_matches_jax(paged, d):
    """``tests/test_torch_mamba.py``'s chunkable Mamba stack, its chunks
    (padding rows included) prefilled on a mesh of d shards, then a decode
    step: the logits and the gathered lane or pool against the JAX ones."""
    kinds = tuple(k.replace("+moe", "+mlp") for k in
                  get_config("jamba_v0_1_52b").block_pattern[:4])
    jcfg = replace(jax_config("jamba_v0_1_52b").reduced(n_periods=1), block_pattern=kinds)
    cfg = replace(get_config("jamba_v0_1_52b").reduced(n_periods=1), block_pattern=kinds)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(2))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    split, _, mesh = _split(cfg, d)
    ps = shard_params(params, split, mesh)
    chunks = [(np.arange(8) + 3, 8), (np.array([40, 41, 42, 0, 0, 0, 0, 0]), 3)]
    if paged:
        row = np.asarray([2, 4, 0, 0], np.int32)
        jpool = JM.paged_set_lane(JM.init_paged_pool(jcfg, None, 2, 5, 8, 4), 1,
                                  jnp.asarray(row), 0)
        pools = shard_cache(M.paged_set_lane(M.init_paged_pool(cfg, 2, 5, 8, 4, "cpu"), 1,
                                             row, 0), split, mesh)
        for toks, n in chunks:
            jpool = JM.prefill_chunk_paged(jcfg, jparams, jpool, 1,
                                           jnp.asarray(toks[None], jnp.int32), n)
            M.prefill_chunk_paged(cfg, ps, pools, 1, torch.tensor(toks[None]), n, mesh=mesh)
        tok = np.array([[7], [11]])
    else:
        jpool = JM.init_cache(jcfg, None, 1, 16)
        pools = shard_cache(M.init_cache(cfg, 1, 16, "cpu"), split, mesh)
        for toks, n in chunks:
            jpool = JM.prefill_chunk(jcfg, jparams, jpool, jnp.asarray(toks[None], jnp.int32), n)
            M.prefill_chunk(cfg, ps, pools, torch.tensor(toks[None]), n, mesh=mesh)
        tok = np.array([[11]])
    jlogits, jpool = JM.decode_step(jcfg, jparams, jpool, jnp.asarray(tok, jnp.int32))
    logits, _ = M.decode_step(cfg, ps, pools, torch.tensor(tok), mesh=mesh)
    _close(logits, jlogits, 1e-4)                      # test_torch_mamba.py's logit tolerance
    pool = gather_cache(pools, split)
    np.testing.assert_array_equal(pool["pos"].numpy(), np.asarray(jpool["pos"]))
    for key, c in jpool["blocks"].items():
        for name, leaf in c.items():
            got, want = pool["blocks"][key][name], np.asarray(leaf)
            if paged and name in ("k", "v"):                   # scratch block 0 aside
                got, want = got[:, 1:], want[:, 1:]
            _close(got, want)
