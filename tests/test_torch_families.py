"""The language-model families beyond qwen3 and jamba, layer by layer and as
whole models, against the JAX package.

Configs at ``reduced()`` sizes (d 256, 4 experts top-2, shared and residual
widths 128, 2 periods of a one-kind pattern or 1 of a longer one), params
from the JAX ``init_params`` carried across by ``from_jax``, inputs drawn
with numpy.  Tolerances: float32 outputs and states 1e-5 absolute (sums in
another order; mLSTM states 2e-5, the chunk carry against the sequential
recurrence), logits 1e-4; bfloat16 outputs 2% of the reference's largest
|value| (one or two bf16 ulps of the largest: the two packages round q, k, v
and the expert products to bf16 after sums in another order), bf16 states 1%
of it.

* ``moe`` with qwen2-moe's sigmoid-gated shared experts and with arctic's
  dense residual, at capacity factors 1.25, 0.5 and no-drop (``E / top_k +
  1``), f32 and bf16: output and aux loss;
* the xLSTM layers (``mlstm_full`` over two chunks, one of them padded,
  ``mlstm_step``, ``slstm_full``, ``slstm_step``) and both state extractors;
  the port's ``mlstm_full`` also against its own step recurrence;
* ``forward_full`` logits and aux loss, and ``decode_step`` logits and cache
  after a full-forward admission, for nemotron (``relu2``), phi3, qwen3-8b,
  qwen2-moe, arctic and xLSTM;
* ``check_ported`` and ``get_config`` over the JAX package's registry (the
  audio and VLM configs' model path is ``test_torch_encoders.py``).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES as JAX_ARCHITECTURES
from repro.configs import get_config as jax_config
from repro.configs import qwen3_paper
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import ARCHITECTURES, PAPER_CONFIGS, get_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.params import from_jax

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = {"float32": 1e-5, "bfloat16": None}   # bf16: relative, see the module docstring
BF16_REL, BF16_STATE_REL = 2e-2, 1e-2
LOGIT_TOL = 1e-4
FAMILIES = ["nemotron_4_15b", "phi3_medium_14b", "qwen3-8b", "qwen2_moe_a2_7b", "arctic_480b",
            "xlstm_350m"]


def _configs(name, **kw):
    """(JAX config, port config), reduced as the JAX package's runtime tests do."""
    jfull = (getattr(qwen3_paper, PAPER_CONFIGS[name]) if name in PAPER_CONFIGS
             else jax_config(name))
    periods = 2 if len(jfull.block_pattern) == 1 else 1
    jcfg = jfull.reduced(n_periods=periods, **kw)
    cfg = get_config(name).reduced(n_periods=periods, **kw)
    assert vars(jcfg).keys() >= vars(cfg).keys()
    assert all(getattr(jcfg, k) == v for k, v in vars(cfg).items()), name
    return jcfg, cfg


_PARAMS = {}


def _models(name, dtype="float32"):
    if (name, dtype) not in _PARAMS:
        jcfg, cfg = _configs(name, dtype=dtype)
        jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
        _PARAMS[name, dtype] = (jcfg, cfg, jparams,
                                from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    return _PARAMS[name, dtype]


def _layer(jparams, params, key, part):
    """Period 0 of one layer's ``part`` in both packages."""
    return (jax.tree.map(lambda x: x[0], jparams["blocks"][key][part]),
            {n: t[0] for n, t in params["blocks"][key][part].items()})


def _inputs(shape, dtype):
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.tensor(x).to(getattr(torch, dtype))


def _close(got, want, dtype, rel=BF16_REL, tol=None, label=""):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    limit = tol or TOL[dtype] or rel * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=limit, rtol=0, err_msg=label)


# ---------------------------------------------------------------- MoE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", ["1.25", "0.5", "no-drop"])
@pytest.mark.parametrize("name", ["qwen2_moe_a2_7b", "arctic_480b"])
def test_moe_extras_match_jax(name, capacity, dtype):
    """Shared experts (qwen2-moe) and the dense residual (arctic): output and
    aux loss.  The extra path must bite: without it the output moves by more
    than the tolerance."""
    jcfg, cfg, jparams, params = _models(name, dtype)
    assert cfg.shared_d_ff or cfg.dense_residual_ff
    cf = cfg.n_experts / cfg.top_k + 1 if capacity == "no-drop" else float(capacity)
    jcfg, cfg = (replace(c, capacity_factor=cf) for c in (jcfg, cfg))
    key = next(iter(params["blocks"]))
    jp, p = _layer(jparams, params, key, "mlp")
    jx, x = _inputs((2, 13, cfg.d_model), dtype)
    out, aux = L.moe(p, x, cfg)
    jout, jaux = JL.moe(jp, jx, jcfg)
    assert out.dtype == x.dtype and aux.dtype == torch.float32
    _close(out, jout, dtype, label=f"{name} {capacity} {dtype}")
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)
    plain = replace(cfg, shared_d_ff=0, dense_residual_ff=0)
    moved = float((L.moe(p, x, plain)[0].float() - out.float()).abs().max())
    assert moved > 10 * float(np.abs(np.asarray(jout.astype(jnp.float32))).max()) * 1e-3


def test_moe_extra_leaves_match_jax_init():
    """``init_params`` draws the shared-expert and dense-residual leaves with
    the JAX package's names, shapes and dtypes; the scales match within the
    draw's sampling error."""
    for name in ("qwen2_moe_a2_7b", "arctic_480b"):
        jcfg, cfg = _configs(name, dtype="bfloat16")
        jparams = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
        params = M.init_params(cfg, seed=0, device="cpu")
        for key, c in jparams["blocks"].items():
            for part, leaves in c.items():
                for leaf_name, leaf in leaves.items():
                    t = params["blocks"][key][part][leaf_name]
                    assert tuple(t.shape) == leaf.shape, (name, key, leaf_name)
                    assert str(t.dtype).removeprefix("torch.") == leaf.dtype.name
                    if leaf_name[:2] in ("ws", "wd") or leaf_name == "shared_gate":
                        std = float(t.float().std())
                        np.testing.assert_allclose(std, float(leaf.astype(np.float32).std()),
                                                   rtol=0.1)


# ---------------------------------------------------------------- xLSTM


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def xlstm(request):
    dtype = request.param
    jcfg, cfg, jparams, params = _models("xlstm_350m", dtype)
    # S 300: two chunks of MLSTM_CHUNK (256), the second padded
    jx, x = _inputs((2, 300, cfg.d_model), dtype)
    return dtype, jcfg, cfg, jparams, params, jx, x


def test_mlstm_full_and_state_match_jax(xlstm):
    dtype, jcfg, cfg, jparams, params, jx, x = xlstm
    jp, p = _layer(jparams, params, "00_mlstm", "mixer")
    out, carry = L.mlstm_full(p, x, cfg)
    _close(out, JL.mlstm_full(jp, jx, jcfg), dtype, label="mlstm_full")
    jstate = JM._mlstm_state_from_full(jcfg, jp, jx)          # the sequential recurrence
    for name in ("C", "n", "m"):                              # the port's state: the carry
        assert carry[name].dtype == torch.float32
        _close(carry[name], jstate[name], dtype, rel=BF16_STATE_REL, label=name,
               tol=2e-5 if dtype == "float32" else None)


def test_mlstm_full_equals_its_step_recurrence(xlstm):
    """The port's chunked form against its own one-token steps (the shape of
    tests/test_models.py::test_mlstm_chunked_equals_sequential): outputs
    and the carry, every step in f32 state."""
    dtype, jcfg, cfg, jparams, params, jx, x = xlstm
    _, p = _layer(jparams, params, "00_mlstm", "mixer")
    x = x[:1, :270]
    out, carry = L.mlstm_full(p, x, cfg)
    hd = cfg.xlstm_expand * cfg.d_model // cfg.n_heads
    st = L.fresh_mlstm_state(1, cfg.n_heads, hd, "cpu")
    outs = []
    for t in range(x.shape[1]):
        o, st = L.mlstm_step(p, x[:, t:t + 1], cfg, st)
        outs.append(o)
    steps = torch.cat(outs, dim=1)
    limit = 1e-5 if dtype == "float32" else BF16_REL * float(steps.float().abs().max())
    torch.testing.assert_close(out.float(), steps.float(), rtol=0, atol=limit)
    for name in ("C", "n", "m"):
        torch.testing.assert_close(carry[name], st[name], rtol=0,
                                   atol=2e-5 * max(1.0, float(st[name].abs().max())))


def test_mlstm_step_matches_jax(xlstm):
    dtype, jcfg, cfg, jparams, params, jx, x = xlstm
    jp, p = _layer(jparams, params, "00_mlstm", "mixer")
    jstate = JM._mlstm_state_from_full(jcfg, jp, jx[:, :20])
    state = {n: torch.from_numpy(np.array(v)) for n, v in jstate.items()}
    out, new = L.mlstm_step(p, x[:, 20:21], cfg, state)
    jout, jnew = JL.mlstm_step(jp, jx[:, 20:21], jcfg, jstate)
    _close(out, jout, dtype, label="mlstm_step")
    for name in ("C", "n", "m"):
        _close(new[name], jnew[name], dtype, rel=BF16_STATE_REL, label=name)


def test_slstm_full_step_and_state_match_jax(xlstm):
    dtype, jcfg, cfg, jparams, params, jx, x = xlstm
    jp, p = _layer(jparams, params, "05_slstm", "mixer")
    x, jx = x[:, :40], jx[:, :40]
    out, last = L.slstm_full(p, x, cfg)
    _close(out, JL.slstm_full(jp, jx, jcfg), dtype, label="slstm_full")
    jstate = JM._slstm_state_from_full(jcfg, jp, jx)
    for name in ("h", "c", "n", "m"):                         # the port's state: the last
        _close(last[name], jstate[name], dtype, rel=BF16_STATE_REL, label=name)
    step_out, new = L.slstm_step(p, x[:, -1:], cfg, last)
    jstep_out, jnew = JL.slstm_step(jp, jx[:, -1:], jcfg, jstate)
    _close(step_out, jstep_out, dtype, label="slstm_step")
    for name in ("h", "c", "n", "m"):
        _close(new[name], jnew[name], dtype, rel=BF16_STATE_REL, label=name)


def test_xlstm_init_matches_jax():
    """``init_params`` keeps the JAX package's xLSTM leaves: names, shapes,
    dtypes, l_fg's +1 bias, l_skip at ones and s_b at zeros."""
    jcfg, cfg = _configs("xlstm_350m", dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    params = M.init_params(cfg, seed=0, device="cpu")
    for key, c in jparams["blocks"].items():
        for leaf_name, leaf in c["mixer"].items():
            t = params["blocks"][key]["mixer"][leaf_name]
            assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16, leaf_name
            ref = leaf.astype(np.float32)
            np.testing.assert_allclose(float(t.float().mean()), float(ref.mean()), atol=0.01)
        for leaf_name in ("l_skip", "s_b"):
            if leaf_name in c["mixer"]:
                np.testing.assert_array_equal(
                    params["blocks"][key]["mixer"][leaf_name].float().numpy(),
                    c["mixer"][leaf_name].astype(np.float32))


# ---------------------------------------------------------------- whole models


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_and_decode_match_jax(name):
    """Full-forward logits and aux loss, then a full-forward admission with a
    cache and three decode steps (two lanes, teacher-forced with the JAX
    argmax): logits and every cache leaf."""
    jcfg, cfg, jparams, params = _models(name)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 11))
    jlogits, jaux = JM.forward_full(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    logits, aux = M.forward_full(cfg, params, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5, rtol=0)
    assert (float(aux) > 0) == bool(cfg.n_experts)

    _, _, jcache = JM.forward_full(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                                   capacity=16)
    _, _, cache = M.forward_full(cfg, params, {"tokens": torch.tensor(toks)}, capacity=16)
    tok = np.asarray([[1], [2]], np.int32)
    for _ in range(3):
        jl, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(tok))
        lg, cache = M.decode_step(cfg, params, cache, torch.tensor(tok))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
        tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    for key, c in jcache["blocks"].items():
        for leaf_name, leaf in c.items():
            np.testing.assert_allclose(cache["blocks"][key][leaf_name].numpy(), np.asarray(leaf),
                                       atol=2e-5, rtol=0, err_msg=f"{name} {key}/{leaf_name}")


def test_state_leaves_match_jax_init_cache():
    """Every recurrent leaf of a fresh cache has the JAX package's shape,
    dtype and value (``m`` at -1e30, the rest 0), on both planes, and a
    paged pool grown by lanes gives its new lanes the same fresh state."""
    jcfg, cfg, _, _ = _models("xlstm_350m")
    jcache = JM.init_cache(jcfg, None, 3, 0)
    cache = M.init_cache(cfg, 3, 0, "cpu")
    pool = M.init_paged_pool(cfg, 1, 2, 8, 2, "cpu")
    M.grow_paged_lanes(cfg, pool, 2)
    for key, c in jcache["blocks"].items():
        for leaf_name, leaf in c.items():
            for got in (cache["blocks"][key][leaf_name], pool["blocks"][key][leaf_name]):
                assert got.dtype == torch.float32 and tuple(got.shape) == leaf.shape
                np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))


# ---------------------------------------------------------------- registry


def test_every_decoder_config_is_ported():
    """``check_ported`` accepts every config of the JAX package, the audio
    and vision-language ones too, and the paper's three Qwen3 configs;
    ``get_config`` knows every one by module name and by alias, with the
    reference's fields."""
    for name in JAX_ARCHITECTURES:
        jcfg = jax_config(name)
        M.check_ported(jcfg)
        cfg = get_config(name)
        assert cfg == get_config(jcfg.name) and cfg.name == jcfg.name
        assert all(getattr(jcfg, k) == v for k, v in vars(cfg).items()), name
        M.check_ported(cfg)
    assert set(ARCHITECTURES) == set(JAX_ARCHITECTURES)
    for name, attr in PAPER_CONFIGS.items():
        jcfg = getattr(qwen3_paper, attr)
        assert get_config(name).name == jcfg.name == name
        M.check_ported(get_config(name))
    with pytest.raises(KeyError):
        get_config("no-such-model")
