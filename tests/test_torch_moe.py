"""The port's MoE layer against the JAX package's.

``jamba_v0_1_52b.reduced(n_periods=1)`` (float32, d 256, 4 experts top-2,
expert width 128) with the JAX ``init_params`` pytree carried across by
``from_jax``; inputs drawn with numpy.  One dispatch group (the JAX package
takes one without a mesh).  Outputs are held at 2e-5 (float32, sums in
another order) and the aux loss at 1e-6.  Tokens drop at a capacity factor of
0.5 (and, with these random routers, some at the default 1.25 too), and the
dropped set must be the reference's: a token kept by one package and
dropped by the other would move its output by O(1).
"""

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
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.params import from_jax


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("jamba_v0_1_52b").reduced(n_periods=1)
    cfg = get_config("jamba_v0_1_52b").reduced(n_periods=1)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    key = "01_mamba+moe"
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"][key]["mlp"])        # period 0
    p = {n: t[0] for n, t in params["blocks"][key]["mlp"].items()}
    return jcfg, cfg, jp, p


def _dropped(cfg, p, x):
    """Count of (token, choice) pairs past their expert's capacity."""
    T = x.shape[0] * x.shape[1]
    E, K = cfg.n_experts, cfg.top_k
    cap = max(1, int(np.ceil(T * K / E * cfg.capacity_factor)))
    gates = torch.softmax(x.reshape(T, -1) @ p["router"], dim=-1)
    counts = torch.bincount(torch.topk(gates, K).indices.reshape(-1), minlength=E)
    return int(torch.clamp(counts - cap, min=0).sum())


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["default", "dropping"])
@pytest.mark.parametrize("shape", [(2, 13), (8, 1)], ids=["prefill", "decode"])
def test_moe_matches_jax(setup, capacity_factor, shape):
    jcfg, cfg, jp, p = setup
    jcfg, cfg = (replace(c, capacity_factor=capacity_factor) for c in (jcfg, cfg))
    x = np.random.default_rng(7).standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    out, aux = L.moe(p, torch.tensor(x), cfg)
    jout, jaux = JL.moe(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5, rtol=0)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)
    if capacity_factor < 1:                             # the dropping case drops
        assert _dropped(cfg, p, torch.tensor(x)) > 0


def test_router_and_experts_carry_over_unchanged(setup):
    """``from_jax`` keeps the router, A_log and D in f32 and the expert stacks
    as they are, in a bf16 pytree too."""
    jcfg = jax_config("jamba_v0_1_52b").reduced(n_periods=1, dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(1)))
    params = from_jax(jparams, device="cpu")
    for key, c in jparams["blocks"].items():
        for part, leaves in c.items():
            for name, leaf in leaves.items():
                t = params["blocks"][key][part][name]
                want = (torch.float32 if name in ("router", "m_Alog", "m_D")
                        else torch.bfloat16)
                assert t.dtype == want and tuple(t.shape) == leaf.shape, (key, name)
                np.testing.assert_array_equal(t.float().numpy(), leaf.astype(np.float32))
    shapes = {f"{k}/{part}/{n}": (tuple(t.shape), t.dtype)
              for k, c in M.init_params(get_config("jamba_v0_1_52b").reduced(
                  n_periods=1, dtype="bfloat16"), device="cpu")["blocks"].items()
              for part, leaves in c.items() for n, t in leaves.items()}
    assert shapes == {f"{k}/{part}/{n}": (tuple(t.shape), t.dtype)
                      for k, c in params["blocks"].items()
                      for part, leaves in c.items() for n, t in leaves.items()}


def test_forward_full_aux_loss_matches(setup):
    """The model sums every MoE layer's aux loss; non-zero for jamba."""
    jcfg, cfg, _, _ = setup
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 9))
    jlogits, jaux = JM.forward_full(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    logits, aux = M.forward_full(cfg, params, {"tokens": torch.tensor(toks)})
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5, rtol=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
