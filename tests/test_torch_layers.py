"""The port's layers against the JAX package's, on identical inputs and params.

Config: qwen3_1_7b.reduced(n_periods=2) (float32, d 256, hd 64).  Inputs are
drawn with numpy; params are the JAX ``init_params`` pytree carried across by
``repro_torch.params.from_jax``.  Tolerance: 2e-5 absolute -- float32 with
matrix products summed in another order (values are O(1)).
"""

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
from repro_torch.params import from_jax

ATOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("qwen3_1_7b").reduced(n_periods=2)
    cfg = get_config("qwen3_1_7b").reduced(n_periods=2)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"]["00_attn+mlp"])   # period 0
    p = {k: {n: t[0] for n, t in v.items()} for k, v in
         params["blocks"]["00_attn+mlp"].items()}
    return jcfg, cfg, jp, p


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)), atol=atol,
                               rtol=0)


def test_from_jax_keeps_names_shapes_and_bf16():
    jcfg = jax_config("qwen3_1_7b").reduced(n_periods=2, dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(1)))
    params = from_jax(jparams, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat_j:
        t = params
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(), leaf.astype(np.float32))


def test_rmsnorm_rope_mlp_match(setup):
    jcfg, cfg, jp, p = setup
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, cfg.d_model), np.float32)
    _close(L.rmsnorm(torch.tensor(x), p["norm1"]["scale"]),
           JL.rmsnorm(jnp.asarray(x), jp["norm1"]["scale"]))
    _close(L.mlp(p["mlp"], torch.tensor(x), cfg.activation),
           JL.mlp(jp["mlp"], jnp.asarray(x), jcfg.activation))
    h = rng.standard_normal((2, 5, cfg.n_heads, cfg.hd), np.float32)
    pos2 = np.asarray([[0, 3, 7, 1000, 65535], [9, 9, 9, 9, 9]], np.int32)
    for pos in (pos2, pos2[0]):                    # (B, S) and (S,) positions
        _close(L.rope(torch.tensor(h), torch.tensor(pos), cfg.rope_theta),
               JL.rope(jnp.asarray(h), jnp.asarray(pos), jcfg.rope_theta), atol=1e-4)


def _pools(cfg, rng, NB, ps):
    shape = (NB, ps, cfg.n_kv_heads, cfg.hd)
    return rng.standard_normal(shape, np.float32), rng.standard_normal(shape, np.float32)


def test_attention_decode_paged_matches_with_pools(setup):
    """Includes a lane past capacity (its write goes to scratch) and a free
    lane (unmapped row): out and the written pools match JAX."""
    jcfg, cfg, jp, p = setup
    rng = np.random.default_rng(1)
    B, ps, num_pages, NB = 4, 8, 4, 14
    k, v = _pools(cfg, rng, NB, ps)
    pt = np.zeros((B, num_pages), np.int32)
    pt[0, :2], pt[1, :4], pt[2, :1] = [3, 5], [1, 2, 4, 6], [7]
    pos = np.asarray([11, 32, 0, 0], np.int32)     # lane 1 at capacity, lane 3 free
    x = rng.standard_normal((B, 1, cfg.d_model), np.float32)
    out_j, k_j, v_j = JL.attention_decode_paged(jp["mixer"], jnp.asarray(x), jcfg,
                                                jnp.asarray(k), jnp.asarray(v),
                                                jnp.asarray(pt), jnp.asarray(pos))
    tk, tv = torch.tensor(k), torch.tensor(v)
    out, k2, v2 = L.attention_decode_paged(p["mixer"], torch.tensor(x), cfg, tk, tv,
                                           torch.tensor(pt), torch.tensor(pos))
    assert k2 is tk and v2 is tv                   # updated in place
    # lanes 1 and 3 both write scratch slot (0, 0), in an undefined order, and
    # free lane 3 reads it: only the mapped lanes' outputs are defined
    _close(out[:3], np.asarray(out_j)[:3])
    for got, want in ((tk, k_j), (tv, v_j)):
        got, want = got.numpy(), np.asarray(want)
        # scratch block 0 takes several lanes' writes in an undefined order
        np.testing.assert_allclose(got[1:], want[1:], atol=ATOL, rtol=0)


@pytest.mark.parametrize("off,length", [(0, 8), (5, 3), (13, 8), (28, 8)])
def test_attention_prefill_chunk_paged_matches_with_pools(setup, off, length):
    """Chunk at offset 0, a short tail, a page straddle, and a window hanging
    past capacity (rows past it go to scratch)."""
    jcfg, cfg, jp, p = setup
    rng = np.random.default_rng(2 + off)
    ps, num_pages, NB, C = 8, 4, 9, 8
    k, v = _pools(cfg, rng, NB, ps)
    row = np.asarray([2, 7, 4, 8], np.int32)
    x = rng.standard_normal((1, C, cfg.d_model), np.float32)
    out_j, k_j, v_j = JL.attention_prefill_chunk_paged(
        jp["mixer"], jnp.asarray(x), jcfg, jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(row), jnp.asarray(off, jnp.int32), jnp.asarray(length, jnp.int32))
    tk, tv = torch.tensor(k), torch.tensor(v)
    out, _, _ = L.attention_prefill_chunk_paged(p["mixer"], torch.tensor(x), cfg, tk, tv,
                                                torch.tensor(row),
                                                torch.tensor(off, dtype=torch.int32),
                                                length)
    valid = min(length, num_pages * ps - off)
    _close(out[:, :valid], np.asarray(out_j)[:, :valid])
    for got, want in ((tk, k_j), (tv, v_j)):
        np.testing.assert_allclose(got.numpy()[1:], np.asarray(want)[1:], atol=ATOL, rtol=0)
