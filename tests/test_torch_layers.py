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


# ----------------------------------------------------------------- dense plane

@pytest.mark.parametrize("window", [0, 16], ids=["linear", "ring"])
def test_attention_decode_matches_with_cache(setup, window):
    """Linear: a lane at C - 1 and one past it (both write slot C - 1).  Ring:
    lanes past C write at pos % C.  Out and the written caches match JAX."""
    jcfg, cfg, jp, p = setup
    rng = np.random.default_rng(5)
    B, C = 4, 16
    shape = (B, C, cfg.n_kv_heads, cfg.hd)
    k, v = rng.standard_normal(shape, np.float32), rng.standard_normal(shape, np.float32)
    pos = np.asarray([3, 15, 21, 40], np.int32)
    x = rng.standard_normal((B, 1, cfg.d_model), np.float32)
    out_j, k_j, v_j = JL.attention_decode(jp["mixer"], jnp.asarray(x), jcfg, jnp.asarray(k),
                                          jnp.asarray(v), jnp.asarray(pos), window=window)
    tk, tv = torch.tensor(k), torch.tensor(v)
    out, k2, v2 = L.attention_decode(p["mixer"], torch.tensor(x), cfg, tk, tv,
                                     torch.tensor(pos), window=window)
    assert k2 is tk and v2 is tv                   # updated in place
    _close(out, out_j)
    _close(tk, k_j)
    _close(tv, v_j)


def _lane(cfg, rng, cap, C=8):
    """A chunk of hidden states and a random (1, cap) lane: (x, k, v)."""
    x = rng.standard_normal((1, C, cfg.d_model), np.float32)
    shape = (1, cap, cfg.n_kv_heads, cfg.hd)
    return x, rng.standard_normal(shape, np.float32), rng.standard_normal(shape, np.float32)


def _chunk_pair(setup, x, k, v, off, length):
    """One chunk through JAX's and the port's attention_prefill_chunk on the
    same lane; returns (out_j, k_j, v_j, out, k, v)."""
    jcfg, cfg, jp, p = setup
    jout = JL.attention_prefill_chunk(jp["mixer"], jnp.asarray(x), jcfg, jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(off, jnp.int32),
                                      jnp.asarray(length, jnp.int32))
    tk, tv = torch.tensor(k), torch.tensor(v)
    out, _, _ = L.attention_prefill_chunk(p["mixer"], torch.tensor(x), cfg, tk, tv,
                                          torch.tensor(off, dtype=torch.int32), length)
    return (*jout, out, tk, tv)


@pytest.mark.parametrize("off,length", [(0, 8), (5, 3), (9, 6), (11, 4), (20, 3)])
def test_attention_prefill_chunk_matches_with_cache(setup, off, length):
    """cap 16, chunk 8: at offset 0, a short tail, a chunk ending at cap - 1,
    a window hanging past capacity (off + C > cap >= off + length), and a
    chunk wholly past capacity.  Valid rows' out and the caches match JAX."""
    lane = _lane(setup[1], np.random.default_rng(off), 16)
    out_j, k_j, v_j, out, tk, tv = _chunk_pair(setup, *lane, off, length)
    valid = max(0, min(length, 16 - off))
    _close(out[:, :valid], np.asarray(out_j)[:, :valid])
    _close(tk, k_j)
    _close(tv, v_j)


def test_attention_prefill_chunk_exact_fill_keeps_last_key(setup):
    """A chunk that fills the lane exactly while its window runs past it (cap 8,
    C 8, off 4, length 4): every new key lands at its slot 4..7, as in a lane
    with room to spare (cap 16, same first 8 slots).  The JAX version loses
    the key at cap - 1 (a padding row writes the old contents back over it):
    a documented difference, asserted as such."""
    x, k, v = _lane(setup[1], np.random.default_rng(7), 8)
    room = [np.concatenate([a, np.zeros_like(a)], axis=1) for a in (k, v)]
    out_j, k_j, _, out, tk, _ = _chunk_pair(setup, x, k, v, 4, 4)
    room_out_j, room_kj, _, room_out, room_k, _ = _chunk_pair(setup, x, *room, 4, 4)
    _close(tk[:, :4], k[:, :4])                    # resident prefix untouched
    _close(tk, room_k[:, :8].numpy())              # all four new keys, slot 7 included
    _close(tk, np.asarray(room_kj)[:, :8])
    _close(out[:, :4], np.asarray(room_out_j)[:, :4])
    _close(out[:, :4], room_out[:, :4].numpy())
    # the reference writes slots 4..6 and keeps the old slot 7
    _close(tk[:, :7], np.asarray(k_j)[:, :7])
    np.testing.assert_array_equal(np.asarray(k_j)[:, 7], k[:, 7])
    assert float(np.abs(np.asarray(k_j)[:, 7] - tk[:, 7].numpy()).max()) > 1e-3


@pytest.mark.parametrize("S,window", [(40, 0), (40, 17), (2048, 0), (2100, 300)],
                         ids=["plain", "plain-window", "flash", "flash-window"])
def test_attention_full_matches(setup, S, window):
    """Both branches: plain below 2,048 tokens, flash from 2,048 on."""
    jcfg, cfg, jp, p = setup
    x = np.random.default_rng(S + window).standard_normal((1, S, cfg.d_model), np.float32)
    want = JL.attention_full(jp["mixer"], jnp.asarray(x), jcfg, jnp.arange(S), window=window)
    got = L.attention_full(p["mixer"], torch.tensor(x), cfg, torch.arange(S), window=window)
    _close(got, want)
