"""The port's paged model (chunk prefill, decode_step, pool helpers) against the
JAX package on identical params and inputs.

Config: qwen3_1_7b.reduced(n_periods=2), float32.  Tolerances: 1e-4 absolute on
logits, 2e-5 on pool contents (float32, matrix products summed in another
order).  Greedy tokens are compared under the near-tie rule: where the JAX
top-2 logit gap exceeds the logit tolerance the argmax must agree; closer
calls are counted and reported, never asserted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.params import from_jax

LOGIT_TOL = 1e-4
POOL_TOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("qwen3_1_7b").reduced(n_periods=2)
    cfg = get_config("qwen3_1_7b").reduced(n_periods=2)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _pools(jcfg, cfg, lanes, num_blocks, ps, num_pages):
    jpool = JM.init_paged_pool(jcfg, None, lanes, num_blocks, ps, num_pages)
    pool = M.init_paged_pool(cfg, lanes, num_blocks, ps, num_pages, "cpu")
    assert set(pool) == set(jpool) and pool["blocks"].keys() == jpool["blocks"].keys()
    for key, c in jpool["blocks"].items():
        for name, leaf in c.items():
            assert tuple(pool["blocks"][key][name].shape) == leaf.shape
    return jpool, pool


def _assert_pools_match(pool, jpool):
    np.testing.assert_array_equal(pool["pos"].numpy(), np.asarray(jpool["pos"]))
    np.testing.assert_array_equal(pool["page_table"].numpy(),
                                  np.asarray(jpool["page_table"]))
    for key, c in jpool["blocks"].items():
        for name, leaf in c.items():
            # block 0 is scratch: several rows may write it in an undefined order
            np.testing.assert_allclose(pool["blocks"][key][name].numpy()[:, 1:],
                                       np.asarray(leaf)[:, 1:], atol=POOL_TOL, rtol=0)


def _chunk(jcfg, cfg, jparams, params, jpool, pool, slot, tokens, C=8):
    for off in range(0, len(tokens), C):
        part = tokens[off:off + C]
        buf = np.zeros((1, C), np.int32)
        buf[0, :len(part)] = part
        jpool = JM.prefill_chunk_paged(jcfg, jparams, jpool, jnp.int32(slot),
                                       jnp.asarray(buf), jnp.int32(len(part)))
        M.prefill_chunk_paged(cfg, params, pool, slot, torch.tensor(buf), len(part))
    return jpool


def _map_lane(jpool, pool, slot, row, pos0=0):
    jpool = JM.paged_set_lane(jpool, jnp.int32(slot), jnp.asarray(row), jnp.int32(pos0))
    M.paged_set_lane(pool, slot, row, pos0)
    return jpool


def test_prefill_chunk_and_decode_step_match(setup):
    jcfg, cfg, jparams, params = setup
    jpool, pool = _pools(jcfg, cfg, lanes=2, num_blocks=9, ps=16, num_pages=4)
    jpool = _map_lane(jpool, pool, 1, np.asarray([3, 5, 0, 0], np.int32))
    jpool = _chunk(jcfg, cfg, jparams, params, jpool, pool, 1,
                   [5, 7, 9, 11, 13, 17, 19, 23, 29, 31, 37])       # 2 chunks
    _assert_pools_match(pool, jpool)
    tokens = np.asarray([[0], [37]], np.int32)
    active = np.asarray([False, True])
    for _ in range(3):
        jlogits, jpool = JM.decode_step(jcfg, jparams, jpool, jnp.asarray(tokens),
                                        active=jnp.asarray(active))
        logits, pool = M.decode_step(cfg, params, pool, torch.tensor(tokens),
                                     active=torch.tensor(active))
        assert logits.shape == (2, cfg.vocab)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGIT_TOL,
                                   rtol=0)
        _assert_pools_match(pool, jpool)
        tokens = np.asarray(jnp.argmax(jlogits, -1), np.int32)[:, None]


def test_page_boundary_straddle_teacher_forced(setup):
    """page_size 4: the prompt (6 tokens = 1.5 pages), the decode (to 11), a
    tool extension landing exactly on a page edge (16) and the decode after it
    all straddle pages.  Logits match at every step under teacher forcing."""
    jcfg, cfg, jparams, params = setup
    ps, num_pages = 4, 16
    jpool, pool = _pools(jcfg, cfg, lanes=1, num_blocks=num_pages + 1, ps=ps,
                         num_pages=num_pages)
    row = np.arange(num_pages, 0, -1, dtype=np.int32)    # blocks out of order
    jpool = _map_lane(jpool, pool, 0, row)
    prompt = [3 + i for i in range(6)]
    jpool = _chunk(jcfg, cfg, jparams, params, jpool, pool, 0, prompt)
    near_ties = decided = 0
    last = prompt[-1]

    def decode(n, jpool, last):
        nonlocal near_ties, decided
        for _ in range(n):
            tok = np.asarray([[last]], np.int32)
            jlogits, jpool = JM.decode_step(jcfg, jparams, jpool, jnp.asarray(tok))
            logits, _ = M.decode_step(cfg, params, pool, torch.tensor(tok))
            jl = np.asarray(jlogits)[0]
            np.testing.assert_allclose(logits.numpy()[0], jl, atol=LOGIT_TOL, rtol=0)
            top2 = np.sort(jl)[-2:]
            if top2[1] - top2[0] > LOGIT_TOL:
                decided += 1
                assert int(logits[0].argmax()) == int(jl.argmax())
            else:
                near_ties += 1
            last = int(jl.argmax())                        # teacher: the JAX token
        return jpool, last

    jpool, last = decode(5, jpool, last)                   # 6 + 5 = 11 positions
    jpool = _extend(jcfg, cfg, jparams, params, jpool, pool)   # 11 -> 16: a page edge
    jpool, last = decode(6, jpool, 105)
    _assert_pools_match(pool, jpool)
    assert int(pool["pos"][0]) == 22
    assert decided > 0, f"every step was a near-tie ({near_ties})"


def _extend(jcfg, cfg, jparams, params, jpool, pool):
    """Five tool tokens at the lane's current offset, one chunk."""
    buf = np.zeros((1, 8), np.int32)
    buf[0, :5] = [101, 102, 103, 104, 105]
    jpool = JM.prefill_chunk_paged(jcfg, jparams, jpool, jnp.int32(0), jnp.asarray(buf),
                                   jnp.int32(5))
    M.prefill_chunk_paged(cfg, params, pool, 0, torch.tensor(buf), 5)
    return jpool


def test_pool_helpers_match(setup):
    """Block copy, gather/scatter of pages, lane state, and both growths."""
    jcfg, cfg, jparams, params = setup
    jpool, pool = _pools(jcfg, cfg, lanes=2, num_blocks=6, ps=4, num_pages=3)
    jpool = _map_lane(jpool, pool, 0, np.asarray([2, 4, 0], np.int32))
    jpool = _chunk(jcfg, cfg, jparams, params, jpool, pool, 0, list(range(3, 9)), C=4)
    jpool = JM.paged_copy_block(jpool, jnp.int32(5), jnp.int32(4))
    M.paged_copy_block(pool, 5, 4)
    _assert_pools_match(pool, jpool)
    jpages = JM.paged_gather_pages(jpool, [2, 5])
    pages = M.paged_gather_pages(pool, [2, 5])
    for key, c in jpages.items():
        for name, leaf in c.items():
            np.testing.assert_allclose(pages[key][name].numpy(), np.asarray(leaf),
                                       atol=POOL_TOL, rtol=0)
    state = M.paged_gather_state(pool, 0)
    jstate = JM.paged_gather_state(jpool, 0)
    np.testing.assert_array_equal(state["pos"].numpy(), np.asarray(jstate["pos"]))
    jpool = JM.grow_paged_blocks(jpool, 3)
    M.grow_paged_blocks(pool, 3)
    jpool = JM.grow_paged_lanes(jcfg, jpool, 2)
    M.grow_paged_lanes(cfg, pool, 2)
    row = np.asarray([6, 7, 0], np.int32)
    jpool = JM.paged_write_state(JM.paged_scatter_pages(jpool, jpages, jnp.asarray([6, 7])),
                                 jstate, jnp.int32(3), jnp.asarray(row))
    M.paged_write_state(M.paged_scatter_pages(pool, pages, [6, 7]), state, 3, row)
    _assert_pools_match(pool, jpool)


def test_init_params_shapes_match_jax(setup):
    jcfg, cfg, jparams, _ = setup
    params = M.init_params(cfg, seed=0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert M.param_count(params) == sum(leaf.size for _, leaf in flat_j)
    for path, leaf in flat_j:
        t = params
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
    std = float(params["blocks"]["00_attn+mlp"]["mixer"]["wq"].std())
    assert abs(std - 0.02) < 0.002                 # model.init_params' scale


# ------------------------------------------------------------------ dense plane

def _assert_caches_match(cache, jcache, atol=POOL_TOL):
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    assert cache["blocks"].keys() == jcache["blocks"].keys()
    for key, c in jcache["blocks"].items():
        for name, leaf in c.items():
            assert tuple(cache["blocks"][key][name].shape) == leaf.shape
            np.testing.assert_allclose(cache["blocks"][key][name].numpy(), np.asarray(leaf),
                                       atol=atol, rtol=0)


@pytest.mark.parametrize("S,capacity,window", [(20, 32, 0), (40, 16, 0), (40, 16, 16)],
                         ids=["linear", "ring-past-capacity", "ring-window"])
def test_forward_full_with_capacity_matches(setup, S, capacity, window):
    """Logits and the cache it leaves: linear (capacity >= S), and the last
    ``capacity`` tokens at ring slots when S > capacity, with and without a
    sliding window."""
    jcfg, cfg, jparams, params = setup
    jcfg, cfg = jcfg.with_sliding_window(window), cfg.with_sliding_window(window)
    tokens = np.random.default_rng(S).integers(0, cfg.vocab, (2, S)).astype(np.int32)
    jlogits, _, jcache = JM.forward_full(jcfg, jparams, {"tokens": jnp.asarray(tokens)},
                                         capacity=capacity)
    logits, aux, cache = M.forward_full(cfg, params, {"tokens": torch.tensor(tokens)},
                                        capacity=capacity)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGIT_TOL, rtol=0)
    _assert_caches_match(cache, jcache)
    jlogits2, _ = JM.forward_full(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    logits2, _ = M.forward_full(cfg, params, {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(logits2.numpy(), np.asarray(jlogits2), atol=LOGIT_TOL, rtol=0)


def _dense_chunk(jcfg, cfg, jparams, params, jlane, lane, tokens, C=8):
    for off in range(0, len(tokens), C):
        part = tokens[off:off + C]
        buf = np.zeros((1, C), np.int32)
        buf[0, :len(part)] = part
        jlane = JM.prefill_chunk(jcfg, jparams, jlane, jnp.asarray(buf), len(part))
        M.prefill_chunk(cfg, params, lane, torch.tensor(buf), len(part))
    return jlane


@pytest.mark.parametrize("window", [0, 16], ids=["linear", "ring"])
def test_dense_prefill_chunk_and_decode_step_match(setup, window):
    """A lane chunk-prefilled (linear) or admitted by a full forward (ring),
    written into a 3-lane pool, then masked decode steps past the ring's
    capacity: logits and the pool match JAX after every step."""
    jcfg, cfg, jparams, params = setup
    jcfg, cfg = jcfg.with_sliding_window(window), cfg.with_sliding_window(window)
    cap = 16
    jpool, pool = JM.init_cache(jcfg, None, 3, cap), M.init_cache(cfg, 3, cap, "cpu")
    _assert_caches_match(pool, jpool)
    prompt = [5, 7, 9, 11, 13, 17, 19, 23, 29, 31, 37]
    if window:
        arr = np.asarray([prompt], np.int32)
        _, _, jlane = JM.forward_full(jcfg, jparams, {"tokens": jnp.asarray(arr)}, capacity=cap)
        _, _, lane = M.forward_full(cfg, params, {"tokens": torch.tensor(arr)}, capacity=cap)
    else:
        jlane, lane = JM.init_cache(jcfg, None, 1, cap), M.init_cache(cfg, 1, cap, "cpu")
        jlane = _dense_chunk(jcfg, cfg, jparams, params, jlane, lane, prompt)
    _assert_caches_match(lane, jlane)
    jpool = JM.write_slot(jpool, jlane, 1)
    assert M.write_slot(pool, lane, 1) is pool
    _assert_caches_match(pool, jpool)
    tokens = np.asarray([[0], [37], [0]], np.int32)
    active = np.asarray([False, True, False])
    for _ in range(8):                                     # to pos 19: past cap 16
        jlogits, jpool = JM.decode_step(jcfg, jparams, jpool, jnp.asarray(tokens),
                                        active=jnp.asarray(active))
        logits, _ = M.decode_step(cfg, params, pool, torch.tensor(tokens),
                                  active=torch.tensor(active))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGIT_TOL,
                                   rtol=0)
        _assert_caches_match(pool, jpool)
        tokens = np.asarray(jnp.argmax(jlogits, -1), np.int32)[:, None]
    assert int(pool["pos"][1]) == len(prompt) + 8


def test_dense_pool_helpers_match(setup):
    """copy_prefix (radix lane reuse), gather_slots, write_slot and
    concat_pools, on a pool whose lanes hold different prefixes."""
    jcfg, cfg, jparams, params = setup
    cap = 16
    jpool, pool = JM.init_cache(jcfg, None, 2, cap), M.init_cache(cfg, 2, cap, "cpu")
    for slot, prompt in ((0, list(range(3, 15))), (1, list(range(40, 49)))):
        jlane, lane = JM.init_cache(jcfg, None, 1, cap), M.init_cache(cfg, 1, cap, "cpu")
        jlane = _dense_chunk(jcfg, cfg, jparams, params, jlane, lane, prompt)
        jpool = JM.write_slot(jpool, jlane, slot)
        M.write_slot(pool, lane, slot)
    lane = M.init_cache(cfg, 1, cap, "cpu")
    jlane = _dense_chunk(jcfg, cfg, jparams, params, JM.init_cache(jcfg, None, 1, cap), lane,
                         [1, 2, 3])
    jlane = JM.copy_prefix(jpool, 1, jlane, 5)            # 5 of lane 1's 9 over 3 own
    assert M.copy_prefix(pool, 1, lane, 5) is lane
    _assert_caches_match(lane, jlane)
    jgot, got = JM.gather_slots(jpool, np.asarray([1, 0])), M.gather_slots(pool, [1, 0])
    _assert_caches_match(got, jgot)
    jbig = JM.concat_pools(jpool, JM.init_cache(jcfg, None, 2, cap))
    big = M.concat_pools(pool, M.init_cache(cfg, 2, cap, "cpu"))
    _assert_caches_match(big, jbig)
    _assert_caches_match(M.write_slot(big, lane, 3), JM.write_slot(jbig, jlane, 3))


def test_pages_to_lane_and_paged_write_lane_match(setup):
    """The cross-layout pair: pages of a paged lane flattened into a dense lane
    (zero-padded to capacity), and a dense lane scattered into mapped pages."""
    jcfg, cfg, jparams, params = setup
    ps, num_pages = 4, 4
    jpool, pool = _pools(jcfg, cfg, lanes=2, num_blocks=10, ps=ps, num_pages=num_pages)
    jpool = _map_lane(jpool, pool, 0, np.asarray([7, 2, 5, 0], np.int32))
    jpool = _chunk(jcfg, cfg, jparams, params, jpool, pool, 0, list(range(3, 13)), C=4)
    jpages, pages = JM.paged_gather_pages(jpool, [7, 2, 5]), M.paged_gather_pages(pool, [7, 2, 5])
    jstate, state = JM.paged_gather_state(jpool, 0), M.paged_gather_state(pool, 0)
    jlane = JM.pages_to_lane(jpages, jstate, 16)
    lane = M.pages_to_lane(pages, state, 16)
    _assert_caches_match(lane, jlane)
    row = np.asarray([9, 1, 3, 0], np.int32)
    jpool = JM.paged_write_lane(jpool, jlane, jnp.int32(1), jnp.asarray(row), jnp.int32(10))
    assert M.paged_write_lane(pool, lane, 1, row, 10) is pool
    _assert_pools_match(pool, jpool)
