"""The port's selective scan and Mamba layers against the JAX package's.

The plain scan (``kernels.ops.mamba_scan`` on CPU tensors) is held against
JAX's sequential oracle and the Pallas kernel in interpret mode over
``tests/test_kernels.py``'s shape sweep, in float32 at 1e-4 (that file's
tolerance); its last state against the final carry of JAX's chunked
associative scan.  The layers run at ``jamba_v0_1_52b.reduced(n_periods=1)``
(float32, d 256, di 512, N 16) with the JAX ``init_params`` pytree carried
across by ``from_jax``, at 2e-5 (float32, sums in another order).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.mamba_scan import mamba_scan_pallas, mamba_scan_ref
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.kernels import mamba_scan as scan_kernel
from repro_torch.kernels import meta as scan_kernel_meta
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.params import from_jax

ATOL = 2e-5
SCAN_TOL = 1e-4
# tests/test_kernels.py's MAMBA_SHAPES: (B, S, di, N, chunk, di_block)
MAMBA_SHAPES = [
    (2, 37, 64, 8, 16, 32),
    (1, 128, 128, 16, 64, 128),
    (3, 50, 96, 4, 25, 48),
    (2, 33, 64, 16, 64, 64),
]


def _scan_inputs(B, S, di, N, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)  # softplus
    b_in = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    c_in = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    x = (rng.standard_normal((B, S, di)) * 0.5).astype(np.float32)
    a_log = (rng.standard_normal((di, N)) * 0.3).astype(np.float32)
    return dt, b_in, c_in, x, a_log


@pytest.mark.parametrize("shape", MAMBA_SHAPES)
def test_plain_scan_matches_jax_oracle_and_pallas(shape):
    B, S, di, N, chunk, dib = shape
    args = _scan_inputs(B, S, di, N)
    y, h = ops.mamba_scan(*map(torch.tensor, args))
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, di) and h.shape == (B, di, N)
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(y.numpy(), np.asarray(mamba_scan_ref(*jargs)),
                               atol=SCAN_TOL, rtol=0)
    pallas = mamba_scan_pallas(*jargs, chunk=chunk, di_block=dib, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(pallas), atol=SCAN_TOL, rtol=0)
    dt, b_in, _, x, a_log = jargs                 # the state: JAX's chunked scan carry
    a = jnp.exp(dt[..., None] * -jnp.exp(a_log))
    b = (dt * x)[..., None] * b_in[..., None, :]
    _, h_last = JL._mamba_scan_chunked(a, b, jnp.zeros((B, di, N), jnp.float32))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_last), atol=SCAN_TOL, rtol=0)


def test_plain_scan_of_bf16_inputs_matches_oracle():
    """The main path's dtypes: dt and a_log f32, x/B/C bf16."""
    dt, b_in, c_in, x, a_log = _scan_inputs(1, 40, 64, 16, seed=3)
    bf = [torch.tensor(t).bfloat16() for t in (b_in, c_in, x)]
    y, _ = ops.mamba_scan(torch.tensor(dt), bf[0], bf[1], bf[2], torch.tensor(a_log))
    want = mamba_scan_ref(jnp.asarray(dt), *(jnp.asarray(t.float().numpy()) for t in bf[:2]),
                          jnp.asarray(bf[2].float().numpy()), jnp.asarray(a_log))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=SCAN_TOL, rtol=0)


def test_scan_wrapper_device_rule():
    """CPU tensors take the plain version without touching the kernel's
    count; ``meta`` tensors take the kernel's shape function (the outputs'
    shapes and dtypes, nothing launched or counted); a device with no kernel
    raises (the rule is a function of the device: ``kernels/meta.py``)."""
    args = [torch.tensor(a) for a in _scan_inputs(1, 5, 8, 4)]
    before = dict(scan_kernel.launches)
    y, h = scan_kernel.mamba_scan(*args)
    assert y.shape == (1, 5, 8) and scan_kernel.launches == before
    ym, hm = scan_kernel.mamba_scan(*(a.to("meta") for a in args))
    assert [(t.shape, t.dtype, t.device.type) for t in (ym, hm)] == \
        [(t.shape, t.dtype, "meta") for t in (y, h)]
    assert scan_kernel.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        scan_kernel_meta.arm("mamba_scan", torch.device("xpu"))


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("jamba_v0_1_52b").reduced(n_periods=1)
    cfg = get_config("jamba_v0_1_52b").reduced(n_periods=1)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    key = "00_mamba+mlp"
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"][key]["mixer"])   # period 0
    p = {n: t[0] for n, t in params["blocks"][key]["mixer"].items()}
    return jcfg, cfg, jp, p


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)), atol=atol, rtol=0)


@pytest.mark.parametrize("S", [1, 19])
def test_mamba_full_and_state_from_full_match(setup, S):
    jcfg, cfg, jp, p = setup
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    out, state = L.mamba_full(p, torch.tensor(x), cfg)
    _close(out, JL.mamba_full(jp, jnp.asarray(x), jcfg))
    want = JM._mamba_state_from_full(jcfg, jp, jnp.asarray(x))
    got = M._mamba_state_from_full(cfg, p, torch.tensor(x))
    for name in ("h", "conv"):
        _close(state[name], want[name])
        _close(got[name], want[name])


def test_mamba_step_matches(setup):
    jcfg, cfg, jp, p = setup
    rng = np.random.default_rng(5)
    di = cfg.ssm_expand * cfg.d_model
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    state = {"h": rng.standard_normal((3, di, cfg.ssm_state_dim)).astype(np.float32),
             "conv": rng.standard_normal((3, cfg.ssm_conv_width - 1, di)).astype(np.float32)}
    tstate = {k: torch.tensor(v) for k, v in state.items()}
    out, new = L.mamba_step(p, torch.tensor(x), cfg, tstate)
    jout, jnew = JL.mamba_step(jp, jnp.asarray(x), jcfg,
                               {k: jnp.asarray(v) for k, v in state.items()})
    _close(out, jout)
    for name in ("h", "conv"):
        _close(new[name], jnew[name])
        np.testing.assert_array_equal(tstate[name].numpy(), state[name])   # not changed


def test_full_then_steps_continue_the_sequence(setup):
    """The state left by ``mamba_full`` over S tokens, stepped once, gives
    what ``mamba_full`` over S + 1 tokens gives at the last token."""
    _, cfg, _, p = setup
    x = torch.tensor(np.random.default_rng(9).standard_normal((1, 12, cfg.d_model)),
                     dtype=torch.float32)
    full, _ = L.mamba_full(p, x, cfg)
    _, state = L.mamba_full(p, x[:, :11], cfg)
    step, _ = L.mamba_step(p, x[:, 11:], cfg, state)
    _close(step[:, 0], full[:, 11].numpy())


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_recurrent_chunk_prefill_matches(paged):
    """A chunkable Mamba stack (the jamba period with every MoE a dense MLP):
    chunks with padding rows into a dense lane or a paged lane's state row,
    then a decode step, against the JAX package."""
    kinds = tuple(k.replace("+moe", "+mlp") for k in
                  get_config("jamba_v0_1_52b").block_pattern[:4])
    jcfg = replace(jax_config("jamba_v0_1_52b").reduced(n_periods=1), block_pattern=kinds)
    cfg = replace(get_config("jamba_v0_1_52b").reduced(n_periods=1), block_pattern=kinds)
    assert M.supports_chunked_prefill(cfg) and not M.supports_prefix_reuse(cfg)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(2))
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    chunks = [(np.arange(8) + 3, 8), (np.array([40, 41, 42, 0, 0, 0, 0, 0]), 3)]
    if paged:
        jpool = JM.init_paged_pool(jcfg, None, 2, 5, 8, 4)
        jpool = JM.paged_set_lane(jpool, 1, jnp.asarray([2, 4, 0, 0], jnp.int32), 0)
        pool = M.paged_set_lane(M.init_paged_pool(cfg, 2, 5, 8, 4, "cpu"), 1,
                                np.asarray([2, 4, 0, 0], np.int32), 0)
        for toks, n in chunks:
            jpool = JM.prefill_chunk_paged(jcfg, jparams, jpool, 1,
                                           jnp.asarray(toks[None], jnp.int32), n)
            M.prefill_chunk_paged(cfg, params, pool, 1, torch.tensor(toks[None]), n)
        tok = np.array([[7], [11]])
    else:
        jpool, pool = JM.init_cache(jcfg, None, 1, 16), M.init_cache(cfg, 1, 16, "cpu")
        for toks, n in chunks:
            jpool = JM.prefill_chunk(jcfg, jparams, jpool, jnp.asarray(toks[None], jnp.int32), n)
            M.prefill_chunk(cfg, params, pool, torch.tensor(toks[None]), n)
        tok = np.array([[11]])
    np.testing.assert_array_equal(pool["pos"].numpy(), np.asarray(jpool["pos"]))
    jlogits, jpool = JM.decode_step(jcfg, jparams, jpool, jnp.asarray(tok, jnp.int32))
    logits, _ = M.decode_step(cfg, params, pool, torch.tensor(tok))
    _close(logits, jlogits, 1e-4)
    for key, c in jpool["blocks"].items():
        for name, leaf in c.items():
            got, want = pool["blocks"][key][name].numpy(), np.asarray(leaf)
            if paged and name in ("k", "v"):                   # scratch block 0 aside
                got, want = got[:, 1:], want[:, 1:]
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=f"{key}/{name}")
