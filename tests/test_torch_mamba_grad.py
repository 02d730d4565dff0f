"""Gradients through the port's selective scan and Mamba mixer against the
JAX package's.

The plain backward (``ref.mamba_scan_bwd_ref``, what the backward wrapper
runs on CPU tensors) is held against ``torch.autograd`` through the plain
forward; ``ops.mamba_scan`` under autograd against ``jax.vjp`` of the JAX
sequential oracle; ``layers.mamba_full``'s gradients against ``jax.vjp`` of
the JAX ``mamba_full`` (its chunked, checkpointed scan) at
``jamba_v0_1_52b.reduced()``.  Inputs come from numpy at a seed.

Tolerance: 1e-5 of max(1, max |reference|), float32 (sums in another order).
The references are computed in f32 from the same values; a gradient the
port returns in bfloat16 (dB, dC, dx for bf16 x/B/C) is also allowed half a
bf16 ulp of its value, the one rounding of its cast.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_hold import hold_bf16_cast
from _torch_parity import jax_and_port, to_np
from _torch_parity import one_torch_thread  # noqa: F401
from repro.kernels.mamba_scan import mamba_scan_ref as jax_scan_ref
from repro.models import layers as JL
from repro_torch.kernels import mamba_scan as scan_kernel
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

pytestmark = pytest.mark.usefixtures("one_torch_thread")
TOL = 1e-5
SHAPES = [(1, 1, 8, 4), (2, 19, 16, 16), (2, 130, 96, 16), (1, 70, 32, 32)]
NAMES = ("dt", "b_in", "c_in", "x", "a_log")


def _inputs(B, S, di, N, dtype, seed=0):
    """dt, a_log f32; b_in, c_in, x in ``dtype``; g_y (B,S,di) and g_h
    (B,di,N) f32."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)
    b_in, c_in = ((0.5 * rng.standard_normal((B, S, N))).astype(np.float32) for _ in "bc")
    x = (0.5 * rng.standard_normal((B, S, di))).astype(np.float32)
    a_log = (0.3 * rng.standard_normal((di, N))).astype(np.float32)
    g_y = rng.standard_normal((B, S, di)).astype(np.float32)
    g_h = rng.standard_normal((B, di, N)).astype(np.float32)
    low = getattr(torch, dtype)
    args = (torch.tensor(dt), *(torch.tensor(t).to(low) for t in (b_in, c_in, x)),
            torch.tensor(a_log))
    return args, torch.tensor(g_y), torch.tensor(g_h)


def _hold(got, want, label):
    hold_bf16_cast(got, torch.tensor(np.array(want, np.float32)), TOL, label)


@pytest.mark.parametrize("with_gh", [True, False], ids=["g_h", "no_g_h"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_autograd(shape, dtype, with_gh):
    """(a) ``mamba_scan_bwd_ref`` against autograd through ``mamba_scan_ref``
    on f32 copies of the same values; dtypes as the wrapper's contract says."""
    args, g_y, g_h = _inputs(*shape, dtype)
    got = ref.mamba_scan_bwd_ref(*args, g_y, g_h if with_gh else None)
    assert [t.dtype for t in got] == [torch.float32, *(a.dtype for a in args[1:4]),
                                      torch.float32]
    leaves = [a.float().requires_grad_() for a in args]
    y, h = ref.mamba_scan_ref(*leaves)
    loss = (y * g_y).sum() + ((h * g_h).sum() if with_gh else 0)
    want = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(NAMES, got, want):
        _hold(g, w.numpy(), (name, shape, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_scan_under_autograd_matches_jax_vjp(shape, dtype):
    """(b) ``ops.mamba_scan`` differentiated by torch (the autograd Function,
    the plain backward on the CPU) against ``jax.vjp`` of the JAX sequential
    oracle, the cotangent of y drawn; gradients in the inputs' dtypes."""
    args, g_y, _ = _inputs(*shape, dtype, seed=1)
    leaves = [a.clone().requires_grad_() for a in args]
    before = dict(scan_kernel.launches)
    y, _ = ops.mamba_scan(*leaves)
    got = torch.autograd.grad(y, leaves, g_y)
    assert scan_kernel.launches == before                # CPU tensors: no kernel
    assert [g.dtype for g in got] == [a.dtype for a in args]
    jargs = [jnp.asarray(a.float().numpy()) for a in args]
    jy, vjp = jax.vjp(jax_scan_ref, *jargs)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-4, rtol=0)
    for name, g, w in zip(NAMES, got, vjp(jnp.asarray(g_y.numpy()))):
        _hold(g, np.asarray(w), (name, shape, dtype))


@pytest.fixture(scope="module")
def jamba():
    jcfg, cfg, jparams, params = jax_and_port("jamba_v0_1_52b")
    key = "00_mamba+mlp"
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"][key]["mixer"])      # period 0
    p = {n: t[0] for n, t in params["blocks"][key]["mixer"].items()}
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("S", [19, 600])
def test_mamba_full_gradients_match_jax_vjp(jamba, S):
    """(c) Every Mamba leaf's gradient and the input's through the port's
    ``mamba_full`` against ``jax.vjp`` of the JAX one; at S 600 the JAX scan
    runs two checkpointed chunks of ``MAMBA_CHUNK`` = 512, the second padded."""
    jcfg, cfg, jp, p = jamba
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    leaves = {n: t.detach().clone().requires_grad_() for n, t in p.items()}
    xt = torch.tensor(x, requires_grad=True)
    out, _ = L.mamba_full(leaves, xt, cfg)
    grads = torch.autograd.grad(out, [xt, *leaves.values()], torch.tensor(w))
    jout, vjp = jax.vjp(lambda pp, xx: JL.mamba_full(pp, xx, jcfg), jp, jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-5, rtol=0)
    jgp, jgx = vjp(jnp.asarray(w))
    assert set(jgp) == set(leaves)
    _hold(grads[0], to_np(jgx), "x")
    for (name, g) in zip(leaves, grads[1:]):
        assert float(g.abs().max()) > 0, name
        _hold(g, to_np(jgp[name]), name)


def test_empty_sequence_gives_zero_gradients():
    """(d) S 0: y is empty and the last state is 0 whatever the inputs, so
    every gradient is 0 (dA_log included) and the empty ones keep their
    shapes."""
    args, _, g_h = _inputs(2, 0, 16, 8, "float32")
    leaves = [a.clone().requires_grad_() for a in args]
    y, h = ops.mamba_scan(*leaves)
    assert y.shape == (2, 0, 16) and not h.any()
    got = torch.autograd.grad((h * g_h).sum(), leaves)
    for a, g in zip(args, got):
        assert g.shape == a.shape and g.dtype == a.dtype and not g.any()
    got = ref.mamba_scan_bwd_ref(*args, None, None)
    assert not got[-1].any() and got[0].shape == (2, 0, 16)
