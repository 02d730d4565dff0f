"""The selective-scan kernel's copy widths and tile arithmetic, on the CPU.

``mamba_scan._scan_plan`` chooses from the shapes and addresses alone the
copy width of each operand into and out of the hand-written kernel's
shared-memory tile ring, and the wrapper passes that choice to the kernel.
Here: every width divides its address and row stride and is the widest that
does, plain loads only where a bf16 row is not 4-byte aligned, and the plan
at the main path's shape is 16-byte copies throughout.  Then the arithmetic
argument the kernel's design rests on, shown on the plain version and a numpy
model of the kernel's arithmetic (the kernel itself runs only on the card,
where ``tests/test_torch_gpu.py`` holds it to the plain version): steps
zero-filled past S leave y and the last state as they were, and exp2 of the
pre-scaled A with factors below 2^-126 flushed to 0 stays within the
kernel's tolerance.  Last, the plain version against the JAX package where a
tile or the ring begins or ends (S of 1, 63, 64, 65, 191, 193), at a ragged
and an odd di, and at every built N: y against its oracle, the last state
against the JAX model's own chunked scan, within 1e-4 in float32
(``tests/test_kernels.py``'s tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import mamba_scan_ref as j_scan_ref
from repro.models.layers import _mamba_scan_chunked as j_scan_chunked
from repro_torch.kernels import mamba_scan as scan_kernel
from repro_torch.kernels import ref

plan = scan_kernel._scan_plan
SCAN_TOL = 1e-4
STEPS = 64          # time steps a tile (kSteps in csrc/mamba_scan.cu)


def _strides(S, di, N, item):
    """Row strides in bytes of dt, x, B, C and y, by plan key."""
    return {"w_dt": 4 * di, "w_x": item * di, "w_b": item * S * N, "w_c": item * S * N,
            "w_y": 4 * di}


def _items(item):
    return {"w_dt": 4, "w_x": item, "w_b": item, "w_c": item, "w_y": 4}


@pytest.mark.parametrize("item", [2, 4])
@pytest.mark.parametrize("di", [98, 101, 96, 8192])
def test_copy_widths_divide_address_and_stride_and_are_the_widest(di, item):
    S, N = 65, 16
    base = 1 << 20
    for k in range(8):                         # element-aligned addresses, 0..7 elements in
        f32, it = base + 4 * k, base + item * k
        p = plan(S, di, N, item, (f32, it, base + item * (7 - k), it, f32))
        addr = {"w_dt": f32, "w_b": it, "w_c": base + item * (7 - k), "w_x": it, "w_y": f32}
        strides, items = _strides(S, di, N, item), _items(item)
        assert set(p) == set(scan_kernel.PLAN_KEYS)
        for key in scan_kernel.PLAN_KEYS:
            w, a = p[key], addr[key] | strides[key]
            assert w in (2, 4, 8, 16) and w >= items[key], (key, w)
            if w < 4:                          # plain loads: a bf16 row, 2-byte aligned
                assert items[key] == 2 and a % 4, (key, k)
                continue
            assert a % w == 0, (key, w, k)
            if w < 16:                         # and no wider copy would do
                assert a % (2 * w), (key, w, k)


def test_plain_loads_only_where_a_bf16_row_is_not_4_byte_aligned():
    aligned = (0, 0, 0, 0, 0)
    assert plan(64, 101, 16, 2, aligned)["w_x"] == 2        # odd di in bf16
    assert plan(64, 98, 16, 2, aligned)["w_x"] == 4         # 196-byte rows
    assert plan(64, 101, 16, 4, aligned)["w_x"] == 4        # f32 rows: 4-byte copies
    assert plan(64, 96, 4, 2, (0, 2, 0, 0, 0))["w_b"] == 2
    assert plan(3, 96, 4, 2, aligned)["w_b"] == 8           # B rows of a batch row: 24 bytes
    p = plan(64, 101, 16, 2, aligned)
    assert p["w_dt"] == 4 == p["w_y"]


def test_plan_at_the_main_shape():
    """One 2,048-token jamba admission (B 1, di 8,192, N 16), every tensor
    fresh from the allocator (512-byte aligned): 16-byte copies throughout,
    in bf16 and in f32."""
    ptrs = (512, 1024, 1536, 2048, 2560)
    for item in (2, 4):
        assert plan(2048, 8192, 16, item, ptrs) == dict.fromkeys(scan_kernel.PLAN_KEYS, 16)


def _inputs(B, S, di, N, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)  # softplus
    b_in = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    c_in = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    x = (rng.standard_normal((B, S, di)) * 0.5).astype(np.float32)
    a_log = (rng.standard_normal((di, N)) * 0.3).astype(np.float32)
    return dt, b_in, c_in, x, a_log


@pytest.mark.parametrize("S", [1, 63, 64, 65, 191, 193])
def test_zero_filled_steps_leave_y_and_state_unchanged(S):
    """The argument for the kernel's zero-fill, on the plain version: the
    kernel runs every tile's 64 steps, and past S they are zero-filled (dt,
    x, B and C all 0), which must leave h exactly as it was."""
    B, di, N = 2, 24, 8
    args = [torch.tensor(a) for a in _inputs(B, S, di, N)]
    pad = -S % STEPS
    padded = [torch.nn.functional.pad(a, (0, 0, 0, pad)) for a in args[:4]] + [args[4]]
    y, h = ref.mamba_scan_ref(*args)
    yp, hp = ref.mamba_scan_ref(*padded)
    assert torch.equal(yp[:, :S], y) and torch.equal(hp, h)
    assert not yp[:, S:].any()


def test_empty_sequence_gives_zero_state():
    y, h = ref.mamba_scan_ref(*[torch.tensor(a) for a in _inputs(2, 0, 24, 4)])
    assert y.shape == (2, 0, 24) and h.shape == (2, 24, 4) and not h.any()


def _kernel_arithmetic(dt, b_in, c_in, x, a_log):
    """A numpy float32 model of the kernel's arithmetic: exp2 of dt *
    (-exp(A_log) * log2(e)), factors below 2^-126 flushed to 0
    (ex2.approx.ftz), dt * x formed at use, y summed state by state."""
    f32 = np.float32
    a2 = (-np.exp(a_log) * f32(1.4426950408889634)).astype(f32)
    B, S, di = dt.shape
    h = np.zeros((B, di, a_log.shape[1]), f32)
    y = np.zeros((B, S, di), f32)
    for t in range(S):
        e = np.exp2(dt[:, t, :, None] * a2[None]).astype(f32)
        e[e < f32(2.0 ** -126)] = 0
        h = e * h + (dt[:, t] * x[:, t])[..., None] * b_in[:, t, None, :]
        y[:, t] = (h * c_in[:, t, None, :]).sum(-1)
    return y, h


def test_flushed_exp2_of_prescaled_a_is_within_tolerance():
    """The argument for the kernel's bare exponential, on a numpy model of
    its arithmetic: large steps (dt up to ~20) make factors far below 2^-126
    that ex2.approx.ftz flushes to 0; y and the state stay within the
    tolerance of the plain version."""
    B, S, di, N = 2, 48, 16, 16
    dt, b_in, c_in, x, a_log = _inputs(B, S, di, N)
    dt = (dt * 6).astype(np.float32)
    a_log = (a_log + 1.5).astype(np.float32)
    got = _kernel_arithmetic(dt, b_in, c_in, x, a_log)
    want = ref.mamba_scan_ref(*map(torch.tensor, (dt, b_in, c_in, x, a_log)))
    assert (np.exp2(dt[..., None] * -np.exp(a_log) * 1.4427) < 2.0 ** -126).any()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), atol=SCAN_TOL * max(1.0, float(w.abs().max())))


def _jax_last_state(dt, b_in, x, a_log):
    """h_{S-1} as the JAX model computes a lane's state after a full forward
    (``model._mamba_state_from_full``): the chunked scan of a = exp(dt A),
    b = dt x B."""
    dt, b_in, x = (jnp.asarray(v) for v in (dt, b_in, x))
    a = jnp.exp(dt[..., None] * -jnp.exp(jnp.asarray(a_log))[None, None])
    b = (dt * x)[..., None] * b_in[:, :, None, :]
    h0 = jnp.zeros(a.shape[:1] + a.shape[2:], jnp.float32)
    return np.asarray(j_scan_chunked(a, b, h0)[1])


@pytest.mark.parametrize("shape", [
    (1, 1, 98, 16),
    (2, 63, 101, 4),
    (1, 64, 98, 8),
    (2, 65, 101, 32),
    (1, 191, 40, 16),
    (1, 193, 33, 8),
])
def test_plain_scan_matches_jax_oracle_at_tile_and_ring_edges(shape):
    args = _inputs(*shape)
    dt, b_in, c_in, x, a_log = args
    y, h = ref.mamba_scan_ref(*map(torch.tensor, args))
    want = np.asarray(j_scan_ref(*[jnp.asarray(a) for a in args]))
    np.testing.assert_allclose(y.numpy(), want, atol=SCAN_TOL, rtol=SCAN_TOL)
    assert h.shape == (shape[0], shape[2], shape[3])
    np.testing.assert_allclose(h.numpy(), _jax_last_state(dt, b_in, x, a_log), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
