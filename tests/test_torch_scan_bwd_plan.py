"""The selective scan's backward kernel: its copy widths, its scratch and
the zero-fill it rests on, on the CPU.

``mamba_scan._scan_bwd_plan`` chooses from the shapes and addresses alone
the copy width of each operand into the backward kernel's shared-memory tile
ring (dt, x, B, C, g_y) and out of it (d_dt, d_x), and the wrapper passes
that choice to the kernel.  Here: every width divides its address and row
stride and is the widest that does, plain loads only where a bf16 row is
not 4-byte aligned, and the plan at the main path's shape is 16-byte copies
throughout.  ``bwd_scratch_bytes`` against the kernel's scratch layout.
Then the arithmetic argument the kernel's design rests on, shown on the
plain backward (the kernel itself runs only on the card, where
``tests/test_torch_gpu.py`` holds it to the plain backward): zero steps
(dt = x = g_y = 0, B = C = 0) past S, which the kernel runs in the ragged
last tile, and zero channels past di, which it runs in the last channel
tile, leave every gradient of the real steps and channels and dA_log as
they were (within 1e-6 of max(1, max |gradient|)).  Last, the plain backward against ``jax.vjp`` of
the JAX package's sequential scan where the ring wraps (S = 3 tiles + 1) at
every built N, within 1e-5 of max(1, max |reference|) in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import mamba_scan_ref as jax_scan_ref
from repro_torch.kernels import mamba_scan as scan_kernel
from repro_torch.kernels import ref

plan = scan_kernel._scan_bwd_plan
KEYS = scan_kernel.BWD_PLAN_KEYS
STATE_DIMS = (4, 8, 16, 32)
ZERO_TOL = 1e-6
TOL = 1e-5


def _strides(S, di, N, item):
    """Row strides in bytes by plan key."""
    return {"w_dt": 4 * di, "w_x": item * di, "w_b": item * S * N, "w_c": item * S * N,
            "w_gy": 4 * di, "w_ddt": 4 * di, "w_dx": item * di}


def _items(item):
    return {"w_dt": 4, "w_x": item, "w_b": item, "w_c": item, "w_gy": 4, "w_ddt": 4,
            "w_dx": item}


@pytest.mark.parametrize("item", [2, 4])
@pytest.mark.parametrize("di", [98, 101, 96, 8192])
def test_bwd_copy_widths_divide_address_and_stride_and_are_the_widest(di, item):
    S, N = 33, 16
    base = 1 << 20
    for k in range(8):                         # element-aligned addresses, 0..7 elements in
        f32, it = base + 4 * k, base + item * k
        addr = {"w_dt": f32, "w_b": it, "w_c": base + item * (7 - k), "w_x": it,
                "w_gy": base + 4 * (7 - k), "w_ddt": f32, "w_dx": base + item * (k // 2)}
        p = plan(S, di, N, item, tuple(addr[key] for key in
                                       ("w_dt", "w_b", "w_c", "w_x", "w_gy", "w_ddt", "w_dx")))
        strides, items = _strides(S, di, N, item), _items(item)
        assert set(p) == set(KEYS)
        for key in KEYS:
            w, a = p[key], addr[key] | strides[key]
            assert w in (2, 4, 8, 16) and w >= items[key], (key, w)
            if w < 4:                          # plain loads: a bf16 row, 2-byte aligned
                assert items[key] == 2 and a % 4, (key, k)
                continue
            assert a % w == 0, (key, w, k)
            if w < 16:                         # and no wider copy would do
                assert a % (2 * w), (key, w, k)


@pytest.mark.parametrize("item", [2, 4])
def test_bwd_plan_at_the_main_shape(item):
    """One 2,048-token jamba admission (B 1, di 8,192, N 16), every tensor
    fresh from the allocator (512-byte aligned): 16-byte copies throughout."""
    ptrs = (512, 1024, 1536, 2048, 2560, 3072, 3584)
    assert plan(2048, 8192, 16, item, ptrs) == dict.fromkeys(KEYS, 16)


def test_bwd_plan_plain_loads_only_where_a_bf16_row_is_not_4_byte_aligned():
    aligned = (0,) * 7
    p = plan(64, 101, 16, 2, aligned)                     # odd di in bf16
    assert p["w_x"] == 2 == p["w_dx"] and p["w_dt"] == p["w_gy"] == p["w_ddt"] == 4
    assert plan(64, 98, 16, 2, aligned)["w_dx"] == 4       # 196-byte rows
    assert plan(64, 101, 16, 4, aligned)["w_dx"] == 4      # f32 rows: 4-byte copies
    assert plan(3, 96, 4, 2, aligned)["w_b"] == 8          # B rows of a batch row: 24 bytes


@pytest.mark.parametrize("N", STATE_DIMS)
def test_bwd_tile_keeps_the_states_within_64_kb(N):
    """32 steps a tile, 16 at N 32: a tile's states (tile x 128 threads x N /
    4 floats) take at most 64 KB of shared memory, and a tile is whole groups
    of 8 steps."""
    tile = scan_kernel.bwd_tile(N)
    assert tile == (16 if N == 32 else 32)
    assert tile * 128 * (N // 4) * 4 <= 64 * 1024 and tile % 8 == 0


@pytest.mark.parametrize("shape", [(1, 2048, 8192, 16), (2, 70, 100, 16), (1, 33, 40, 4),
                                   (3, 17, 64, 32), (2, 0, 98, 8)])
def test_bwd_scratch_bytes_is_the_kernel_layout(shape):
    """hs (B, tiles, di, N), pb and pc (B, channel tiles of 32, S, N) and pa
    (B, di, N), all f32."""
    B, S, di, N = shape
    tiles = -(-S // scan_kernel.bwd_tile(N))
    layout = {"hs": B * tiles * di * N, "pb": B * -(-di // 32) * S * N,
              "pc": B * -(-di // 32) * S * N, "pa": B * di * N}
    assert scan_kernel.bwd_scratch_bytes(B, S, di, N) == 4 * sum(layout.values())


def test_bwd_scratch_at_the_main_shape():
    """101.2 MB at one jamba admission: hs 33.5, the partials 67.1, pa 0.5."""
    assert scan_kernel.bwd_scratch_bytes(1, 2048, 8192, 16) == 101_187_584


def _inputs(B, S, di, N, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)  # softplus
    b_in, c_in = ((0.5 * rng.standard_normal((B, S, N))).astype(np.float32) for _ in "bc")
    x = (0.5 * rng.standard_normal((B, S, di))).astype(np.float32)
    a_log = (0.3 * rng.standard_normal((di, N))).astype(np.float32)
    g_y = rng.standard_normal((B, S, di)).astype(np.float32)
    g_h = rng.standard_normal((B, di, N)).astype(np.float32)
    return [torch.tensor(t) for t in (dt, b_in, c_in, x, a_log, g_y, g_h)]


def _close(got, want, label):
    """Within 1e-6 of max(1, max |want|): with zero channels the sums over
    channels (dB, dC) run over a wider axis, in another order."""
    assert got.shape == want.shape and want.numel(), label
    limit = ZERO_TOL * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= limit, label


def _edges(N):
    tile = scan_kernel.bwd_tile(N)
    return [(N, S) for S in (1, tile - 1, tile + 1, 3 * tile - 1)]


@pytest.mark.parametrize("N,S", [e for N in STATE_DIMS for e in _edges(N)])
def test_zero_steps_past_s_leave_the_gradients_unchanged(N, S):
    """The ragged last tile: steps with dt = x = g_y = 0 and B = C = 0 up to
    the next tile's end (and a whole tile more) carry lambda and the state
    through unchanged (a = 1, u = 0), so every gradient of the first S steps
    and dA_log stay as they were, and the zero steps' dB, dC and dx are 0."""
    B, di = 2, 40
    dt, b_in, c_in, x, a_log, g_y, g_h = _inputs(B, S, di, N, seed=S)
    pad = -S % scan_kernel.bwd_tile(N) + scan_kernel.bwd_tile(N)
    padded = [torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (dt, b_in, c_in, x, g_y)]
    want = ref.mamba_scan_bwd_ref(dt, b_in, c_in, x, a_log, g_y, g_h)
    got = ref.mamba_scan_bwd_ref(*padded[:4], a_log, padded[4], g_h)
    for name, g, w in zip(("d_dt", "d_b", "d_c", "d_x"), got[:4], want[:4]):
        _close(g[:, :S], w, (name, N, S))
    _close(got[4], want[4], ("d_alog", N, S))
    for name, g in zip(("d_b", "d_c", "d_x"), got[1:4]):
        assert not g[:, S:].any(), name


@pytest.mark.parametrize("N", STATE_DIMS)
def test_zero_channels_past_di_leave_the_gradients_unchanged(N):
    """The last channel tile: channels with dt = x = g_y = 0 and g_h = 0 keep
    lambda and the state at 0 whatever their A, so dB, dC and the real
    channels' gradients stay as they were and their own d_dt, dx and dA_log
    are 0."""
    B, S, di, extra = 2, 45, 37, 27
    dt, b_in, c_in, x, a_log, g_y, g_h = _inputs(B, S, di, N, seed=N)
    wide = [torch.nn.functional.pad(t, (0, extra)) for t in (dt, x, g_y)]
    a_wide = torch.cat([a_log, 0.3 * torch.ones((extra, N))])
    gh_wide = torch.nn.functional.pad(g_h, (0, 0, 0, extra))
    want = ref.mamba_scan_bwd_ref(dt, b_in, c_in, x, a_log, g_y, g_h)
    got = ref.mamba_scan_bwd_ref(wide[0], b_in, c_in, wide[1], a_wide, wide[2], gh_wide)
    _close(got[0][..., :di], want[0], "d_dt")
    _close(got[1], want[1], "d_b")
    _close(got[2], want[2], "d_c")
    _close(got[3][..., :di], want[3], "d_x")
    _close(got[4][:di], want[4], "d_alog")
    assert not got[0][..., di:].any() and not got[3][..., di:].any()
    assert not got[4][di:].any()


@pytest.mark.parametrize("N", STATE_DIMS)
def test_plain_backward_matches_jax_vjp_where_the_ring_wraps(N):
    """The CPU path of ``mamba_scan_bwd`` at S = 3 tiles + 1 (the ring's
    three slots, then a ragged tile) against ``jax.vjp`` of the JAX
    sequential scan, with y's cotangent drawn."""
    S, di = 3 * scan_kernel.bwd_tile(N) + 1, 40
    dt, b_in, c_in, x, a_log, g_y, _ = _inputs(1, S, di, N, seed=3)
    got = scan_kernel.mamba_scan_bwd(dt, b_in, c_in, x, a_log, g_y, None)
    _, vjp = jax.vjp(jax_scan_ref, *(jnp.asarray(t.numpy()) for t in (dt, b_in, c_in, x, a_log)))
    for name, g, w in zip(("d_dt", "d_b", "d_c", "d_x", "d_alog"), got,
                          vjp(jnp.asarray(g_y.numpy()))):
        w = np.asarray(w)
        assert float((g - torch.tensor(w)).abs().max()) <= TOL * max(1.0, float(np.abs(w).max())), \
            (name, N)
