"""The port's decode attention, paged and dense: the plain versions against the
JAX package (the Pallas kernels in interpret mode and the JAX oracles).  The
hand-written CUDA kernels are held against the plain versions in
tests/test_torch_gpu.py.

Tolerances are those of tests/test_paging.py: 1e-5 in float32 (sums taken in
another order), 2.5e-2 in bfloat16 (the oracle rounds the probabilities to
bf16 before the value product; the kernels keep them in f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.ref import decode_attention_ref as j_dense_ref
from repro.kernels.ref import paged_decode_attention_ref as j_paged_ref
from repro_torch.kernels import decode_attention as kernel
from repro_torch.kernels import ops, ref

TOL = {"float32": 1e-5, "bfloat16": 2.5e-2}
SHAPES = [
    # (B, KV, G, hd, page_size, num_pages)
    (2, 2, 2, 64, 16, 4),
    (1, 1, 4, 64, 8, 7),       # odd page count
    (3, 4, 1, 128, 32, 2),
]


def _inputs(shape, seed=0):
    B, KV, G, hd, ps, num_pages = shape
    NB = B * num_pages + 1                         # + scratch
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, hd), np.float32)
    k = rng.standard_normal((NB, ps, KV, hd), np.float32)
    v = rng.standard_normal((NB, ps, KV, hd), np.float32)
    pt = np.zeros((B, num_pages), np.int32)        # unmapped -> scratch
    vl = rng.integers(1, num_pages * ps + 1, B).astype(np.int32)
    for b in range(B):
        used = -(-int(vl[b]) // ps)
        pt[b, :used] = rng.choice(np.arange(1, NB), used, replace=False)
    return q, k, v, pt, vl


def _jax(arrays, dtype):
    q, k, v, pt, vl = arrays
    return (jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
            jnp.asarray(pt), jnp.asarray(vl))


def _torch(arrays, dtype, device="cpu"):
    q, k, v, pt, vl = arrays
    dt = getattr(torch, dtype)
    return (torch.tensor(q).to(device, dt), torch.tensor(k).to(device, dt),
            torch.tensor(v).to(device, dt), torch.tensor(pt).to(device),
            torch.tensor(vl).to(device))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().cpu().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_paged_plain_matches_pallas_and_jax_oracle(shape, dtype):
    arrays = _inputs(shape)
    out_pallas = jops.paged_decode_attention(*_jax(arrays, dtype), force_pallas=True)
    out_oracle = j_paged_ref(*_jax(arrays, dtype))
    launches = dict(kernel.launches)
    out = ops.paged_decode_attention(*_torch(arrays, dtype))
    assert kernel.launches == launches             # CPU tensors: the plain version
    assert out.dtype == getattr(torch, dtype) and out.shape == shape[:4]
    for want in (out_pallas, out_oracle):
        err = float(np.abs(_f32(out) - _f32(want)).max())
        assert err < TOL[dtype], (shape, dtype, err)


def test_paged_plain_ignores_unmapped_and_invalid_blocks():
    """Scratch garbage and slots past valid_len must not leak into the output
    (the poisoning of tests/test_paging.py), in the port as in JAX."""
    B, KV, G, hd, ps = 1, 2, 2, 64, 8
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, KV, G, hd), np.float32)
    k = rng.standard_normal((6, ps, KV, hd), np.float32)
    v = rng.standard_normal((6, ps, KV, hd), np.float32)
    pt = np.asarray([[1, 2, 0, 0]], np.int32)
    vl = np.asarray([11], np.int32)                # mid-page-2 valid boundary
    k2, v2 = k.copy(), v.copy()
    k2[0], k2[3:] = 99.0, 99.0                     # poison scratch + unused
    v2[0], v2[3:] = -99.0, -99.0
    k2[2, 3:], v2[2, 3:] = 77.0, -77.0             # poison past valid_len
    base = ops.paged_decode_attention(*_torch((q, k, v, pt, vl), "float32"))
    out = ops.paged_decode_attention(*_torch((q, k2, v2, pt, vl), "float32"))
    np.testing.assert_allclose(base.numpy(), out.numpy(), atol=1e-5)
    want = jops.paged_decode_attention(*_jax((q, k2, v2, pt, vl), "float32"),
                                       force_pallas=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_plain_matches_jax_oracle(dtype):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 2, 2, 64), np.float32)
    k = rng.standard_normal((3, 40, 2, 64), np.float32)
    v = rng.standard_normal((3, 40, 2, 64), np.float32)
    vl = np.asarray([1, 17, 40], np.int32)
    dt = getattr(torch, dtype)
    out = ref.decode_attention_ref(torch.tensor(q).to(dt), torch.tensor(k).to(dt),
                                   torch.tensor(v).to(dt), torch.tensor(vl))
    want = j_dense_ref(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                       jnp.asarray(v, dtype), jnp.asarray(vl))
    assert float(np.abs(_f32(out) - _f32(want)).max()) < TOL[dtype]


# the dense sweep of tests/test_kernels.py: (B, KV, G, hd, C), ragged C included
DENSE_SHAPES = [
    (1, 1, 1, 64, 64),
    (2, 2, 4, 64, 128),
    (1, 8, 6, 128, 1024),
    (4, 1, 1, 64, 300),
    (2, 3, 2, 128, 512),
    (1, 16, 1, 64, 700),
    (3, 4, 7, 128, 257),
]


def _dense_inputs(shape, seed=0):
    B, KV, G, hd, C = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, hd), np.float32)
    k = rng.standard_normal((B, C, KV, hd), np.float32)
    v = rng.standard_normal((B, C, KV, hd), np.float32)
    vl = rng.integers(1, C + 1, B).astype(np.int32)
    return q, k, v, vl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_dense_plain_matches_pallas_sweep(shape, dtype):
    q, k, v, vl = _dense_inputs(shape)
    jargs = [jnp.asarray(a, dtype) for a in (q, k, v)] + [jnp.asarray(vl)]
    out_pallas = decode_attention_pallas(*jargs, block_c=128, interpret=True)
    out_oracle = j_dense_ref(*jargs)
    dt = getattr(torch, dtype)
    launches = dict(kernel.launches)
    out = ops.decode_attention(*(torch.tensor(a).to(dt) for a in (q, k, v)),
                               torch.tensor(vl))
    assert kernel.launches == launches             # CPU tensors: the plain version
    assert out.dtype == dt and out.shape == shape[:4]
    for want in (out_pallas, out_oracle):
        err = float(np.abs(_f32(out) - _f32(want)).max())
        assert err < TOL[dtype], (shape, dtype, err)


def test_dense_plain_ignores_slots_past_valid_len():
    """Poison past valid_len (tests/test_kernels.py's ±99): the port's output
    is unchanged and equals the Pallas kernel's on the poisoned cache; an int
    valid_len is broadcast over the batch."""
    q, k, v, _ = _dense_inputs((2, 1, 2, 64, 256), seed=3)
    k2, v2 = k.copy(), v.copy()
    k2[:, 100:], v2[:, 100:] = 99.0, -99.0
    base = ops.decode_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), 100)
    out = ops.decode_attention(torch.tensor(q), torch.tensor(k2), torch.tensor(v2), 100)
    np.testing.assert_allclose(base.numpy(), out.numpy(), atol=1e-5)
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k2), jnp.asarray(v2),
                                   jnp.int32(100), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)
