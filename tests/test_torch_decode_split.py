"""The split over the sequence of the decode-attention kernels, on the CPU.

``_split_plan`` decides from the shapes alone how the hand-written kernels cut
a lane's token slots into pieces, one thread block each; the kernels
themselves run only on the card (tests/test_torch_gpu.py holds them against
the plain versions at the same edges).  Here: the plan covers every slot
exactly once, its pieces are whole pages and whole 64-token tiles, it stays
within ``MAX_SPLITS``, and it is the stated plan at the main paths' shapes;
and the plain versions agree with the JAX package's oracles at the lengths
where a piece begins or ends, within 1e-5 in float32 (sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import decode_attention_ref as j_dense_ref
from repro.kernels.ref import paged_decode_attention_ref as j_paged_ref
from repro_torch.kernels import decode_attention as kernel
from repro_torch.kernels import ref

H100_SMS = 132
# (B, KV, C, page_size) -> (L, n_split) on 132 SMs: the sliding-window ring
# (4 lanes x 8,192), the paged pool (8 lanes x 128 pages of 16) and the dense
# pool (8 lanes x 2,048), qwen3-1.7b's 8 KV heads; 512 blocks each
MAIN_PLANS = {
    "ring": ((4, 8, 8192, 1), (512, 16)),
    "paged": ((8, 8, 2048, 16), (256, 8)),
    "dense": ((8, 8, 2048, 1), (256, 8)),
}


def _pieces(L, n_split, C):
    return [(s * L, min((s + 1) * L, C)) for s in range(n_split)]


@pytest.mark.parametrize("sms", [1, 8, 78, 132])
@pytest.mark.parametrize("page_size", [1, 8, 16, 32, 48])
def test_split_plan_covers_every_slot_once(page_size, sms):
    for B in (1, 2, 3, 8, 64, 300):
        for KV in (1, 2, 8):
            for num_pages in (1, 2, 3, 5, 64, 128, 512, 2048):
                C = num_pages * page_size
                L, n_split = kernel._split_plan(B, KV, C, page_size, sms)
                assert L % 64 == 0 and L % page_size == 0, (B, KV, C, L)
                assert 1 <= n_split <= kernel.MAX_SPLITS
                seen = np.zeros(C, np.int64)
                for lo, hi in _pieces(L, n_split, C):
                    assert lo < hi                 # no piece starts at or past C
                    seen[lo:hi] += 1
                assert (seen == 1).all(), (B, KV, C, page_size, sms, L, n_split)


def test_split_plan_spreads_small_batches_and_keeps_large_ones_whole():
    """About four blocks an SM while the batch is small; one piece once
    B x KV heads alone fill the card, or where C is one tile."""
    assert kernel._split_plan(1, 1, 32768, 1, H100_SMS) == (512, 64)     # capped at 64
    assert kernel._split_plan(66, 8, 8192, 1, H100_SMS) == (8192, 1)     # 528 heads
    assert kernel._split_plan(4, 8, 64, 1, H100_SMS) == (64, 1)          # one tile
    assert kernel._split_plan(2, 1, 48, 48, H100_SMS) == (192, 1)        # lcm(64, 48)
    assert kernel._split_plan(0, 8, 2048, 1, H100_SMS)[1] >= 1           # empty batch


@pytest.mark.parametrize("shape", list(MAIN_PLANS))
def test_split_plan_at_the_main_shapes(shape):
    (B, KV, C, ps), want = MAIN_PLANS[shape]
    L, n_split = kernel._split_plan(B, KV, C, ps, H100_SMS)
    assert (L, n_split) == want
    assert B * KV * n_split == 512


# (B, KV, C) -> (L, n_split, the last piece's slots) on 132 SMs: the dense
# kernel's cross-attention calls on a tensor-parallel shard, every slot valid:
# whisper's 1,500 frames at KV 16 over 2 and 4 shards, the VLM's 1,600
# patches at KV 8 over 2 and 4
CROSS_SHARD_PLANS = {
    "whisper-kv8": ((8, 8, 1500), (192, 8, 156)),
    "whisper-kv4": ((8, 4, 1500), (128, 12, 92)),
    "vlm-kv4": ((8, 4, 1600), (128, 13, 64)),
    "vlm-kv2": ((8, 2, 1600), (64, 25, 64)),
}


@pytest.mark.parametrize("shape", list(CROSS_SHARD_PLANS))
def test_split_plan_at_the_cross_shard_shapes(shape):
    """Fewer kv heads a shard spread each lane over more pieces: between 384
    and 512 blocks, every slot once, whisper's last piece and its last tile
    ragged."""
    (B, KV, C), (L, n, last) = CROSS_SHARD_PLANS[shape]
    assert kernel._split_plan(B, KV, C, 1, H100_SMS) == (L, n)
    pieces = _pieces(L, n, C)
    assert pieces[-1][1] - pieces[-1][0] == last and pieces[-1][1] == C
    assert sum(hi - lo for lo, hi in pieces) == C and 384 <= B * KV * n <= 512


def _boundary_lengths(shape):
    (B, KV, C, ps), (L, _) = MAIN_PLANS[shape]
    return {"1": 1, "L-1": L - 1, "L": L, "L+1": L + 1, "C": C}


# the main shapes with fewer lanes and KV heads: the lengths are what matter
G, HD = 2, 128


@pytest.mark.parametrize("length", ["1", "L-1", "L", "L+1", "C"])
@pytest.mark.parametrize("shape", ["ring", "dense"])
def test_dense_plain_matches_jax_at_split_boundaries(shape, length):
    (_, _, C, _), _ = MAIN_PLANS[shape]
    n = _boundary_lengths(shape)[length]
    B, KV = 2, 2
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, KV, G, HD), np.float32)
    k = rng.standard_normal((B, C, KV, HD), np.float32)
    v = rng.standard_normal((B, C, KV, HD), np.float32)
    vl = np.array([n, max(1, n - 1)], np.int32)
    got = ref.decode_attention_ref(*(torch.tensor(x) for x in (q, k, v, vl)))
    want = np.asarray(j_dense_ref(*(jnp.asarray(x) for x in (q, k, v, vl))))
    assert got.dtype == torch.float32 and got.shape == (B, KV, G, HD)
    err = float(np.abs(got.numpy() - want).max())
    assert err < 1e-5, (shape, length, err)


@pytest.mark.parametrize("length", ["1", "L-1", "L", "L+1", "C"])
def test_paged_plain_matches_jax_at_split_boundaries(length):
    (_, _, C, ps), _ = MAIN_PLANS["paged"]
    n = _boundary_lengths("paged")[length]
    B, KV, num_pages = 2, 2, C // ps
    NB = B * num_pages + 1                         # + scratch block 0
    rng = np.random.default_rng(12)
    q = rng.standard_normal((B, KV, G, HD), np.float32)
    k = rng.standard_normal((NB, ps, KV, HD), np.float32)
    v = rng.standard_normal((NB, ps, KV, HD), np.float32)
    vl = np.array([n, max(1, n - ps)], np.int32)
    pt = np.zeros((B, num_pages), np.int32)        # unmapped -> scratch
    free = rng.permutation(np.arange(1, NB))
    for b in range(B):
        used = -(-int(vl[b]) // ps)
        pt[b, :used], free = free[:used], free[used:]
    got = ref.paged_decode_attention_ref(*(torch.tensor(x) for x in (q, k, v, pt, vl)))
    want = np.asarray(j_paged_ref(*(jnp.asarray(x) for x in (q, k, v, pt, vl))))
    err = float(np.abs(got.numpy() - want).max())
    assert err < 1e-5, (length, err)
