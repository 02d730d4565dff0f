"""Tests of the hand-written CUDA kernel and of the port on the card.

Every test here is marked ``gpu`` and skips without a CUDA device (the kernel
has no CPU mode).  This file imports no JAX, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: 1e-5 in float32 (sums in another order), 2.5e-2 in bfloat16 (the
plain version rounds probabilities to bf16 before the value product).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.engine.paging import check_block_conservation
from repro_torch.engine.worker import RolloutWorker
from repro_torch.kernels import decode_attention as kernel
from repro_torch.kernels import ref
from repro_torch.models.model import init_params

pytestmark = pytest.mark.gpu
TOL = {"float32": 1e-5, "bfloat16": 2.5e-2}
SHAPES = [
    # (B, KV, G, hd, page_size, num_pages)
    (2, 2, 2, 64, 16, 4),
    (1, 1, 4, 64, 8, 7),
    (3, 4, 1, 128, 32, 2),
    (8, 8, 2, 128, 16, 128),   # the main path's: qwen3-1.7b, capacity 2048
]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _inputs(shape, dtype, seed=0, poison=False):
    B, KV, G, hd, ps, num_pages = shape
    NB = B * num_pages + 1
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, hd), np.float32)
    k = rng.standard_normal((NB, ps, KV, hd), np.float32)
    v = rng.standard_normal((NB, ps, KV, hd), np.float32)
    pt = np.zeros((B, num_pages), np.int32)
    vl = rng.integers(1, num_pages * ps + 1, B).astype(np.int32)
    free = rng.permutation(np.arange(1, NB))       # no block mapped by two lanes
    for b in range(B):
        used = -(-int(vl[b]) // ps)
        pt[b, :used], free = free[:used], free[used:]
    if poison:
        mapped = set(pt[pt > 0].tolist())
        for blk in range(NB):
            if blk not in mapped:                  # scratch block 0 and unmapped blocks
                k[blk], v[blk] = 99.0, -99.0
        for b in range(B):                         # slots past valid_len
            page, off = divmod(int(vl[b]), ps)
            if page < num_pages and off:
                k[pt[b, page], off:], v[pt[b, page], off:] = 77.0, -77.0
    dt = getattr(torch, dtype)
    return (torch.tensor(q).to("cuda", dt), torch.tensor(k).to("cuda", dt),
            torch.tensor(v).to("cuda", dt), torch.tensor(pt).cuda(), torch.tensor(vl).cuda())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_matches_plain(shape, dtype):
    _need_cuda()
    args = _inputs(shape, dtype)
    launches = kernel.launches
    out = kernel.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    err = float((out.float() - ref.paged_decode_attention_ref(*args).float()).abs().max())
    assert err < TOL[dtype], (shape, dtype, err)


@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_ignores_poisoned_scratch_and_tail(shape):
    _need_cuda()
    clean = kernel.paged_decode_attention(*_inputs(shape, "float32", seed=4))
    dirty = kernel.paged_decode_attention(*_inputs(shape, "float32", seed=4, poison=True))
    torch.cuda.synchronize()
    assert float((clean - dirty).abs().max()) < 1e-5


def test_cuda_wrapper_raises_on_unsupported_input():
    _need_cuda()
    q, k, v, pt, vl = _inputs(SHAPES[0], "float32")
    launches = kernel.launches
    with pytest.raises(TypeError):
        kernel.paged_decode_attention(q.half(), k.half(), v.half(), pt, vl)
    with pytest.raises(ValueError):                # a pool view that is not contiguous
        kernel.paged_decode_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                                      v, pt, vl)
    with pytest.raises(ValueError):
        kernel.paged_decode_attention(q, k, v, pt.cpu(), vl)
    with pytest.raises(ValueError):                # (G, hd) not built
        kernel.paged_decode_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                      v[..., :48].contiguous(), pt, vl)
    assert kernel.launches == launches


def _scenario(device, cfg, params):
    kw = dict(capacity=64, max_slots=4, page_size=8, chunk_size=8, device=device)
    w0, w1 = (RolloutWorker(cfg, params, worker_id=i, **kw) for i in (0, 1))
    prompt = [3 + i for i in range(20)]
    out = []
    w0.prefill(1, prompt)
    w0.prefill(2, prompt)
    out.append(w0.decode([1, 2], 5))
    w0.extend(1, [101, 102, 103, 104, 105])
    w0.preempt(2)
    out.append(w0.decode([1], 3))
    out.append(w0.decode([2], 3))
    w1.migrate_in(w0.migrate_out(2))
    out.append(w1.decode([2], 4))
    w1.migrate_in(w0.checkpoint_out(1))
    out.append((w1.decode([1], 3), w0.decode([1], 3)))
    stats = [w.dispatch_stats() for w in (w0, w1)]
    pages = [dict(w.lane_pages) for w in (w0, w1)]
    return out, stats, pages


def test_cuda_worker_matches_cpu_worker():
    """The same script on the card (the CUDA kernel in every decode step) and
    on the CPU (its plain version): tokens, block ids and counters agree.  The
    logits differ by float32 rounding (~1e-6); no draw at this seed lies that
    close to a tie."""
    _need_cuda()
    cfg = get_config("qwen3_1_7b").reduced(n_periods=2)
    params = init_params(cfg, seed=0, device="cpu")
    cpu_out, cpu_stats, cpu_pages = _scenario("cpu", cfg, params)
    launches = kernel.launches
    gpu_out, gpu_stats, gpu_pages = _scenario("cuda", cfg, params)
    assert kernel.launches - launches == \
        cfg.n_layers * sum(s["decode_steps"] for s in gpu_stats)
    timing = {"decode_wall_s"}
    for c, g in zip(cpu_stats, gpu_stats):
        assert {k: v for k, v in g.items() if k not in timing} == \
            {k: v for k, v in c.items() if k not in timing}
        assert check_block_conservation(g) == []
    assert gpu_pages == cpu_pages
    assert gpu_out[-1][0] == gpu_out[-1][1]        # restored lane == its source
    assert gpu_out == cpu_out
