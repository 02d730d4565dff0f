"""Tests of the hand-written CUDA kernels and of the port on the card.

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernels have no CPU mode).  This file imports no JAX, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: 1e-5 in float32 (sums in another order), 2.5e-2 in bfloat16 (the
plain version rounds probabilities to bf16 before the value product).  The
selective scan is held at 1e-4 of max(1, max |reference|): both versions
compute in f32 from the same inputs, and differ by the kernel's exp2 of a
pre-scaled A and its fused multiply-adds, compounded over the sequence.
Its backward is held the same way against the plain backward computed in
f32; the gradients it returns in bf16 (dB, dC, dx) also within half a bf16
ulp of each value, the rounding of their cast.
"""

import numpy as np
import pytest
import torch

from _torch_hold import hold_bf16_cast, load_chip_smoke, load_example
from repro_torch.configs import get_config
from repro_torch.engine.paging import check_block_conservation
from repro_torch.engine.worker import RolloutWorker
from repro_torch.kernels import decode_attention as kernel
from repro_torch.kernels import mamba_scan as scan_kernel
from repro_torch.kernels import ref
from repro_torch.models.model import init_params, tree_leaves, tree_to

pytestmark = pytest.mark.gpu
TOL = {"float32": 1e-5, "bfloat16": 2.5e-2}
BF16_REL = 2e-2     # the split cases also hold bf16 to this share of max |plain|


def _split_limit(dtype, want):
    """TOL, and in bf16 also relative to the output's size, as chip_smoke.py
    holds it: outputs averaged over thousands of tokens are small."""
    if dtype == "float32":
        return TOL[dtype]
    return min(TOL[dtype], BF16_REL * float(want.float().abs().max()))
SHAPES = [
    # (B, KV, G, hd, page_size, num_pages)
    (2, 2, 2, 64, 16, 4),
    (1, 1, 4, 64, 8, 7),
    (3, 4, 1, 128, 32, 2),
    (2, 3, 6, 128, 16, 5),     # G = 6 and 7 (nemotron 48/8, arctic 56/8)
    (1, 2, 7, 64, 16, 3),
    (2, 1, 4, 256, 8, 3),      # hd 256
    (8, 8, 2, 128, 16, 128),   # the main path's: qwen3-1.7b, capacity 2048
]
# tests/test_kernels.py's dense sweep, (B, KV, G, hd, C), plus the main path's
# shapes: qwen3-1.7b at capacity 2048 and at the sliding-window ring's 8192
DENSE_SHAPES = [
    (1, 1, 1, 64, 64),
    (2, 2, 4, 64, 128),
    (1, 8, 6, 128, 1024),
    (4, 1, 1, 64, 300),
    (2, 3, 2, 128, 512),
    (1, 16, 1, 64, 700),
    (3, 4, 7, 128, 257),
    (2, 2, 3, 256, 100),
    (8, 8, 2, 128, 2048),
    (4, 8, 2, 128, 8192),
]
# tests/test_kernels.py's scan sweep, (B, S, di, N), plus a di that leaves a
# ragged channel tile, N 32, and the main path's di and N at a ragged S; then
# the edges of the kernel's tile ring (64-step tiles, 3 in the ring): S of 0,
# 1, 63, 64, 65, 191 and 193, di of 98 and 101 (odd: bf16 rows staged with
# plain loads) and the main di 8,192 at the main S, N of 4, 8, 16 and 32
SCAN_SHAPES = [
    (2, 37, 64, 8),
    (1, 128, 128, 16),
    (3, 50, 96, 4),
    (2, 33, 64, 16),
    (2, 70, 100, 16),
    (1, 65, 64, 32),
    (1, 1500, 8192, 16),
    (2, 0, 98, 16),
    (1, 1, 101, 8),
    (2, 63, 98, 4),
    (1, 64, 101, 32),
    (3, 65, 98, 16),
    (2, 191, 101, 16),
    (1, 193, 98, 32),
    (1, 2048, 8192, 16),
]
SCAN_TOL = 1e-4


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _inputs(shape, dtype, seed=0, poison=False, lengths=None):
    B, KV, G, hd, ps, num_pages = shape
    NB = B * num_pages + 1
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, hd), np.float32)
    k = rng.standard_normal((NB, ps, KV, hd), np.float32)
    v = rng.standard_normal((NB, ps, KV, hd), np.float32)
    pt = np.zeros((B, num_pages), np.int32)
    vl = rng.integers(1, num_pages * ps + 1, B).astype(np.int32)
    if lengths is not None:
        vl = np.asarray(lengths, np.int32)
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
    launches = kernel.launches["paged_decode_attention"]
    out = kernel.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert kernel.launches["paged_decode_attention"] == launches + 1
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
    launches = dict(kernel.launches)
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


def _dense_inputs(shape, dtype, seed=0, poison=False, lengths=None):
    B, KV, G, hd, C = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, hd), np.float32)
    k = rng.standard_normal((B, C, KV, hd), np.float32)
    v = rng.standard_normal((B, C, KV, hd), np.float32)
    vl = rng.integers(1, C + 1, B).astype(np.int32)
    if lengths is not None:
        vl = np.asarray(lengths, np.int32)
    if poison:                                     # slots past valid_len: ±99
        for b in range(B):
            k[b, vl[b]:], v[b, vl[b]:] = 99.0, -99.0
    dt = getattr(torch, dtype)
    return (torch.tensor(q).to("cuda", dt), torch.tensor(k).to("cuda", dt),
            torch.tensor(v).to("cuda", dt), torch.tensor(vl).cuda())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_cuda_dense_kernel_matches_plain(shape, dtype):
    _need_cuda()
    args = _dense_inputs(shape, dtype)
    launches = kernel.launches["decode_attention"]
    out = kernel.decode_attention(*args)
    torch.cuda.synchronize()
    assert kernel.launches["decode_attention"] == launches + 1
    err = float((out.float() - ref.decode_attention_ref(*args).float()).abs().max())
    assert err < TOL[dtype], (shape, dtype, err)


@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_cuda_dense_kernel_ignores_poisoned_tail(shape):
    _need_cuda()
    clean = kernel.decode_attention(*_dense_inputs(shape, "float32", seed=4))
    dirty = kernel.decode_attention(*_dense_inputs(shape, "float32", seed=4, poison=True))
    torch.cuda.synchronize()
    assert float((clean - dirty).abs().max()) < 1e-5


def test_cuda_dense_wrapper_raises_on_unsupported_input():
    _need_cuda()
    q, k, v, vl = _dense_inputs(DENSE_SHAPES[1], "float32")
    launches = dict(kernel.launches)
    with pytest.raises(TypeError):
        kernel.decode_attention(q.half(), k.half(), v.half(), vl)
    with pytest.raises(TypeError):                 # valid_len must be int32
        kernel.decode_attention(q, k, v, vl.long())
    with pytest.raises(ValueError):                # a cache view that is not contiguous
        kernel.decode_attention(q, k.transpose(0, 1).contiguous().transpose(0, 1), v, vl)
    with pytest.raises(ValueError):
        kernel.decode_attention(q, k, v, vl.cpu())
    with pytest.raises(ValueError):                # batch of the cache does not match q
        kernel.decode_attention(q, k[:1].contiguous(), v[:1].contiguous(), vl)
    with pytest.raises(ValueError):                # (G, hd) not built: G * hd > 1024
        kernel.decode_attention(torch.zeros((1, 1, 5, 256), device="cuda"),
                                torch.zeros((1, 8, 1, 256), device="cuda"),
                                torch.zeros((1, 8, 1, 256), device="cuda"), vl[:1])
    assert kernel.launches == launches


# The split over the sequence at the main paths' shapes: every lane at one
# length that ends one token into the first piece, on either side of the first
# piece's end, or at C (most pieces empty, or a piece ending on a page or tile
# boundary).  L is the wrapper's piece length on this card.
SPLIT_SHAPES = {
    "paged": (8, 8, 2, 128, 16, 128),   # (B, KV, G, hd, page_size, num_pages)
    "dense": (8, 8, 2, 128, 2048),      # (B, KV, G, hd, C)
    "ring": (4, 8, 2, 128, 8192),
}
SPLIT_LENGTHS = ["1", "L-1", "L", "L+1", "C"]


def _split_call(kind, dtype, lengths, poison, seed=5):
    """(kernel output, plain output, launches of the call) for SPLIT_SHAPES[kind]."""
    shape = SPLIT_SHAPES[kind]
    name = "paged_decode_attention" if kind == "paged" else "decode_attention"
    if kind == "paged":
        args = _inputs(shape, dtype, seed=seed, poison=poison, lengths=lengths)
        fn, plain = kernel.paged_decode_attention, ref.paged_decode_attention_ref
    else:
        args = _dense_inputs(shape, dtype, seed=seed, poison=poison, lengths=lengths)
        fn, plain = kernel.decode_attention, ref.decode_attention_ref
    before = kernel.launches[name]
    out = fn(*args)
    torch.cuda.synchronize()
    return out, plain(*args), kernel.launches[name] - before


def _split_plan(kind):
    B, KV = SPLIT_SHAPES[kind][:2]
    C, ps = ((SPLIT_SHAPES[kind][4] * SPLIT_SHAPES[kind][5], SPLIT_SHAPES[kind][4])
             if kind == "paged" else (SPLIT_SHAPES[kind][4], 1))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return kernel._split_plan(B, KV, C, ps, sms), C


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", SPLIT_LENGTHS)
@pytest.mark.parametrize("kind", list(SPLIT_SHAPES))
def test_cuda_split_edges_match_plain(kind, length, dtype):
    """Both kernels at the split's edges, on clean and poisoned caches (the
    slots past valid_len, and for the paged kernel scratch and unmapped
    blocks, hold +-77 or +-99): one launch a call, within ``_split_limit``
    of the plain version."""
    _need_cuda()
    (L, n_split), C = _split_plan(kind)
    assert n_split > 1
    n = {"1": 1, "L-1": L - 1, "L": L, "L+1": L + 1, "C": C}[length]
    lengths = [n] * SPLIT_SHAPES[kind][0]
    for poison in (False, True):
        out, want, launched = _split_call(kind, dtype, lengths, poison)
        assert launched == 1
        err = float((out.float() - want.float()).abs().max())
        assert err < _split_limit(dtype, want), (kind, length, dtype, poison, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_split_single_page_lanes_match_plain(dtype):
    """Paged lanes of one page: a pool of one-page lanes (one piece), and at
    the main shape lanes of one page beside lanes across pieces."""
    _need_cuda()
    (L, _), C = _split_plan("paged")
    ps = SPLIT_SHAPES["paged"][4]
    for shape, lengths in (((3, 2, 4, 64, 16, 1), [1, 16, 9]),
                           (SPLIT_SHAPES["paged"], [ps, 1, C, ps + 1, L, L - 1, L + 1, 2 * ps])):
        for poison in (False, True):
            args = _inputs(shape, dtype, seed=6, poison=poison, lengths=lengths)
            before = kernel.launches["paged_decode_attention"]
            out = kernel.paged_decode_attention(*args)
            torch.cuda.synchronize()
            assert kernel.launches["paged_decode_attention"] == before + 1
            want = ref.paged_decode_attention_ref(*args)
            err = float((out.float() - want.float()).abs().max())
            assert err < _split_limit(dtype, want), (shape, dtype, poison, err)


def test_cuda_split_counters_reset_and_grow():
    """Three split calls in a row on each kernel leave the stream's counters
    at 0; a call with more (lane, KV head) pairs than the buffer holds grows
    it, and is right."""
    _need_cuda()
    key = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    calls = [(kernel.decode_attention, ref.decode_attention_ref, "decode_attention",
              _dense_inputs((2, 2, 2, 128, 1024), "float32", seed=s)) for s in range(3)]
    calls += [(kernel.paged_decode_attention, ref.paged_decode_attention_ref,
               "paged_decode_attention", _inputs((2, 2, 2, 128, 16, 64), "float32", seed=s))
              for s in range(3)]
    for fn, plain, name, args in calls:
        before = kernel.launches[name]
        out = fn(*args)
        torch.cuda.synchronize()
        assert kernel.launches[name] == before + 1
        assert float((out - plain(*args)).abs().max()) < TOL["float32"]
        assert int(kernel._counters[key].abs().sum()) == 0
    n0 = kernel._counters[key].numel()
    KV = 2
    B = n0 // KV + 1                               # B * KV > n0
    args = _dense_inputs((B, KV, 1, 64, 256), "float32", seed=7)
    out = kernel.decode_attention(*args)
    torch.cuda.synchronize()
    assert kernel._counters[key].numel() >= B * KV > n0
    assert int(kernel._counters[key].abs().sum()) == 0
    assert float((out - ref.decode_attention_ref(*args)).abs().max()) < TOL["float32"]


def test_cuda_empty_batch_returns_empty():
    """No lanes: each kernel returns an empty (0, KV, G, hd) output, though
    the plan splits the (absent) lanes' slots."""
    _need_cuda()
    q, k, v, vl = _dense_inputs((1, 2, 2, 128, 512), "bfloat16")
    out = kernel.decode_attention(q[:0], k[:0], v[:0], vl[:0])
    q, k, v, pt, vl = _inputs((1, 2, 2, 128, 16, 32), "bfloat16")
    paged = kernel.paged_decode_attention(q[:0], k, v, pt[:0], vl[:0])
    torch.cuda.synchronize()
    assert out.shape == paged.shape == (0, 2, 2, 128)


def _scan_inputs(shape, dtype, seed=0):
    """dt, a_log in f32; B, C, x in ``dtype`` (the model's path: bf16)."""
    B, S, di, N = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn((B, S, di), generator=gen, device="cuda"))
    b_in, c_in = (0.5 * torch.randn((B, S, N), generator=gen, device="cuda") for _ in "bc")
    x = 0.5 * torch.randn((B, S, di), generator=gen, device="cuda")
    a_log = 0.3 * torch.randn((di, N), generator=gen, device="cuda")
    dt_ = getattr(torch, dtype)
    return dt, b_in.to(dt_), c_in.to(dt_), x.to(dt_), a_log


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_cuda_scan_matches_plain(shape, dtype):
    _need_cuda()
    args = _scan_inputs(shape, dtype)
    before = scan_kernel.launches["mamba_scan"]
    y, h = scan_kernel.mamba_scan(*args)
    torch.cuda.synchronize()
    assert scan_kernel.launches["mamba_scan"] == before + 1
    _check_scan(y, h, args, (shape, dtype))


def _check_scan(y, h, args, label):
    want_y, want_h = ref.mamba_scan_ref(*args)
    for got, want in ((y, want_y), (h, want_h)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert bool(got.isfinite().all()), label
        if want.numel():
            limit = SCAN_TOL * max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
            assert err < limit, (label, err, limit)


def _offset(t, n):
    """A contiguous copy of t that starts n elements into a fresh buffer."""
    buf = torch.empty(t.numel() + n, dtype=t.dtype, device=t.device)
    out = buf[n:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_cuda_scan_unaligned_inputs_match_plain(n, dtype):
    """Inputs that start 1-3 elements into their buffers: narrower copies, and
    in bf16 plain loads (2-byte aligned rows), as the plan says."""
    _need_cuda()
    args = _scan_inputs((2, 130, 96, 16), dtype)
    args = tuple(_offset(t, n) for t in args[:4]) + args[4:]
    y, h = scan_kernel.mamba_scan(*args)
    torch.cuda.synchronize()
    widths = scan_kernel._scan_plan(130, 96, 16, args[1].element_size(),
                                    [t.data_ptr() for t in (*args[:4], y)])
    assert widths["w_x"] < 16 and widths["w_b"] < 16
    _check_scan(y, h, args, (n, dtype))


def test_cuda_scan_refuses_a_copy_wider_than_the_alignment():
    """The source launches nothing when a copy width passed in does not
    divide its operand's address and row stride."""
    from repro_torch.kernels.build import KERNELS
    _need_cuda()
    B, S, di, N = 1, 9, 64, 16
    dt, b_in, c_in, x, a_log = _scan_inputs((B, S, di, N), "bfloat16")
    x = _offset(x, 1)                                # 2 bytes into its buffer
    y = torch.zeros((B, S, di), device="cuda")
    h = torch.zeros((B, di, N), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    err = KERNELS.function("mamba_scan_bf16", 7, 9)(
        *(t.data_ptr() for t in (dt, b_in, c_in, x, a_log, y, h)), B, S, di, N,
        16, 16, 16, 16, 16, stream)
    torch.cuda.synchronize()
    assert err != 0 and not y.any() and not h.any()


def test_cuda_scan_wrapper_raises_on_unsupported_input():
    _need_cuda()
    dt, b_in, c_in, x, a_log = _scan_inputs((1, 9, 64, 16), "bfloat16")
    launches = dict(scan_kernel.launches)
    with pytest.raises(TypeError):                 # dt must be f32
        scan_kernel.mamba_scan(dt.bfloat16(), b_in, c_in, x, a_log)
    with pytest.raises(TypeError):                 # x, B, C in one dtype
        scan_kernel.mamba_scan(dt, b_in.float(), c_in, x, a_log)
    with pytest.raises(ValueError):                # a column slice: not contiguous
        scan_kernel.mamba_scan(dt, torch.cat([b_in, c_in], -1)[..., :16], c_in, x, a_log)
    with pytest.raises(ValueError):                # on another device
        scan_kernel.mamba_scan(dt, b_in, c_in, x, a_log.cpu())
    with pytest.raises(ValueError):                # N = 12 not built
        scan_kernel.mamba_scan(dt, b_in[..., :12].contiguous(), c_in[..., :12].contiguous(),
                               x, a_log[:, :12].contiguous())
    assert scan_kernel.launches == launches


def _scenario(device, cfg, params, **plane):
    kw = dict(capacity=64, max_slots=4, page_size=8, chunk_size=8, device=device)
    kw.update(plane)
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
    launches = kernel.launches["paged_decode_attention"]
    gpu_out, gpu_stats, gpu_pages = _scenario("cuda", cfg, params)
    assert kernel.launches["paged_decode_attention"] - launches == \
        cfg.n_layers * sum(s["decode_steps"] for s in gpu_stats)
    timing = {"decode_wall_s"}
    for c, g in zip(cpu_stats, gpu_stats):
        assert {k: v for k, v in g.items() if k not in timing} == \
            {k: v for k, v in c.items() if k not in timing}
        assert check_block_conservation(g) == []
    assert gpu_pages == cpu_pages
    assert gpu_out[-1][0] == gpu_out[-1][1]        # restored lane == its source
    assert gpu_out == cpu_out


@pytest.mark.parametrize("window", [0, 16], ids=["dense", "sliding-window"])
def test_cuda_dense_worker_matches_cpu_worker(window):
    """The same script on the dense plane, card against CPU: a linear dense
    pool (``paged=False``; chunked admission and extend, lane reuse) and a
    sliding-window ring (full-sequence admission that wraps the ring,
    per-token extend).  Every decode step and every per-token extend step
    runs the dense kernel once per layer; tokens and counters agree."""
    _need_cuda()
    cfg = get_config("qwen3_1_7b").reduced(n_periods=2).with_sliding_window(window)
    params = init_params(cfg, seed=0, device="cpu")
    plane = dict(paged=False, capacity=window or 64)   # a ring of the window's size
    cpu_out, cpu_stats, _ = _scenario("cpu", cfg, params, **plane)
    launches = dict(kernel.launches)
    gpu_out, gpu_stats, _ = _scenario("cuda", cfg, params, **plane)
    steps = sum(s["decode_steps"] for s in gpu_stats)
    if window:                                     # extend is per token there
        steps += sum(s["absorbed_tokens"] for s in gpu_stats)
    assert kernel.launches["decode_attention"] - launches["decode_attention"] == \
        cfg.n_layers * steps
    assert kernel.launches["paged_decode_attention"] == launches["paged_decode_attention"]
    timing = {"decode_wall_s"}
    for c, g in zip(cpu_stats, gpu_stats):
        assert {k: v for k, v in g.items() if k not in timing} == \
            {k: v for k, v in c.items() if k not in timing}
    assert gpu_out[-1][0] == gpu_out[-1][1]        # restored lane == its source
    assert gpu_out == cpu_out


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_cuda_hybrid_worker_matches_cpu_worker(paged):
    """The reduced jamba period (7 Mamba layers, 1 attention, 4 MoE) on the
    card and on the CPU: whole-prompt admission runs the scan kernel once per
    Mamba layer, every decode and per-token extend step the decode kernel
    once per attention layer; tokens and counters agree."""
    _need_cuda()
    cfg = get_config("jamba_v0_1_52b").reduced(n_periods=1)
    params = init_params(cfg, seed=0, device="cpu")
    plane = {} if paged else dict(paged=False)
    cpu_out, cpu_stats, _ = _scenario("cpu", cfg, params, **plane)
    launches = dict(kernel.launches)
    scans = scan_kernel.launches["mamba_scan"]
    gpu_out, gpu_stats, _ = _scenario("cuda", cfg, params, **plane)
    n_mamba = sum(k.startswith("mamba") for k in cfg.block_pattern)
    assert scan_kernel.launches["mamba_scan"] - scans == n_mamba * 2   # two admissions
    steps = sum(s["decode_steps"] + s["absorbed_tokens"] for s in gpu_stats)
    name = "paged_decode_attention" if paged else "decode_attention"
    assert kernel.launches[name] - launches[name] == steps      # one attention layer
    timing = {"decode_wall_s"}
    for c, g in zip(cpu_stats, gpu_stats):
        assert {k: v for k, v in g.items() if k not in timing} == \
            {k: v for k, v in c.items() if k not in timing}
    assert gpu_out == cpu_out


# The dense kernel at the cross-attention decode shapes of the audio and VLM
# models, (B, KV, G, hd, C): whisper-medium's (MHA, hd 64, 1,500 encoder
# frames: the split's last piece and its last 64-token tile are ragged) and
# llama-3.2-vision-11b's (G 4, hd 128, 1,600 image patches), at one lane and
# at 8.  Every slot is valid (valid_len = C), so the kernel reads each lane to
# its end; the cache is the first B lanes of a B + 1 lane buffer whose last
# lane is NaN, so a read past a lane's end shows.
CROSS_SHAPES = [(1, 16, 1, 64, 1500), (8, 16, 1, 64, 1500),
                (1, 8, 4, 128, 1600), (8, 8, 4, 128, 1600)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CROSS_SHAPES,
                         ids=["whisper-B1", "whisper-B8", "vlm-B1", "vlm-B8"])
def test_cuda_dense_kernel_at_cross_shapes(shape, dtype):
    _need_cuda()
    B, KV, G, hd, C = shape
    q, k, v, _ = _dense_inputs((B + 1, KV, G, hd, C), dtype, seed=7)
    k[B], v[B] = float("nan"), float("nan")
    q, k, v = q[:B].contiguous(), k[:B], v[:B]
    vl = torch.full((B,), C, dtype=torch.int32, device="cuda")
    before = kernel.launches["decode_attention"]
    out = kernel.decode_attention(q, k, v, vl)
    torch.cuda.synchronize()
    assert kernel.launches["decode_attention"] == before + 1
    want = ref.decode_attention_ref(q, k, v, vl)
    assert bool(out.isfinite().all())
    err = float((out.float() - want.float()).abs().max())
    assert err < _split_limit(dtype, want), (shape, dtype, err)


def _open_gates(tree, value=0.7):
    """Every VLM ``xgate`` set to ``value``, in place: the gate starts at 0,
    and tanh(0) = 0 would hide the cross-attention output."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _open_gates(leaf, value)
        elif name == "xgate":
            leaf.fill_(value)
    return tree


@pytest.mark.parametrize("name", ["whisper_medium", "llama_3_2_vision_11b"])
def test_cuda_cross_attention_model_matches_cpu(name):
    """The reduced audio and VLM models (f32, gates open) on the card and on
    the CPU: a full-forward admission over embeddings drawn from a seed, then
    8 teacher-forced decode steps; every step runs the dense kernel once per
    self- and once per cross-attention layer, and the logits agree within
    1e-4."""
    from repro_torch.models import model as M
    _need_cuda()
    cfg = get_config(name).reduced(n_periods=2 if name == "whisper_medium" else 1)
    params = _open_gates(init_params(cfg, seed=0, device="cpu"))
    gparams = M.tree_to(params, "cuda")
    T, key = ((cfg.encoder_seq, "encoder_embeds") if cfg.arch_type == "audio"
              else (cfg.image_seq, "image_embeds"))
    gen = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12), generator=gen),
             key: torch.randn((2, T, cfg.d_model), generator=gen)}
    caches = {dev: M.forward_full(cfg, prm, M.tree_to(batch, dev), capacity=24)[2]
              for dev, prm in (("cpu", params), ("cuda", gparams))}
    per_step = sum({"dec": 2, "attn": 1, "xattn": 1}[k.partition("+")[0]]
                   for k in cfg.block_pattern) * cfg.n_periods
    before = kernel.launches["decode_attention"]
    tok, err = torch.tensor([[1], [2]]), 0.0
    for _ in range(8):
        lc, _ = M.decode_step(cfg, params, caches["cpu"], tok)
        lg, _ = M.decode_step(cfg, gparams, caches["cuda"], tok.cuda())
        err = max(err, float((lg.cpu() - lc).abs().max()))
        tok = lc.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    assert kernel.launches["decode_attention"] - before == 8 * per_step
    assert err < 1e-4, err


# ------------------------------------------------------------------ training plane
# f32 on both sides; the card sums in another order than the CPU: outputs
# within 1e-5, gradients within 5e-5 (flash) and 1e-4 (a whole GRPO loss,
# through every layer) of max(1, max |CPU value|)

def _flash_inputs(S, T, seed, B=1, KV=2, G=2, hd=64):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen) for shape in
            ((B, KV, G, S, hd), (B, T, KV, hd), (B, T, KV, hd), (B, KV, G, S, hd))]


@pytest.mark.parametrize("S,T,window,blocks", [(100, 100, 17, (32, 48)),
                                               (33, 70, 0, (32, 48)),
                                               (2048, 2048, 0, (512, 1024)),
                                               (2048, 2048, 512, (512, 1024))])
def test_cuda_flash_forward_and_backward_match_cpu(S, T, window, blocks):
    """The flash autograd Function on the card against the CPU: output and
    dq/dk/dv, ragged blocks and the model's blocks past FLASH_THRESHOLD."""
    from repro_torch.models.flash import flash_attention
    _need_cuda()
    q, k, v, dout = _flash_inputs(S, T, S + window)
    qp, kp = torch.arange(S), torch.arange(T)
    res = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, qp.to(dev), kp.to(dev), 0.125, True, window, *blocks)
        grads = torch.autograd.grad(out, leaves, dout.to(dev))
        res[dev] = [t.detach().cpu() for t in (out, *grads)]
    for name, c, g, tol in zip(("out", "dq", "dk", "dv"), res["cpu"], res["cuda"],
                               (1e-5, 5e-5, 5e-5, 5e-5)):
        assert torch.isfinite(g).all()
        assert float((g - c).abs().max()) <= tol * max(1.0, float(c.abs().max())), name


@pytest.mark.parametrize("name", ["smollm_135m", "jamba_v0_1_52b"])
def test_cuda_grpo_gradients_match_cpu(name):
    """One reduced GRPO loss (f32, remat on) on the card and on the CPU from
    the same params and batch: loss, metrics and every gradient.  On jamba
    the card runs the scan's forward and backward kernels, the CPU their
    plain versions."""
    from repro_torch.models import model as M
    from repro_torch.rl import grpo as G
    _need_cuda()
    cfg = get_config(name).reduced(n_periods=2)
    params = init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(5, cfg.vocab, (4, 40), generator=gen, dtype=torch.int32)
    batch = {"tokens": tokens, "loss_mask": (torch.arange(40) >= 4).float().expand(4, 40),
             "advantages": torch.tensor([1.0, -1.0, 0.5, -0.5]),
             "old_logprobs": -6.0 + 0.3 * torch.randn((4, 40), generator=gen)}
    res = {}
    for dev in ("cpu", "cuda"):
        prm = M.tree_to(params, dev)
        res[dev] = G.value_and_grad(
            lambda p: G.grpo_loss(cfg, G.GRPOConfig(group_size=2), p, M.tree_to(batch, dev)),
            prm)
    (lc, mc, gc), (lg, mg, gg) = res["cpu"], res["cuda"]
    assert abs(float(lg) - float(lc)) <= 1e-5
    for k in mc:
        assert abs(float(mg[k]) - float(mc[k])) <= 1e-5, k
    for c, g in zip(M.tree_leaves(gc), M.tree_leaves(gg)):
        g = g.cpu()
        assert torch.isfinite(g).all()
        assert float((g - c).abs().max()) <= 1e-4 * max(1.0, float(c.abs().max()))


# (B, S, di, N) of the backward: S ragged against every N's tile, di masked
# (not a multiple of 32), S 0 and 1, and the main path's admission shape;
# then the edges of the kernel's reverse tile ring (tiles of
# ``mamba_scan.bwd_tile(N)`` steps, 3 in the ring) at every built N: S of 1,
# tile - 1, tile, tile + 1 and 3 tiles +- 1, at a di of 40 whose second
# channel tile is partly live; and a block whose only channel tile holds 5
# live channels
SCAN_BWD_SHAPES = [
    (1, 1, 101, 8),
    (2, 70, 100, 16),
    (1, 130, 33, 8),
    (3, 300, 98, 4),
    (1, 37, 64, 32),
    (2, 0, 98, 16),
    (1, 2048, 8192, 16),
    *((1, S, 40, N) for N in (4, 8, 16, 32) for tile in (scan_kernel.bwd_tile(N),)
      for S in (1, tile - 1, tile, tile + 1, 3 * tile - 1, 3 * tile + 1)),
    (2, 70, 5, 16),
]


def _bwd_inputs(shape, dtype, seed=0):
    args = _scan_inputs(shape, dtype, seed)
    B, S, di, N = shape
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    return args, torch.randn((B, S, di), generator=gen, device="cuda"), \
        torch.randn((B, di, N), generator=gen, device="cuda")


def _check_bwd(got, args, g_y, g_h, label):
    """Each gradient within SCAN_TOL x max(1, max |plain|) of the plain
    backward on f32 copies of the inputs; a bf16 gradient also within half a
    bf16 ulp of each value, the rounding of its cast."""
    want = ref.mamba_scan_bwd_ref(*(t.float() for t in args), g_y, g_h)
    for name, g, w, a in zip(("d_dt", "d_b", "d_c", "d_x", "d_alog"), got, want,
                             (*args[:4], args[4])):
        assert g.dtype == (torch.float32 if name in ("d_dt", "d_alog") else a.dtype)
        hold_bf16_cast(g, w, SCAN_TOL, (label, name))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SCAN_BWD_SHAPES)
def test_cuda_scan_bwd_matches_plain(shape, dtype):
    _need_cuda()
    args, g_y, g_h = _bwd_inputs(shape, dtype)
    before = scan_kernel.launches["mamba_scan_bwd"]
    got = scan_kernel.mamba_scan_bwd(*args, g_y, g_h)
    torch.cuda.synchronize()
    assert scan_kernel.launches["mamba_scan_bwd"] == before + 1
    _check_bwd(got, args, g_y, g_h, (shape, dtype))


@pytest.mark.parametrize("which", ["no_g_y", "no_g_h"])
def test_cuda_scan_bwd_takes_absent_gradients_as_zero(which):
    _need_cuda()
    args, g_y, g_h = _bwd_inputs((2, 70, 100, 16), "bfloat16")
    g_y, g_h = (None, g_h) if which == "no_g_y" else (g_y, None)
    got = scan_kernel.mamba_scan_bwd(*args, g_y, g_h)
    torch.cuda.synchronize()
    _check_bwd(got, args, g_y, g_h, which)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_cuda_scan_bwd_unaligned_inputs_match_plain(n, dtype):
    """Inputs and gradients that start 1-3 elements into their buffers."""
    _need_cuda()
    args, g_y, g_h = _bwd_inputs((2, 130, 96, 16), dtype)
    args = tuple(_offset(t, n) for t in args)
    g_y, g_h = _offset(g_y, n), _offset(g_h, n)
    got = scan_kernel.mamba_scan_bwd(*args, g_y, g_h)
    torch.cuda.synchronize()
    _check_bwd(got, args, g_y, g_h, (n, dtype))


def test_cuda_scan_bwd_is_deterministic():
    """No float atomics: two runs on the same inputs are bit-equal."""
    _need_cuda()
    args, g_y, g_h = _bwd_inputs((2, 300, 200, 16), "bfloat16")
    first = scan_kernel.mamba_scan_bwd(*args, g_y, g_h)
    second = scan_kernel.mamba_scan_bwd(*args, g_y, g_h)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_cuda_scan_bwd_refuses_a_copy_wider_than_the_alignment():
    """The source launches nothing when a copy width passed in does not
    divide its operand's address and row stride."""
    from repro_torch.kernels.build import KERNELS
    _need_cuda()
    B, S, di, N = 1, 9, 64, 16
    args, g_y, g_h = _bwd_inputs((B, S, di, N), "bfloat16")
    args = (*args[:3], _offset(args[3], 1), args[4])        # x 2 bytes into its buffer
    outs = [torch.zeros_like(t) for t in (args[0], args[1], args[2], args[3])]
    d_alog = torch.zeros_like(args[4])
    scratch = torch.zeros(scan_kernel.bwd_scratch_bytes(B, S, di, N) // 4, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    err = KERNELS.function("mamba_scan_bwd_bf16", 13, 11)(
        *(t.data_ptr() for t in (*args, g_y, g_h, *outs, d_alog, scratch)), B, S, di, N,
        *[16] * len(scan_kernel.BWD_PLAN_KEYS), stream)
    torch.cuda.synchronize()
    assert err != 0 and not any(t.any() for t in (*outs, d_alog, scratch))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_scan_bwd_keeps_two_blocks_an_sm_at_the_main_shape(dtype):
    """The shared-memory budget: at N 16 both passes leave room for two
    blocks an SM, so the main shape's 256 blocks are resident at once."""
    _need_cuda()
    occ = scan_kernel.bwd_occupancy(getattr(torch, dtype), 16)
    assert occ["kernel_blocks_per_sm"] >= 2 and occ["states_blocks_per_sm"] >= 2, occ


def test_cuda_scan_bwd_wrapper_raises_on_unsupported_input():
    _need_cuda()
    args, g_y, g_h = _bwd_inputs((1, 9, 64, 16), "bfloat16")
    launches = dict(scan_kernel.launches)
    with pytest.raises(TypeError):                 # the gradients are f32
        scan_kernel.mamba_scan_bwd(*args, g_y.bfloat16(), g_h)
    with pytest.raises(ValueError):                # g_h's shape
        scan_kernel.mamba_scan_bwd(*args, g_y, g_h[:, :32].contiguous())
    with pytest.raises(ValueError):                # not contiguous
        scan_kernel.mamba_scan_bwd(*args, g_y.transpose(1, 2).contiguous().transpose(1, 2),
                                   g_h)
    with pytest.raises(ValueError):                # on another device
        scan_kernel.mamba_scan_bwd(*args, g_y, g_h.cpu())
    assert scan_kernel.launches == launches


def test_cuda_scan_under_autograd_runs_the_backward_kernel(monkeypatch):
    """On CUDA tensors ``ops.mamba_scan`` under autograd launches the forward
    kernel once and the backward kernel once a backward, and the plain
    backward never runs; the gradients are the plain backward's."""
    from repro_torch.kernels import ops
    _need_cuda()
    args, g_y, g_h = _bwd_inputs((2, 70, 100, 16), "bfloat16")
    want_args = [t.clone() for t in args]
    plain = ref.mamba_scan_bwd_ref

    def refuse(*a, **k):
        raise AssertionError("the plain backward ran on CUDA tensors")

    monkeypatch.setattr(ref, "mamba_scan_bwd_ref", refuse)
    before = dict(scan_kernel.launches)
    for step in range(2):
        leaves = [t.clone().requires_grad_() for t in args]
        y, h = ops.mamba_scan(*leaves)
        got = torch.autograd.grad((y, h), leaves, (g_y, g_h))
        torch.cuda.synchronize()
        assert scan_kernel.launches["mamba_scan_bwd"] == before["mamba_scan_bwd"] + step + 1
        assert scan_kernel.launches["mamba_scan"] == before["mamba_scan"] + step + 1
    monkeypatch.setattr(ref, "mamba_scan_bwd_ref", plain)
    _check_bwd(got, want_args, g_y, g_h, "autograd")


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_cuda_legacy_worker_matches_cpu(temperature):
    """The legacy per-sequence worker on the card (the dense kernel in every
    decode step and every absorbed tool token) against the CPU: the same
    tokens."""
    from repro_torch.engine.legacy import LegacyRolloutWorker
    from repro_torch.engine.sampler import SamplerConfig
    _need_cuda()
    cfg = get_config("qwen3_1_7b").reduced(n_periods=2)
    params = init_params(cfg, seed=0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        w = LegacyRolloutWorker(cfg, params, capacity=64, device=dev,
                                sampler=SamplerConfig(temperature=temperature, top_p=0.9))
        before = kernel.launches["decode_attention"]
        w.prefill(1, list(range(5, 25)))
        w.prefill(2, list(range(3, 14)))
        toks = [w.decode([1, 2], 6)]
        w.extend(1, [101, 102, 103])
        toks.append(w.decode([1, 2], 5))
        out[dev] = toks
        launched = kernel.launches["decode_attention"] - before
    assert launched == cfg.n_layers * (11 + 3)
    assert out["cuda"] == out["cpu"]


# ---------------------------------------------------------------- tensor parallel
# the shapes a shard of qwen3-1.7b's decode takes at MP degree 2 and 4: KV 4
# and 2, G 2, hd 128, 8 lanes of 2,048 slots (pages of 16)
TP_SHARD_SHAPES = [(8, 4, 2, 128, 16, 128), (8, 2, 2, 128, 16, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", TP_SHARD_SHAPES, ids=["kv4", "kv2"])
def test_cuda_paged_kernel_at_shard_shapes(shape, dtype):
    """The paged kernel at a shard's shape, with scratch, unmapped blocks
    and the slots past valid_len poisoned, against its plain version."""
    _need_cuda()
    args = _inputs(shape, dtype, seed=3, poison=True)
    out = kernel.paged_decode_attention(*args)
    want = ref.paged_decode_attention_ref(*_inputs(shape, dtype, seed=3))
    err = float((out.float() - want.float()).abs().max())
    assert err < _split_limit(dtype, want), (shape, dtype, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_dense_kernel_at_shard_shape(dtype):
    _need_cuda()
    B, KV, G, hd, C = 8, 4, 2, 128, 2048
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    q = torch.randn((B, KV, G, hd), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, C, KV, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, C, KV, hd), generator=gen, device="cuda").to(dt)
    vl = torch.randint(1, C + 1, (B,), generator=gen, device="cuda", dtype=torch.int32)
    want = ref.decode_attention_ref(q, k, v, vl)
    err = float((kernel.decode_attention(q, k, v, vl).float() - want.float()).abs().max())
    assert err < _split_limit(dtype, want), (dtype, err)


def _tp_script(w):
    """Sibling admissions, decode, a tool extension, preempt and resume;
    returns the tokens and the untimed counters (the degree aside)."""
    prompt = [3 + i for i in range(20)]
    out = []
    w.prefill(1, prompt)
    w.prefill(2, prompt)
    w.prefill(3, [7, 11, 13, 5, 2, 9, 40, 41, 42, 43, 44])
    out.append(w.decode([1, 2, 3], 6))
    w.extend(1, [101, 102, 103, 104, 105])
    w.preempt(2)
    out.append(w.decode([1, 3], 4))
    out.append(w.decode([2], 3))
    skip = {"decode_wall_s", "decode_timed_steps", "decode_timed_lane_steps", "mp",
            "mesh_devices"}
    return out, {k: v for k, v in w.dispatch_stats().items() if k not in skip}


@pytest.mark.parametrize("heads", [(4, 4), (8, 4)], ids=["G1", "G2"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("degree", [2, 4])
def test_cuda_sharded_worker_matches_degree_one(degree, paged, heads):
    """A worker of MP degree d, every shard on the card (``[cuda:0] * d``),
    against the card's degree-1 worker on qwen3 reduced (f32): the same
    tokens and counters, the decode kernel launched d times a layer a step,
    and a teacher-forced step's logits within 1e-5 (f32 sums reordered).
    Then one of its lanes moves to a fresh degree-1 worker and decodes on
    as the same lane of the first degree-1 worker does."""
    from dataclasses import replace
    from repro_torch.engine.sampler import SamplerConfig
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.models import model as M
    _need_cuda()
    cfg = replace(get_config("qwen3_1_7b").reduced(n_periods=2), n_heads=heads[0],
                  n_kv_heads=heads[1])
    params = init_params(cfg, seed=0, device="cpu")
    name = "paged_decode_attention" if paged else "decode_attention"
    kw = dict(capacity=64, max_slots=4, page_size=8, chunk_size=8, paged=paged,
              sampler=SamplerConfig(temperature=1.0, top_p=0.9))
    runs = {}
    for d in (1, degree):
        mesh = None if d == 1 else WorkerMesh((torch.device("cuda", 0),) * d)
        w = RolloutWorker(cfg, params, mp=d, mesh=mesh, device="cuda", **kw)
        before = kernel.launches[name]
        out, stats = _tp_script(w)
        torch.cuda.synchronize()
        assert kernel.launches[name] - before == d * cfg.n_layers * stats["decode_steps"]
        last = torch.tensor([[w.store[s].tokens[-1]] for s in (1, 2, 3)] + [[0]],
                            device="cuda")
        logits, _ = M.decode_step(cfg, w.params, w.pool, last, mesh=w._tp,
                                  active=torch.zeros(4, dtype=torch.bool, device="cuda"))
        runs[d] = (w, out, stats, logits[:3].float().cpu())
    (one, out1, stats1, logits1), (w, out, stats, logits) = runs[1], runs[degree]
    assert out == out1 and stats == stats1
    assert float((logits - logits1).abs().max()) < TOL["float32"]
    fresh = RolloutWorker(cfg, params, worker_id=1, device="cuda", **kw)
    fresh.migrate_in(w.migrate_out(3))             # gathered on cuda:0, one shard again
    assert fresh.decode([3], 4)[3] == one.decode([3], 4)[3]


# the scan at a jamba Mamba layer's shard channels (di 8,192 over 2 and 4
# shards) and the paged kernel at jamba's shard shapes (KV 4 and 2, G 4)
TP_SCAN_SHAPES = [(1, 2048, 4096, 16), (1, 2048, 2048, 16)]
TP_JAMBA_SHAPES = [(8, 4, 4, 128, 16, 128), (8, 2, 4, 128, 16, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", TP_SCAN_SHAPES, ids=["di4096", "di2048"])
def test_cuda_scan_at_shard_channels(shape, dtype):
    test_cuda_scan_matches_plain(shape, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", TP_JAMBA_SHAPES, ids=["kv4", "kv2"])
def test_cuda_paged_kernel_at_jamba_shard_shapes(shape, dtype):
    test_cuda_paged_kernel_at_shard_shapes(shape, dtype)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("degree", [2, 4])
def test_cuda_sharded_jamba_worker_matches_degree_one(degree, paged):
    """jamba reduced (f32: 7 Mamba layers, 4 MoE) at MP degree d, every shard
    on the card, against the card's degree-1 worker: the same tokens and
    counters, the scan launched d times a Mamba layer an admission (each
    admission one whole-prompt forward on the mesh, on each shard's di/d
    channels), and a teacher-forced step's logits within 1e-5."""
    from repro_torch.engine.sampler import SamplerConfig
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.models import model as M
    _need_cuda()
    cfg = get_config("jamba_v0_1_52b").reduced(n_periods=1)
    params = init_params(cfg, seed=0, device="cpu")
    kw = dict(capacity=64, max_slots=4, page_size=8, paged=paged,
              sampler=SamplerConfig(temperature=1.0, top_p=0.9))
    n_mamba = sum(k.startswith("mamba") for k in cfg.block_pattern)
    runs = {}
    for d in (1, degree):
        mesh = None if d == 1 else WorkerMesh((torch.device("cuda", 0),) * d)
        w = RolloutWorker(cfg, params, mp=d, mesh=mesh, device="cuda", **kw)
        before = scan_kernel.launches["mamba_scan"]
        out, stats = _tp_script(w)
        torch.cuda.synchronize()
        assert scan_kernel.launches["mamba_scan"] - before == d * n_mamba * 3
        last = torch.tensor([[w.store[s].tokens[-1]] for s in (1, 2, 3)] + [[0]],
                            device="cuda")
        logits, _ = M.decode_step(cfg, w.params, w.pool, last, mesh=w._tp,
                                  active=torch.zeros(4, dtype=torch.bool, device="cuda"))
        runs[d] = (out, stats, logits[:3].float().cpu())
    (out1, stats1, logits1), (out, stats, logits) = runs[1], runs[degree]
    assert out == out1 and stats == stats1
    assert float((logits - logits1).abs().max()) < TOL["float32"]


# ---------------------------------------------------------------- the xLSTM and cross splits
# the dense kernel at the cross-attention shard shapes: whisper's KV 16 over 2
# and 4 shards (G 1, hd 64, 1,500 frames) and the VLM's KV 8 (G 4, hd 128,
# 1,600 patches), B 8, every slot valid, the lane past the last NaN
CROSS_SHARD_SHAPES = [(8, 8, 1, 64, 1500), (8, 4, 1, 64, 1500),
                      (8, 4, 4, 128, 1600), (8, 2, 4, 128, 1600)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CROSS_SHARD_SHAPES,
                         ids=["whisper-kv8", "whisper-kv4", "vlm-kv4", "vlm-kv2"])
def test_cuda_dense_kernel_at_cross_shard_shapes(shape, dtype):
    test_cuda_dense_kernel_at_cross_shapes(shape, dtype)


def _sharded_against_cpu(cfg, params, batch, degree, steps=4):
    """``forward_full(mesh=)`` over ``batch`` on ``degree`` shards on the
    card, then ``steps`` teacher-forced decode steps on the mesh, against the
    same unsharded on the CPU (plain versions).  Returns (the largest logit
    difference, the dense kernel's launches on the card)."""
    from repro_torch.distributed.sharding import shard_params, tp_split
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.models import model as M
    mesh = WorkerMesh((torch.device("cuda", 0),) * degree)
    shards = shard_params(params, tp_split(cfg, degree), mesh)
    want, _, cache = M.forward_full(cfg, params, batch, capacity=24)
    got, _, caches = M.forward_full(cfg, shards, M.tree_to(batch, "cuda"), capacity=24,
                                    mesh=mesh)
    err = float((got.cpu() - want).abs().max())
    before = kernel.launches["decode_attention"]
    tok = torch.tensor([[1], [2]])
    for _ in range(steps):
        lc, _ = M.decode_step(cfg, params, cache, tok)
        lg, _ = M.decode_step(cfg, shards, caches, tok.cuda(), mesh=mesh)
        err = max(err, float((lg.cpu() - lc).abs().max()))
        tok = lc.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    return err, kernel.launches["decode_attention"] - before


@pytest.mark.parametrize("degree", [2, 4])
def test_cuda_sharded_xlstm_matches_cpu(degree):
    """xlstm reduced (f32) on ``degree`` shards on the card against the CPU,
    unsharded: admission and 4 decode steps within 1e-4 of its logits; no
    kernel of the repo launches."""
    _need_cuda()
    cfg = get_config("xlstm_350m").reduced(n_periods=1)
    params = init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12),
                                     generator=torch.Generator().manual_seed(3))}
    counts = dict(kernel.launches), dict(scan_kernel.launches)
    err, _ = _sharded_against_cpu(cfg, params, batch, degree)
    assert (dict(kernel.launches), dict(scan_kernel.launches)) == counts
    assert err < 1e-4, err


@pytest.mark.parametrize("degree", [2, 4])
@pytest.mark.parametrize("name", ["whisper_medium", "llama_3_2_vision_11b"])
def test_cuda_sharded_cross_model_matches_cpu(name, degree):
    """The reduced audio and VLM models (f32, gates open; the VLM at 8/4
    heads, so that degree 4 cuts) on ``degree`` shards on the card against
    the CPU, unsharded: admission over embeddings and 4 decode steps within
    1e-4; each step runs the dense kernel once a shard and a self- or
    cross-attention layer."""
    _need_cuda()
    kw = dict(n_periods=2) if name == "whisper_medium" else dict(n_heads=8, n_kv_heads=4)
    cfg = get_config(name).reduced(**kw)
    params = _open_gates(init_params(cfg, seed=0, device="cpu"))
    T, key = ((cfg.encoder_seq, "encoder_embeds") if cfg.arch_type == "audio"
              else (cfg.image_seq, "image_embeds"))
    gen = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12), generator=gen),
             key: torch.randn((2, T, cfg.d_model), generator=gen)}
    per_step = sum({"dec": 2, "attn": 1, "xattn": 1}[k.partition("+")[0]]
                   for k in cfg.block_pattern) * cfg.n_periods
    err, launches = _sharded_against_cpu(cfg, params, batch, degree)
    assert launches == 4 * degree * per_step
    assert err < 1e-4, err


def test_cuda_serve_rollout_example_launches_the_paged_kernel():
    """``examples/torch_serve_rollout.py`` with no ``--device`` runs on the
    card: the paged kernel launches once a layer a decode step of its two
    workers, and nothing else launches."""
    _need_cuda()
    example = load_example("serve_rollout")
    before = dict(kernel.launches), dict(scan_kernel.launches)
    out = example.main([])
    torch.cuda.synchronize()
    assert out["device"].startswith("cuda")
    assert out["decoded"] == 6 * 12 and out["migrated"]
    assert kernel.launches["paged_decode_attention"] - before[0]["paged_decode_attention"] \
        == out["n_layers"] * out["decode_steps"] == 2 * (12 + 6 + 6)
    assert kernel.launches["decode_attention"] == before[0]["decode_attention"]
    assert dict(scan_kernel.launches) == before[1]


# ---------------------------------------------------------------- host copies

@pytest.fixture(scope="module")
def host_copies():
    """``chip_smoke.py``'s counter of copies from a card to the host, which
    phase 17(d) holds a card-to-card migration to."""
    return load_chip_smoke()._host_copies


READS = {"cpu": lambda x: x.cpu(), "item": lambda x: x[1].item(),
         "tolist": lambda x: x.tolist(), "copy_": lambda x: torch.empty(4).copy_(x),
         "mask": lambda x: x[x > 0], "mask_put": lambda x: x.clone().__setitem__(x > 1, 0.0),
         "equal": lambda x: torch.equal(x, x), "nonzero": lambda x: x.nonzero(),
         "unique": lambda x: torch.unique(x)}


@pytest.mark.parametrize("op", list(READS))
def test_cuda_host_copies_count_each_read_from_the_card(host_copies, op):
    _need_cuda()
    x = torch.arange(4.0, device="cuda:0")
    fn = lambda: READS[op](x)  # noqa: E731
    [copies] = host_copies(torch, fn)
    assert len(copies) >= 1 and {card for _, card in copies} == {"cuda:0"}, copies


def test_cuda_host_copies_count_nothing_to_the_card(host_copies):
    _need_cuda()
    x, y = torch.arange(4.0, device="cuda:0"), torch.arange(4.0)
    assert host_copies(torch, lambda: x.to("cuda:0"), lambda: x.to("cuda:0", copy=True),
                       lambda: y.to("cuda:0"), lambda: (x + 1).sum()) == [[], [], [], []]


def test_cuda_one_card_migration_copies_nothing_to_the_host(host_copies):
    """Phase 17(d)'s hold on one card: a lane moved between two paged
    workers on cuda:0 makes no copy to the host; the same move with its
    package first copied to the host counts at least one a leaf; the lane
    decodes on as a lane that never moved."""
    _need_cuda()
    cfg = get_config("qwen3_1_7b").reduced(n_periods=2)
    params = init_params(cfg, seed=0, device="cpu")
    kw = dict(capacity=64, max_slots=4, page_size=8, chunk_size=8, device="cuda")
    w0, w1, still = (RolloutWorker(cfg, params, worker_id=0, **kw) for _ in range(3))
    for w in (w0, still):
        w.prefill(1, list(range(3, 23)))
        w.decode([1], 3)
    leaves = []

    def hop(a, b, bounce=False):
        pkg = a.migrate_out(1)
        leaves.append(len(list(tree_leaves({"pages": pkg["pages"], "state": pkg["state"]}))))
        if bounce:
            pkg.update(pages=tree_to(pkg["pages"], "cpu"), state=tree_to(pkg["state"], "cpu"))
        b.migrate_in(pkg)

    card, host = host_copies(torch, lambda: hop(w0, w1), lambda: hop(w1, w0, bounce=True))
    assert card == []
    assert leaves[0] == leaves[1] > 0 and len(host) >= leaves[1], (host, leaves)
    assert w0.decode([1], 4) == still.decode([1], 4)
