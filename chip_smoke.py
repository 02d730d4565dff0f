#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero with no result line):

1. device  -- the card's name and power limit (nvidia-smi), torch's device name
              and count; no CUDA device is a failure.
2. build   -- nvcc builds every kernel of the path from the sources in this
              checkout (src/repro_torch/kernels/csrc/).
3. kernels -- each kernel against its plain PyTorch version at the main path's
              shapes, in bf16 and f32, with poisoned scratch / unmapped blocks
              / slots past valid_len; times for the kernel, the plain version,
              a library call computing the same function, and the bound.
4. slice   -- qwen3-1.7b at full width (28 layers, d_model 2048, bf16, random
              weights from a seed): two paged RolloutWorkers on the card serve
              8 requests in 2 GRPO groups (radix page sharing), decode at
              temperature 1.0 / top-p 0.9, a tool extend, preempt and resume,
              migration w0 -> w1, a checkpoint restored on w1, release.  The
              kernels' launch counts are zeroed just before and read just
              after; block conservation is checked on both workers.
5. profile -- one full-width decode step (8 lanes of ~1,024 tokens): wall
              time, device-busy time and launches per step, and the kernels
              that take the device's time (torch.profiler), beside the
              step's bound (weights and KV read once).
6. reference -- the same model reduced (2 layers, f32): decode logits on the
              card (kernel) against the CPU (plain version) under teacher
              forcing.

float32 matrix products run in full float32: TF32 is switched off for matmuls
and cuDNN.  The next-to-last line is one JSON object describing each kernel;
the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3, NVIDIA's data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core rate
              "float32": 67e12}      # outside the tensor cores
TOL = {"bfloat16": 2.5e-2,           # the plain version rounds probabilities to bf16
       "float32": 1e-5}              # sums in another order (8 warps' partials merged)
SEED = 0


def log(*args):
    print(*args, flush=True)


def sync_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def event_ms(torch, fn, n_iter, n_warm=3):
    """Mean ms per call over ``n_iter`` calls, timed with CUDA events after warm-up."""
    for i in range(n_warm):
        fn(i)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


# ---------------------------------------------------------------- phase 1
def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    info = {"smi": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{info['kind']} x{info['count']}")
    return info


# ---------------------------------------------------------------- phase 2
def phase_build():
    from repro_torch.kernels.build import PAGED_DECODE
    t0 = time.perf_counter()
    PAGED_DECODE.load()
    log(f"[build] {PAGED_DECODE.name}: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {PAGED_DECODE.build_seconds:.2f} s) -> {PAGED_DECODE.path}")
    for line in PAGED_DECODE.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


# ---------------------------------------------------------------- phase 3
def _paged_inputs(torch, gen, dtype, P, B, KV, G, hd, ps, num_pages, NB, max_len):
    """Stacked per-period pools like the main path's, random valid lengths and
    page tables, and a poisoned copy of the pools."""
    dev = "cuda"
    q = torch.randn((P, B, KV, G, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((P, NB, ps, KV, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((P, NB, ps, KV, hd), generator=gen, device=dev).to(dtype)
    vl = torch.randint(1, max_len + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    pt = torch.zeros((B, num_pages), dtype=torch.int32)
    perm = torch.randperm(NB - 1, generator=torch.Generator().manual_seed(SEED)) + 1
    used, c = set(), 0
    for b, n in enumerate(((vl.cpu() + ps - 1) // ps).tolist()):
        pt[b, :n] = perm[c:c + n].to(torch.int32)
        used.update(perm[c:c + n].tolist())
        c += n
    pt = pt.to(dev)
    kp, vp = k.clone(), v.clone()
    unused = torch.tensor([i for i in range(NB) if i not in used], device=dev)
    kp[:, unused], vp[:, unused] = 99.0, -99.0          # scratch block 0 + unmapped
    for b, n in enumerate(vl.tolist()):                 # slots past valid_len
        page, off = divmod(n, ps)
        if page < num_pages and off:
            blk = int(pt[b, page])
            kp[:, blk, off:], vp[:, blk, off:] = 77.0, -77.0
    return q, k, v, kp, vp, pt, vl


def _library_call(torch, q, k_pool, v_pool, pt, vl):
    """Yardstick only (never called by the port): gather + PyTorch SDPA."""
    import torch.nn.functional as F
    B, KV, G, hd = q.shape
    T = pt.shape[1] * k_pool.shape[1]
    idx = pt.long()
    kg = k_pool[idx].reshape(B, T, KV, hd).transpose(1, 2)
    vg = v_pool[idx].reshape(B, T, KV, hd).transpose(1, 2)
    mask = (torch.arange(T, device=q.device)[None] < vl[:, None])[:, None, None]
    out = F.scaled_dot_product_attention(q.reshape(B, 1, KV * G, hd).transpose(1, 2),
                                         kg, vg, attn_mask=mask, enable_gqa=True)
    return out.transpose(1, 2).reshape(B, KV, G, hd)


def phase_kernels(torch):
    from repro_torch.kernels import decode_attention as kernel
    from repro_torch.kernels import ref
    P, B, KV, G, hd, ps, num_pages, NB = 28, 8, 8, 2, 128, 16, 128, 1025
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for name in ("bfloat16", "float32"):
        dtype = getattr(torch, name)
        q, k, v, kp, vp, pt, vl = _paged_inputs(torch, gen, dtype, P, B, KV, G, hd, ps,
                                                num_pages, NB, max_len=2048)
        err = 0.0
        for p in (0, P - 1):
            want = ref.paged_decode_attention_ref(q[p], k[p], v[p], pt, vl).float()
            for kk, vv in ((k, v), (kp, vp)):
                got = kernel.paged_decode_attention(q[p], kk[p], vv[p], pt, vl)
                torch.cuda.synchronize()
                err = max(err, float((got.float() - want).abs().max()))
        finite = bool(torch.isfinite(got.float()).all())
        if not finite or err > TOL[name]:
            raise AssertionError(f"paged_decode_attention {name}: max |err| {err} "
                                 f"> {TOL[name]} (finite={finite})")
        # one launch per period's pool, as the decode path calls it: each
        # call reads a pool the previous calls did not touch
        ms = event_ms(torch, lambda i: kernel.paged_decode_attention(
            q[i % P], k[i % P], v[i % P], pt, vl), 4 * P)
        plain_ms = event_ms(torch, lambda i: ref.paged_decode_attention_ref(
            q[i % P], k[i % P], v[i % P], pt, vl), P)
        library_ms = event_ms(torch, lambda i: _library_call(
            torch, q[i % P], k[i % P], v[i % P], pt, vl), P)
        lib_err = float((_library_call(torch, q[0], k[0], v[0], pt, vl).float()
                         - ref.paged_decode_attention_ref(q[0], k[0], v[0], pt, vl).float())
                        .abs().max())
        tokens = int(vl.sum())
        item = q.element_size()
        pages = int(((vl + ps - 1) // ps).sum())
        nbytes = (2 * tokens * KV * hd * item + 2 * q[0].numel() * item
                  + pages * 4 + B * 4)
        flops = 4 * tokens * KV * G * hd
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[name] * 1e3
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        log(f"[kernels] paged_decode_attention {name}: B={B} KV={KV} G={G} hd={hd} ps={ps} "
            f"num_pages={num_pages} NB={NB}, valid_len sum {tokens} max {int(vl.max())}; "
            f"max|err| {err:.3e} "
            f"(tol {TOL[name]}, poisoned scratch/unmapped/tail); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, gather+SDPA {library_ms:.4f} ms "
            f"(|err| {lib_err:.2e}); bound {rows[name]['bound_ms']:.4f} ms "
            f"({nbytes / 1e6:.1f} MB, {rows[name]['bound_by']}-bound)")
        del q, k, v, kp, vp
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 4
def phase_slice(torch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.engine.paging import check_block_conservation
    from repro_torch.engine.sampler import SamplerConfig
    from repro_torch.engine.worker import RolloutWorker
    from repro_torch.kernels import decode_attention
    from repro_torch.models.model import init_params, param_count

    cfg = get_config("qwen3_1_7b")
    torch.cuda.reset_peak_memory_stats()
    params, ms = sync_ms(torch, lambda: init_params(cfg, seed=SEED, device="cuda"))
    log(f"[slice] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.dtype}; {param_count(params) / 1e9:.3f} B params "
        f"(init {ms:.0f} ms)")
    kw = dict(capacity=2048, page_size=16, max_slots=8, sampler=SamplerConfig(1.0, 0.9),
              seed=SEED, device="cuda")
    w0 = RolloutWorker(cfg, params, worker_id=0, **kw)
    w1 = RolloutWorker(cfg, params, worker_id=1, **kw)
    rng = np.random.default_rng(SEED)
    groups = [rng.integers(0, cfg.vocab, n).tolist() for n in (300, 257)]
    times = {}
    decoded = 0

    def timed(label, fn):
        out, t = sync_ms(torch, fn)
        times[label] = times.get(label, 0.0) + t
        return out

    def decode(w, sids, n, label):
        nonlocal decoded
        out = timed(label, lambda: w.decode(sids, n))
        decoded += sum(len(t) for t in out.values())
        for toks in out.values():
            if len(toks) != n or not all(0 <= t < cfg.vocab for t in toks):
                raise AssertionError(f"{label}: bad tokens {toks[:8]}...")
        return out

    decode_attention.launches = 0                           # main path starts here
    for sid in range(8):
        timed("prefill", lambda: w0.prefill(sid, groups[sid // 4]))
    stats = w0.dispatch_stats()
    if stats["blocks_shared"] == 0 or stats["reused_tokens"] < 3 * sum(map(len, groups)):
        raise AssertionError(f"radix page sharing did not engage: {stats}")
    decode(w0, list(range(8)), 64, "decode")
    timed("extend", lambda: w0.extend(0, rng.integers(0, cfg.vocab, 48).tolist()))
    w0.preempt(1)
    decode(w0, [0, 2, 3, 4, 5, 6, 7], 8, "decode")
    decode(w0, [1], 8, "decode")                            # resume
    pkg = timed("migrate", lambda: w0.migrate_out(2))
    timed("migrate", lambda: w1.migrate_in(pkg))
    decode(w1, [2], 16, "decode")
    ck = timed("checkpoint", lambda: w0.checkpoint_out(3))
    timed("checkpoint", lambda: w1.migrate_in(ck))
    a = decode(w1, [3], 8, "decode")[3]
    b = decode(w0, [3], 8, "decode")[3]
    if a != b:
        raise AssertionError(f"restored lane diverged from its source: {a} vs {b}")
    for w in (w0, w1):
        for sid in list(w.store):
            timed("release", lambda: w.release(sid))
    torch.cuda.synchronize()
    launches = {"paged_decode_attention": decode_attention.launches}   # main path ends
    steps = w0.decode_steps + w1.decode_steps
    if launches["paged_decode_attention"] < cfg.n_layers * steps:
        raise AssertionError(f"paged_decode_attention launched {launches} times for "
                             f"{steps} decode steps x {cfg.n_layers} layers")
    for i, w in enumerate((w0, w1)):
        bad = check_block_conservation(w.dispatch_stats())
        if bad:
            raise AssertionError(f"worker {i}: {bad}")
    s0, s1 = w0.dispatch_stats(), w1.dispatch_stats()
    log(f"[slice] decode steps {steps} (w0 {w0.decode_steps}, w1 {w1.decode_steps}); "
        f"paged_decode_attention launches {launches['paged_decode_attention']} "
        f"(>= {cfg.n_layers} x {steps}); tokens decoded {decoded}")
    log(f"[slice] blocks w0: {s0['reused_tokens']} prompt tokens reused by sharing, "
        f"high watermark {s0['blocks_used_high_watermark']}/{s0['blocks_total']}; "
        f"w1 high watermark {s1['blocks_used_high_watermark']}; conservation clean")
    log("[slice] phase ms: " + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    log(f"[slice] decode {decoded / (times['decode'] / 1e3):.1f} tokens/s "
        f"({times['decode'] / steps:.2f} ms per step); peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del w0, w1, params, pkg, ck
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 5
def phase_profile(torch):
    """Where one decode step's time goes at full width: 8 lanes of ~1,024
    tokens.  Wall time of ``n`` steps without the profiler, then the device
    time of the same number of steps by kernel under torch.profiler."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.engine.sampler import SamplerConfig
    from repro_torch.engine.worker import RolloutWorker
    from repro_torch.models.model import init_params, param_count

    cfg = get_config("qwen3_1_7b")
    params = init_params(cfg, seed=SEED, device="cuda")
    w = RolloutWorker(cfg, params, capacity=2048, page_size=16, max_slots=8,
                      chunk_size=256, sampler=SamplerConfig(1.0, 0.9), seed=SEED,
                      device="cuda")
    rng = np.random.default_rng(SEED + 1)
    lanes, n = list(range(8)), 8
    for sid in lanes:
        w.prefill(sid, rng.integers(0, cfg.vocab, 1024).tolist())
    w.decode(lanes, 2)                                      # warm-up
    context = sum(len(w.store[s].tokens) for s in lanes)
    _, wall = sync_ms(torch, lambda: w.decode(lanes, n))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w.decode(lanes, n)
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / n
    item = params["tok_embed"].element_size()
    kv_bytes = (context + 8 * (n + 1) / 2) * cfg.n_layers     # mean over the n steps * 2 * cfg.n_kv_heads * cfg.hd * item
    bound = (param_count(params) * item + kv_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"[profile] decode step, 8 lanes, {context / 8:.0f} tokens of context each: wall "
        f"{wall / n:.3f} ms, device busy {busy:.3f} ms ({100 * busy * n / wall:.1f}% of "
        f"wall), {sum(e.count for e in kern) / n:.0f} device launches; bound {bound:.3f} ms "
        f"(weights + KV read once at 3.35 TB/s)")
    if busy == 0:
        log("[profile] torch.profiler recorded no device time on this machine")
    for e in kern[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / n:8.3f} ms/step "
            f"{e.count / n:6.0f}x  {e.key[:90]}")
    del w, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 6
def phase_reference(torch):
    """Teacher-forced decode logits, card (kernel) vs CPU (plain version)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.model import init_params, tree_to

    cfg = get_config("qwen3_1_7b").reduced(n_periods=2)
    params = init_params(cfg, seed=SEED, device="cpu")
    gparams = tree_to(params, "cuda")
    pools = {}
    for dev, prm in (("cpu", params), ("cuda", gparams)):
        pool = M.init_paged_pool(cfg, 2, 9, 16, 4, dev)
        M.paged_set_lane(pool, 1, np.asarray([3, 5, 7, 0], np.int32), 0)
        buf = torch.tensor([list(range(5, 29))], device=dev)
        M.prefill_chunk_paged(cfg, prm, pool, 1, buf, 24)
        pools[dev] = pool
    tok = torch.tensor([[0], [28]])
    err = 0.0
    for _ in range(8):
        lc, _ = M.decode_step(cfg, params, pools["cpu"], tok)
        lg, _ = M.decode_step(cfg, gparams, pools["cuda"], tok.cuda())
        err = max(err, float((lg.cpu() - lc).abs().max()))
        tok = lc.argmax(-1, keepdim=True)
    if not err < 1e-4:
        raise AssertionError(f"reduced decode logits: card vs CPU max |err| {err} >= 1e-4")
    log(f"[reference] reduced {cfg.name} (2 layers, f32): 8 teacher-forced decode steps, "
        f"logits card vs CPU max |err| {err:.2e} (tol 1e-4)")


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False      # f32 matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False
    try:
        info = phase_device(torch)
        phase_build()
        rows = phase_kernels(torch)
        launches = phase_slice(torch)
        phase_profile(torch)
        phase_reference(torch)
    except Exception:                                  # a failed phase fails the run
        traceback.print_exc()
        return 1
    main_row = rows["bfloat16"]                        # the main path's dtype
    kernels = [{"name": "paged_decode_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
                "replaces": "src/repro/kernels/decode_attention.py:112",
                "launches": launches["paged_decode_attention"], **main_row}]
    log(f"[device] {info['smi']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
