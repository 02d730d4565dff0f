#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero with no result line):

1. device  -- the card's name and power limit (nvidia-smi), torch's device name
              and count; no CUDA device is a failure.
2. build   -- nvcc builds every kernel of the path from the sources in this
              checkout (src/repro_torch/kernels/csrc/) into one library, one
              nvcc per source, all started together, then a link.
3. kernels -- each kernel against its plain PyTorch version at the main
              paths' shapes, in bf16 and f32 (bf16 also relative to the
              output's size), with poisoned scratch / unmapped blocks / slots
              past valid_len; device times (CUDA events, the stream held while
              the host enqueues) for the kernel, the plain version, a library
              call computing the same function, and the bound.  The
              dense kernel runs at the linear pool's shape and at the
              sliding-window ring's; the selective scan at a jamba Mamba
              layer's admission (B 1, S 2,048, di 8,192, N 16), all-f32, at
              S 1,500 and at B 2 (no PyTorch call computes a scan), with
              the copy widths its wrapper chose.  Each
              decode row also logs the split the wrapper chose (n_split, L,
              blocks), the achieved GB/s, the share of the bound and the
              host's time to enqueue one call.
4. slice   -- qwen3-1.7b at full width (28 layers, d_model 2048, bf16, random
              weights from a seed): two paged RolloutWorkers on the card serve
              8 requests in 2 GRPO groups (radix page sharing), decode at
              temperature 1.0 / top-p 0.9, a tool extend, preempt and resume,
              migration w0 -> w1, a checkpoint restored on w1, release.  The
              kernels' launch counts are zeroed just before and read just
              after; block conservation is checked on both workers.
5. dense   -- the dense plane at the same width, counts zeroed before and read
              after: (a) a dense worker (paged=False) beside a paged one: the
              same groups with lane-prefix reuse, decode, extend, preempt and
              resume, a checkpoint restored, migration dense -> paged ->
              dense, a ninth request that doubles the pool; (b) the
              sliding-window variant (window 8192, dense by force): prompts of
              9,000 tokens (flash attention, the ring wraps at admission) and
              3,000, decode, per-token tool absorption.
6. profile -- one full-width decode step (8 lanes of ~1,024 tokens) on the
              paged and on the dense worker: wall time, device-busy time and
              launches per step, and the kernels that take the device's time
              (torch.profiler), beside the step's bound (weights and KV read
              once).
7. jamba   -- jamba-v0.1-52b at its published widths cut to one period (8
              layers: 7 Mamba, 1 attention, 4 MoE; bf16, 13.3 B params, random
              weights from the seed): two paged workers and a dense one serve
              8 requests in 2 GRPO groups (prompts of 2,048 and 1,500 tokens,
              whole-prompt admission: 7 scan launches each), decode 64 steps
              at temperature 1.0 / top-p 0.9, absorb a 16-token tool output
              one step per token, preempt and resume, migrate paged -> paged
              -> dense -> paged and restore a checkpoint, each lane's KV and
              Mamba state held exactly.  Counts zeroed before and read after;
              then a profile of one 2,048-token admission and of one decode
              step at 8 lanes, beside the step's bound.
8. reference -- the qwen3 model reduced (2 layers, f32): decode logits on the
              card (kernels) against the CPU (plain versions) under teacher
              forcing, on the paged plane and on a sliding-window ring; the
              reduced jamba period the same way after a whole-prompt
              admission, its Mamba state card vs CPU.
9. runtime -- the control plane over the port's workers: qwen3-1.7b at full
              width, two RolloutWorkers on the card driven by the orchestrator
              through EngineBackend on the reference trace harness's workload
              (24 trajectories, 448 planned tokens; pps, migration, 2 active
              lanes a worker, quantum 8, an infinite link, the sanitizer on),
              each run's decision trace and makespan held to the sim's: the
              paged plane (preemptions and migrations must occur), the dense
              plane (paged=False, migration off, under torch.profiler), and
              the paged plane under a chaos plan (a worker death and revival,
              injected tool faults, checkpoints persisted to a temporary
              directory and loaded back).  The decode kernels' counts are
              zeroed before each run and read after it.  The inputs of every
              2,500th decode-kernel call of each run are kept, and after the
              run the kernel is held to its plain version on them (the cache
              also poisoned wherever no lane reads), and on drawn inputs at
              the runtime's shapes whose lengths fill every piece of the
              split, the ragged last one too.  Then the serve CLI
              (python -m repro_torch.launch.serve) runs as a process of its
              own, with no --device flag: on the card.

float32 matrix products run in full float32: TF32 is switched off for matmuls
and cuDNN.  The next-to-last line is one JSON object describing each kernel;
the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
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
# exp2 results per second on the special-function units: 16 a clock per SM
# (CUDA C++ Programming Guide, arithmetic throughput for compute capability
# 9.0) x 132 SMs x the 1.98 GHz boost clock that the 67 TFLOP/s assumes
SFU_PER_S = 16 * 132 * 1.98e9
SCAN_TOL = 1e-4                      # x max(1, max |reference|): f32 in both, exp2 vs exp
TOL = {"bfloat16": 2.5e-2,           # the plain version rounds probabilities to bf16
       "float32": 1e-5}              # sums in another order (8 warps' partials merged)
BF16_REL = 2e-2                      # bf16 is also held to this share of max |reference|
SEED = 0


def log(*args):
    print(*args, flush=True)


def sync_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def event_ms(torch, fn, n_iter, n_warm=3, hold=True):
    """(mean device ms, mean host ms to enqueue) per call over ``n_iter``
    calls, timed with CUDA events after warm-up.  With ``hold`` a spin kernel
    keeps the stream busy while the host enqueues the calls, so that calls
    shorter than their launch on the host are timed on the device and not at
    the host's launch rate; the spin is made twice as long as the enqueue took
    on the last warm-up call, and doubled until the enqueue ends inside it.
    Without it (calls of thousands of launches) the events also take in the
    host's gaps."""
    for i in range(n_warm):
        t0 = time.perf_counter()
        fn(i)
        per_call_s = time.perf_counter() - t0      # the last warm-up call's
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = min(int(2 * n_iter * per_call_s * 2e9), 2_000_000_000) + 2_000_000  # ~2 GHz
    for _ in range(6):
        torch.cuda.synchronize()
        if hold:
            ev[0].record()
            torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for i in range(n_iter):
            fn(i)
        ev[2].record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if not hold or enqueue_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / n_iter, enqueue_ms / n_iter
        cycles *= 2
    raise RuntimeError(f"event_ms: the host took {enqueue_ms:.1f} ms to enqueue {n_iter} "
                       f"calls, longer than the spin kernel held the stream")


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
    from repro_torch.kernels.build import KERNELS
    t0 = time.perf_counter()
    KERNELS.load()
    log(f"[build] {KERNELS.name} ({', '.join(KERNELS.sources)}): "
        f"{time.perf_counter() - t0:.2f} s (nvcc {KERNELS.build_seconds:.2f} s, one per "
        f"source, started together) -> {KERNELS.path}")
    entry = ""
    for line in KERNELS.log.splitlines():          # ptxas -v
        if "Compiling entry function" in line:
            entry = line
        if any(int(n) for n in re.findall(r"(\d+) bytes spill", line)):
            log(f"[build]   {line.strip()}")       # instantiations that spill
        if "registers" in line and "mamba_scan_kernel" in entry:   # <T, N>
            log(f"[build]   mamba_scan_kernel<{re.search(r'kernelI(.*?)EEEv', entry).group(1)}>: "
                f"{line.split(':', 1)[1].strip()}")


# ---------------------------------------------------------------- phase 3
def _paged_inputs(torch, gen, dtype, P, B, KV, G, hd, ps, num_pages, NB, max_len, vl=None):
    """Stacked per-period pools like the main path's, random valid lengths
    (unless ``vl`` is given) and page tables."""
    dev = "cuda"
    q = torch.randn((P, B, KV, G, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((P, NB, ps, KV, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((P, NB, ps, KV, hd), generator=gen, device=dev).to(dtype)
    if vl is None:
        vl = torch.randint(1, max_len + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    pt = torch.zeros((B, num_pages), dtype=torch.int32)
    perm = torch.randperm(NB - 1, generator=torch.Generator().manual_seed(SEED)) + 1
    c = 0
    for b, n in enumerate(((vl.cpu() + ps - 1) // ps).tolist()):
        pt[b, :n] = perm[c:c + n].to(torch.int32)
        c += n
    return q, k, v, pt.to(dev), vl


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


def _dense_inputs(torch, gen, dtype, P, B, C, KV, G, hd):
    """Stacked per-period caches like the dense pool's."""
    dev = "cuda"
    q = torch.randn((P, B, KV, G, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((P, B, C, KV, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((P, B, C, KV, hd), generator=gen, device=dev).to(dtype)
    return q, k, v


def _dense_library_call(torch, q, k, v, vl):
    """Yardstick only (never called by the port): PyTorch SDPA with a
    valid_len mask."""
    import torch.nn.functional as F
    B, KV, G, hd = q.shape
    C = k.shape[1]
    mask = (torch.arange(C, device=q.device)[None] < vl[:, None])[:, None, None]
    out = F.scaled_dot_product_attention(q.reshape(B, 1, KV * G, hd).transpose(1, 2),
                                         k.transpose(1, 2), v.transpose(1, 2),
                                         attn_mask=mask, enable_gqa=True)
    return out.transpose(1, 2).reshape(B, KV, G, hd)


def _row(name, err, ms, plain_ms, library_ms, nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[name] * 1e3
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _time_three(torch, P, kernel_fn, plain_fn, library_fn):
    """CUDA-event ms of the kernel (4 passes over the P periods), the plain
    version and the library call (one pass each): every call reads another
    period's cache, so L2 is cold as on the decode path.  Also the host's
    ms to enqueue one kernel call (the wrapper and the launch)."""
    ms, host_ms = event_ms(torch, lambda i: kernel_fn(i % P), 4 * P)
    return (ms, event_ms(torch, lambda i: plain_fn(i % P), P)[0],
            event_ms(torch, lambda i: library_fn(i % P), P)[0], host_ms)


def _limit(name, scale):
    """The tolerance for outputs whose largest |value| is ``scale``: in bf16
    also relative, so that small outputs (8,192 tokens averaged) are checked."""
    return TOL[name] if name == "float32" else min(TOL[name], BF16_REL * scale)


def _check_err(label, name, got, err, limit):
    finite = all(bool(g.float().isfinite().all()) for g in got)
    if not finite or err > limit:
        raise AssertionError(f"{label} {name}: max |err| {err} > {limit} "
                             f"(finite={finite})")


def _read_slots(torch, pt, vl, ps, NB):
    """(NB, ps) bool: the pool slots that some lane reads below its valid_len."""
    t = torch.arange(pt.shape[1] * ps, device=pt.device)
    live = t[None] < vl[:, None]
    blocks = pt.long()[:, t // ps]
    read = torch.zeros((NB, ps), dtype=torch.bool, device=pt.device)
    read[blocks[live], (t % ps).expand_as(blocks)[live]] = True
    return read


def _hold_decode(torch, label, args):
    """A decode kernel's wrapper on ``args`` (q, cache..., valid_len), and on
    a copy whose cache is poisoned with +-99 in every slot no lane reads,
    against its plain version on ``args``, to ``_limit``'s tolerance; raises
    on a mismatch.  Four args are the dense kernel's, five the paged one's.
    Returns (max |err|, limit, max |reference|)."""
    from repro_torch.kernels import decode_attention as kernel
    from repro_torch.kernels import ref
    q, k, v, *rest = args
    vl = rest[-1]
    if len(rest) == 2:
        read = _read_slots(torch, rest[0], vl, k.shape[1], k.shape[0])
        fn, plain = kernel.paged_decode_attention, ref.paged_decode_attention_ref
    else:
        read = torch.arange(k.shape[1], device=k.device)[None] < vl[:, None]
        fn, plain = kernel.decode_attention, ref.decode_attention_ref
    kp, vp = k.clone(), v.clone()
    kp[~read], vp[~read] = 99.0, -99.0
    want = plain(*args).float()
    got = [fn(*args), fn(q, kp, vp, *rest)]
    torch.cuda.synchronize()
    err = max(float((g.float() - want).abs().max()) for g in got)
    name, scale = str(q.dtype).removeprefix("torch."), float(want.abs().max())
    limit = _limit(name, scale)
    _check_err(label, name, got, err, limit)
    return err, limit, scale


def _held(torch, label, calls):
    """``_hold_decode`` over several calls: (max |err|, least limit, max |reference|)."""
    held = [_hold_decode(torch, label, args) for args in calls]
    return (max(h[0] for h in held), min(h[1] for h in held), max(h[2] for h in held))


def _log_split(torch, kernel, label, name, B, KV, C, page_size, nbytes, row, host_ms):
    """The split the wrapper chose for this shape on this card, the kernel's
    achieved rate and share of its bound, and the host's time per call."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    L, n_split = kernel._split_plan(B, KV, C, page_size, sms)
    log(f"[kernels]   {label} {name}: n_split {n_split}, L {L}, {B * KV * n_split} blocks on "
        f"{sms} SMs; {nbytes / row['ms'] / 1e6:.1f} GB/s, {row['bound_ms'] / row['ms']:.1%} "
        f"of the bound; the host enqueues a call in {host_ms:.4f} ms")


def phase_kernels(torch):
    from repro_torch.kernels import decode_attention as kernel
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {"paged_decode_attention": {}, "decode_attention": {}, "decode_attention_ring": {}}
    P, B, KV, G, hd, ps, num_pages, NB = 28, 8, 8, 2, 128, 16, 128, 1025
    for name in ("bfloat16", "float32"):
        dtype = getattr(torch, name)
        q, k, v, pt, vl = _paged_inputs(torch, gen, dtype, P, B, KV, G, hd, ps, num_pages, NB,
                                        max_len=2048)
        err, limit, scale = _held(torch, "paged_decode_attention",
                                  [(q[p], k[p], v[p], pt, vl) for p in (0, P - 1)])
        ms, plain_ms, library_ms, host_ms = _time_three(
            torch, P, lambda i: kernel.paged_decode_attention(q[i], k[i], v[i], pt, vl),
            lambda i: ref.paged_decode_attention_ref(q[i], k[i], v[i], pt, vl),
            lambda i: _library_call(torch, q[i], k[i], v[i], pt, vl))
        lib_err = float((_library_call(torch, q[0], k[0], v[0], pt, vl).float()
                         - ref.paged_decode_attention_ref(q[0], k[0], v[0], pt, vl).float())
                        .abs().max())
        tokens = int(vl.sum())
        item = q.element_size()
        pages = int(((vl + ps - 1) // ps).sum())
        nbytes = (2 * tokens * KV * hd * item + 2 * q[0].numel() * item
                  + pages * 4 + B * 4)
        row = _row(name, err, ms, plain_ms, library_ms, nbytes, 4 * tokens * KV * G * hd)
        rows["paged_decode_attention"][name] = row
        log(f"[kernels] paged_decode_attention {name}: B={B} KV={KV} G={G} hd={hd} ps={ps} "
            f"num_pages={num_pages} NB={NB}, valid_len sum {tokens} max {int(vl.max())}; "
            f"max|err| {err:.3e} "
            f"(tol {limit:.3e}, max|ref| {scale:.3e}, poisoned scratch/unmapped/tail); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, gather+SDPA {library_ms:.4f} ms "
            f"(|err| {lib_err:.2e}); bound {row['bound_ms']:.4f} ms "
            f"({nbytes / 1e6:.1f} MB, {row['bound_by']}-bound)")
        _log_split(torch, kernel, "paged_decode_attention", name, B, KV, num_pages * ps, ps,
                   nbytes, row, host_ms)
        del q, k, v
        torch.cuda.empty_cache()
    # the dense kernel: the linear pool's shape (random lengths) and the
    # sliding-window ring's (every slot valid)
    for label, B, C in (("decode_attention", 8, 2048), ("decode_attention_ring", 4, 8192)):
        for name in ("bfloat16", "float32"):
            dtype = getattr(torch, name)
            vl = (torch.full((B,), C, dtype=torch.int32, device="cuda") if C == 8192 else
                  torch.randint(1, C + 1, (B,), generator=gen, device="cuda",
                                dtype=torch.int32))
            q, k, v = _dense_inputs(torch, gen, dtype, P, B, C, KV, G, hd)
            err, limit, scale = _held(torch, label, [(q[p], k[p], v[p], vl) for p in (0, P - 1)])
            ms, plain_ms, library_ms, host_ms = _time_three(
                torch, P, lambda i: kernel.decode_attention(q[i], k[i], v[i], vl),
                lambda i: ref.decode_attention_ref(q[i], k[i], v[i], vl),
                lambda i: _dense_library_call(torch, q[i], k[i], v[i], vl))
            lib_err = float((_dense_library_call(torch, q[0], k[0], v[0], vl).float()
                             - ref.decode_attention_ref(q[0], k[0], v[0], vl).float())
                            .abs().max())
            tokens = int(vl.sum())
            item = q.element_size()
            nbytes = 2 * tokens * KV * hd * item + 2 * q[0].numel() * item + B * 4
            row = _row(name, err, ms, plain_ms, library_ms, nbytes, 4 * tokens * KV * G * hd)
            rows[label][name] = row
            log(f"[kernels] {label} {name}: B={B} C={C} KV={KV} G={G} hd={hd}, valid_len "
                f"sum {tokens} max {int(vl.max())}; max|err| {err:.3e} (tol {limit:.3e}, "
                f"max|ref| {scale:.3e}, poisoned past valid_len); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"SDPA {library_ms:.4f} ms (|err| {lib_err:.2e}); bound "
                f"{row['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB, {row['bound_by']}-bound)")
            _log_split(torch, kernel, label, name, B, KV, C, 1, nbytes, row, host_ms)
            del q, k, v
            torch.cuda.empty_cache()
    rows["mamba_scan"] = _scan_rows(torch, gen)
    return rows


def _scan_bound(B, S, di, N, item):
    """The least time for one selective scan: the larger of the bytes (dt
    and y in f32, x, B, C in ``item`` bytes, A_log and the last state in f32,
    each once), the exponentials (one per (t, d, n)) on the special-function
    units, and 6 f32 operations per (t, d, n) at the f32 peak.  Returns
    (bound ms, bound_by, bytes, each of the three times in ms)."""
    nbytes = B * S * di * (4 + item + 4) + 2 * B * S * N * item + di * N * 4 + B * di * N * 4
    n = B * S * di * N
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "exp": n / SFU_PER_S * 1e3,
             "flops": 6 * n / PEAK_FLOPS["float32"] * 1e3}
    bound = max(times.values())
    return bound, "bytes" if times["bytes"] >= bound else "operations", nbytes, times


SCAN_SHAPES = (("main", 1, 2048, "bfloat16"), ("f32", 1, 2048, "float32"),
               ("ragged S", 1, 1500, "bfloat16"), ("B 2", 2, 2048, "bfloat16"))


def _scan_inputs(torch, gen, B, S, name):
    """A jamba Mamba layer's scan inputs (di 8,192, N 16, the model's A_log):
    dt f32, x/B/C in ``name``."""
    import torch.nn.functional as F
    dtype = getattr(torch, name)
    di, N = 8192, 16
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device="cuda")
                      ).expand(di, N).contiguous()
    dt = F.softplus(torch.randn((B, S, di), generator=gen, device="cuda"))
    b_in, c_in = (0.5 * torch.randn((B, S, N), generator=gen, device="cuda") for _ in "bc")
    x = 0.5 * torch.randn((B, S, di), generator=gen, device="cuda")
    return dt, b_in.to(dtype), c_in.to(dtype), x.to(dtype), a_log


def _scan_rows(torch, gen):
    """The scan kernel against its plain version: the main path's shape (one
    2,048-token admission of a jamba Mamba layer: B 1, di 8,192, N 16; dt
    f32, x/B/C bf16), all-f32, a ragged S of 1,500 and B 2.  The plain
    version launches ~10 ops per time step, so it is timed over 2 calls.
    Each row logs the copy widths of the checked launch."""
    from repro_torch.kernels import mamba_scan as scan_kernel
    from repro_torch.kernels import ref
    di, N = 8192, 16
    rows = {}
    for label, B, S, name in SCAN_SHAPES:
        args = _scan_inputs(torch, gen, B, S, name)
        got = scan_kernel.mamba_scan(*args)
        torch.cuda.synchronize()
        want = ref.mamba_scan_ref(*args)
        errs = []
        for part, g, w in zip(("y", "h_S"), got, want):
            limit = SCAN_TOL * max(1.0, float(w.abs().max()))
            err = float((g - w).abs().max())
            _check_err(f"mamba_scan {label} {part}", name, [g], err, limit)
            errs.append(f"{part} max|err| {err:.3e} (tol {limit:.3e})")
        bound, bound_by, nbytes, times = _scan_bound(B, S, di, N, args[1].element_size())
        msg = (f"[kernels] mamba_scan {label}: B={B} S={S} di={di} N={N}, dt f32, x/B/C "
               f"{name}; {', '.join(errs)}")
        if label in ("main", "f32"):
            ms = event_ms(torch, lambda i: scan_kernel.mamba_scan(*args), 20)[0]
            plain_ms = event_ms(torch, lambda i: ref.mamba_scan_ref(*args), 2, n_warm=1,
                                hold=False)[0]
            rows[name] = {"max_abs_err": float(max((g - w).abs().max()
                                                   for g, w in zip(got, want))),
                          "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                          "bound_ms": bound, "bound_by": bound_by}
            msg += (f"; kernel {ms:.4f} ms ({bound / ms:.1%} of the bound), plain "
                    f"{plain_ms:.2f} ms, library none (no PyTorch call computes a selective "
                    f"scan); bound {bound:.4f} ms ({bound_by}: bytes {nbytes / 1e6:.1f} MB "
                    f"{times['bytes']:.4f} ms, {B * S * di * N / 1e6:.1f} M exp2 on the SFUs "
                    f"{times['exp']:.4f} ms, f32 ops {times['flops']:.4f} ms)")
        plan = scan_kernel._scan_plan(S, di, N, args[1].element_size(),
                                      [t.data_ptr() for t in (*args[:4], got[0])])
        log(msg + "; copy widths " + ", ".join(f"{k} {plan[k]}" for k in scan_kernel.PLAN_KEYS))
        del args, got, want
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 4
class Script:
    """Drives workers through a scenario: times each step with a synchronised
    host clock, and checks every decoded token."""

    def __init__(self, torch, cfg):
        self.torch, self.cfg = torch, cfg
        self.times: dict[str, float] = {}
        self.decoded = 0

    def timed(self, label, fn):
        out, t = sync_ms(self.torch, fn)
        self.times[label] = self.times.get(label, 0.0) + t
        return out

    def decode(self, w, sids, n, label="decode"):
        out = self.timed(label, lambda: w.decode(sids, n))
        self.decoded += sum(len(t) for t in out.values())
        for toks in out.values():
            if len(toks) != n or not all(0 <= t < self.cfg.vocab for t in toks):
                raise AssertionError(f"{label}: bad tokens {toks[:8]}...")
        return out

    def release_all(self, *workers):
        for w in workers:
            for sid in list(w.store):
                self.timed("release", lambda: w.release(sid))

    def report(self, tag, steps):
        self.torch.cuda.synchronize()
        log(f"[{tag}] phase ms: " + ", ".join(f"{k} {v:.1f}" for k, v in self.times.items()))
        log(f"[{tag}] decode {self.decoded / (self.times['decode'] / 1e3):.1f} tokens/s "
            f"({self.times['decode'] / steps:.2f} ms per step); peak allocated "
            f"{self.torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def _full_width(torch):
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, param_count
    cfg = get_config("qwen3_1_7b")
    params, ms = sync_ms(torch, lambda: init_params(cfg, seed=SEED, device="cuda"))
    log(f"[model] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.dtype}; {param_count(params) / 1e9:.3f} B params "
        f"(init {ms:.0f} ms)")
    return cfg, params


def _counters():
    from repro_torch.kernels import decode_attention, mamba_scan
    return decode_attention.launches, mamba_scan.launches


def _reset_launches():
    for counts in _counters():
        for name in counts:
            counts[name] = 0


def _read_launches(torch):
    torch.cuda.synchronize()
    return {name: n for counts in _counters() for name, n in counts.items()}


def phase_slice(torch):
    import numpy as np
    from repro_torch.engine.paging import check_block_conservation
    from repro_torch.engine.sampler import SamplerConfig
    from repro_torch.engine.worker import RolloutWorker

    torch.cuda.reset_peak_memory_stats()
    cfg, params = _full_width(torch)
    kw = dict(capacity=2048, page_size=16, max_slots=8, sampler=SamplerConfig(1.0, 0.9),
              seed=SEED, device="cuda")
    w0 = RolloutWorker(cfg, params, worker_id=0, **kw)
    w1 = RolloutWorker(cfg, params, worker_id=1, **kw)
    rng = np.random.default_rng(SEED)
    groups = [rng.integers(0, cfg.vocab, n).tolist() for n in (300, 257)]
    run = Script(torch, cfg)

    _reset_launches()                                       # main path starts here
    for sid in range(8):
        run.timed("prefill", lambda: w0.prefill(sid, groups[sid // 4]))
    stats = w0.dispatch_stats()
    if stats["blocks_shared"] == 0 or stats["reused_tokens"] < 3 * sum(map(len, groups)):
        raise AssertionError(f"radix page sharing did not engage: {stats}")
    run.decode(w0, list(range(8)), 64)
    run.timed("extend", lambda: w0.extend(0, rng.integers(0, cfg.vocab, 48).tolist()))
    w0.preempt(1)
    run.decode(w0, [0, 2, 3, 4, 5, 6, 7], 8)
    run.decode(w0, [1], 8)                                  # resume
    pkg = run.timed("migrate", lambda: w0.migrate_out(2))
    run.timed("migrate", lambda: w1.migrate_in(pkg))
    run.decode(w1, [2], 16)
    ck = run.timed("checkpoint", lambda: w0.checkpoint_out(3))
    run.timed("checkpoint", lambda: w1.migrate_in(ck))
    a = run.decode(w1, [3], 8)[3]
    b = run.decode(w0, [3], 8)[3]
    if a != b:
        raise AssertionError(f"restored lane diverged from its source: {a} vs {b}")
    run.release_all(w0, w1)
    launches = _read_launches(torch)                        # main path ends
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
        f"launches {launches} (paged >= {cfg.n_layers} x {steps}); tokens decoded "
        f"{run.decoded}")
    log(f"[slice] blocks w0: {s0['reused_tokens']} prompt tokens reused by sharing, "
        f"high watermark {s0['blocks_used_high_watermark']}/{s0['blocks_total']}; "
        f"w1 high watermark {s1['blocks_used_high_watermark']}; conservation clean")
    run.report("slice", steps)
    del w0, w1, params, pkg, ck
    torch.cuda.empty_cache()
    return launches["paged_decode_attention"]


# ---------------------------------------------------------------- phase 5
def phase_dense(torch):
    """The dense plane at full width: (a) the linear dense pool beside a paged
    worker, (b) the sliding-window ring.  Returns the dense kernel's launches
    over both."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.engine.sampler import SamplerConfig
    from repro_torch.engine.worker import RolloutWorker
    from repro_torch.models.config import LONG_CONTEXT_WINDOW

    torch.cuda.reset_peak_memory_stats()
    cfg, params = _full_width(torch)
    kw = dict(sampler=SamplerConfig(1.0, 0.9), seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED + 2)
    groups = [rng.integers(0, cfg.vocab, n).tolist() for n in (300, 257)]
    run = Script(torch, cfg)

    _reset_launches()                                       # dense path starts here
    # (a) the linear dense pool; a paged worker takes the cross-layout moves
    wd = RolloutWorker(cfg, params, worker_id=0, capacity=2048, max_slots=8, paged=False, **kw)
    wp = RolloutWorker(cfg, params, worker_id=1, capacity=2048, max_slots=8, page_size=16,
                       **kw)
    pool_gb = sum(t.numel() * t.element_size() for c in wd.pool["blocks"].values()
                  for t in c.values()) / 1e9
    for sid in range(8):
        run.timed("prefill", lambda: wd.prefill(sid, groups[sid // 4]))
    if wd.dispatch_stats()["reused_tokens"] == 0:
        raise AssertionError(f"lane-prefix reuse did not engage: {wd.dispatch_stats()}")
    run.decode(wd, list(range(8)), 64)
    run.timed("extend", lambda: wd.extend(0, rng.integers(0, cfg.vocab, 48).tolist()))
    wd.preempt(1)
    run.decode(wd, [0, 2, 3, 4, 5, 6, 7], 8)
    run.decode(wd, [1], 8)                                  # resume
    pkg = run.timed("migrate", lambda: wd.migrate_out(2))   # dense -> paged
    run.timed("migrate", lambda: wp.migrate_in(pkg))
    run.decode(wp, [2], 16)
    pkg = run.timed("migrate", lambda: wp.migrate_out(2))   # paged -> dense
    run.timed("migrate", lambda: wd.migrate_in(pkg))
    run.decode(wd, [2], 8)
    run.timed("prefill", lambda: wd.prefill(8, rng.integers(0, cfg.vocab, 200).tolist()))
    if wd.pool_grows != 1 or wd.max_slots != 16:            # the ninth concurrent lane
        raise AssertionError(f"the dense pool did not double once: {wd.pool_grows} grows, "
                             f"{wd.max_slots} lanes")
    ck = run.timed("checkpoint", lambda: wd.checkpoint_out(3))
    run.timed("checkpoint", lambda: wd.migrate_in(dict(ck, seq_id=100)))
    a = run.decode(wd, [100], 8)[100]
    b = run.decode(wd, [3], 8)[3]
    if a != b:
        raise AssertionError(f"restored lane diverged from its source: {a} vs {b}")
    run.decode(wd, list(wd.store), 8)
    run.release_all(wd, wp)
    launches_a = _read_launches(torch)
    steps_a = wd.decode_steps
    if launches_a["decode_attention"] < cfg.n_layers * steps_a:
        raise AssertionError(f"(a) decode_attention launched {launches_a} times for "
                             f"{steps_a} dense decode steps x {cfg.n_layers} layers")
    if launches_a["paged_decode_attention"] < cfg.n_layers * wp.decode_steps:
        raise AssertionError(f"(a) paged_decode_attention launched {launches_a} times for "
                             f"{wp.decode_steps} paged decode steps")
    log(f"[dense] (a) dense pool {pool_gb:.2f} GB at 8 lanes (doubled to "
        f"{wd.max_slots}); {wd.dispatch_stats()['reused_tokens']} prompt tokens reused by "
        f"lane copies; decode steps dense {steps_a}, paged {wp.decode_steps}; launches "
        f"{launches_a}")
    del wd, wp, pkg, ck
    torch.cuda.empty_cache()

    # (b) the sliding-window variant: a ring, dense by force
    wcfg = get_config("qwen3_1_7b").with_sliding_window(LONG_CONTEXT_WINDOW)
    ws = RolloutWorker(wcfg, params, worker_id=2, capacity=LONG_CONTEXT_WINDOW, max_slots=4,
                       **kw)
    if ws._paged:
        raise AssertionError("a sliding-window config must take the dense plane")
    ring_gb = sum(t.numel() * t.element_size() for c in ws.pool["blocks"].values()
                  for t in c.values()) / 1e9
    before = _read_launches(torch)
    run.timed("prefill_9000", lambda: ws.prefill(20, rng.integers(0, cfg.vocab, 9000).tolist()))
    run.timed("prefill_3000", lambda: ws.prefill(21, rng.integers(0, cfg.vocab, 3000).tolist()))
    run.decode(ws, [20, 21], 32)
    run.timed("extend_per_token", lambda: ws.extend(20, rng.integers(0, cfg.vocab, 16).tolist()))
    run.decode(ws, [20], 4)
    run.release_all(ws)
    launches = _read_launches(torch)                        # dense path ends
    steps_b = ws.decode_steps + ws.absorbed_tokens
    if launches["decode_attention"] - before["decode_attention"] < cfg.n_layers * steps_b:
        raise AssertionError(f"(b) decode_attention launched "
                             f"{launches['decode_attention'] - before['decode_attention']} "
                             f"times for {steps_b} steps x {cfg.n_layers} layers")
    if launches["paged_decode_attention"] != before["paged_decode_attention"]:
        raise AssertionError("(b) the paged kernel ran on the sliding-window plane")
    log(f"[dense] (b) window {LONG_CONTEXT_WINDOW}: ring pool {ring_gb:.2f} GB at 4 lanes; "
        f"admitted 9,000 + 3,000 tokens by full forward (flash); decode steps "
        f"{ws.decode_steps}, per-token extend steps {ws.absorbed_tokens}; decode_attention "
        f"launches {launches['decode_attention'] - before['decode_attention']}")
    run.report("dense", steps_a + ws.decode_steps)
    del ws, params
    torch.cuda.empty_cache()
    return launches["decode_attention"]


# ---------------------------------------------------------------- phase 6
def _profile_step(torch, cfg, params, paged):
    """Where one decode step's time goes at full width: 8 lanes of ~1,024
    tokens.  Wall time of ``n`` steps without the profiler, then the device
    time of the same number of steps by kernel under torch.profiler."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.engine.sampler import SamplerConfig
    from repro_torch.engine.worker import RolloutWorker
    from repro_torch.models.model import param_count

    tag = "paged" if paged else "dense"
    w = RolloutWorker(cfg, params, capacity=2048, page_size=16, max_slots=8, paged=paged,
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
    attn = sum(e.self_device_time_total for e in kern
               if f"{tag}_decode_kernel" in e.key) / 1e3 / n
    item = params["tok_embed"].element_size()
    # KV read by the n profiled steps, per step: each lane's context grows by
    # one token a step, so the mean context is context + 8 * (n + 1) / 2
    kv_bytes = ((context + 8 * (n + 1) / 2) * cfg.n_layers
                * 2 * cfg.n_kv_heads * cfg.hd * item)
    weight_bytes = param_count(params) * item
    bound = (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"[profile] {tag} decode step, 8 lanes, {context / 8:.0f} tokens of context each: "
        f"wall {wall / n:.3f} ms, device busy {busy:.3f} ms ({100 * busy * n / wall:.1f}% "
        f"of wall), {sum(e.count for e in kern) / n:.0f} device launches; {tag} decode "
        f"kernel {attn:.3f} ms ({100 * attn / busy if busy else 0:.1f}% of busy); bound "
        f"{bound:.3f} ms (weights {weight_bytes / 1e9:.3f} GB + KV {kv_bytes / 1e9:.3f} GB "
        f"read once at 3.35 TB/s)")
    if busy == 0:
        log("[profile] torch.profiler recorded no device time on this machine")
    for e in kern[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / n:8.3f} ms/step "
            f"{e.count / n:6.0f}x  {e.key[:90]}")
    del w
    torch.cuda.empty_cache()


def phase_profile(torch):
    cfg, params = _full_width(torch)
    for paged in (True, False):
        _profile_step(torch, cfg, params, paged)
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 7
def _jamba_model(torch):
    """jamba-v0.1-52b at its published widths, cut to one period of its four
    (8 layers: 7 Mamba, 1 attention, 4 MoE, 4 MLP), random weights from the
    seed: the four periods' 51.6 B parameters (103 GB in bf16) do not fit
    on one 80 GB card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, param_count
    cfg = dataclasses.replace(get_config("jamba_v0_1_52b"), n_periods=1)
    params, ms = sync_ms(torch, lambda: init_params(cfg, seed=SEED, device="cuda"))
    log(f"[model] {cfg.name}, 1 period of 4: {cfg.n_layers} layers "
        f"({' '.join(cfg.block_pattern)}), d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff {cfg.d_ff}, di "
        f"{cfg.ssm_expand * cfg.d_model}, N {cfg.ssm_state_dim}, {cfg.n_experts} experts "
        f"top-{cfg.top_k}, vocab {cfg.vocab}, {cfg.dtype}; "
        f"{param_count(params) / 1e9:.3f} B params, {_nbytes(params) / 1e9:.2f} GB "
        f"(init {ms:.0f} ms)")
    return cfg, params


def _nbytes(tree):
    from repro_torch.models.model import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _lane_state(w, sid):
    """Copies of one lane's KV at its resident positions and its Mamba state."""
    seq = w.store[sid]
    n = len(seq.tokens)
    out = {}
    for key, c in w.pool["blocks"].items():
        for name, leaf in c.items():
            if name in ("h", "conv"):
                lane = leaf[:, seq.slot]
            elif w._paged:
                lane = leaf[:, w.lane_pages[seq.slot]]
                lane = lane.reshape((lane.shape[0], -1) + tuple(lane.shape[3:]))[:, :n]
            else:
                lane = leaf[:, seq.slot, :n]
            out[f"{key}/{name}"] = lane.clone()
    return out


def _same_state(torch, label, want, got):
    bad = [k for k in want if not torch.equal(want[k], got[k])]
    if bad or not all(bool(t.float().isfinite().all()) for t in got.values()):
        raise AssertionError(f"{label}: lane state differs in {bad} or is not finite")


def phase_jamba(torch):
    """The hybrid Mamba + MoE slice at full width, one period: two paged
    workers and a dense one sharing the params.  Whole-prompt admission (MoE
    is not chunk-safe) runs the scan kernel once per Mamba layer.  Returns
    the launch counts of the main path."""
    import numpy as np
    from repro_torch.engine.paging import check_block_conservation
    from repro_torch.engine.sampler import SamplerConfig
    from repro_torch.engine.worker import RolloutWorker

    torch.cuda.reset_peak_memory_stats()
    cfg, params = _jamba_model(torch)
    kw = dict(capacity=4096, max_slots=8, sampler=SamplerConfig(1.0, 0.9), seed=SEED,
              device="cuda")
    w0 = RolloutWorker(cfg, params, worker_id=0, page_size=16, **kw)
    w1 = RolloutWorker(cfg, params, worker_id=1, page_size=16, **kw)
    wd = RolloutWorker(cfg, params, worker_id=2, paged=False, **kw)
    if not w0._paged or w0._chunked or w0._reuse or wd._paged:
        raise AssertionError("jamba must take paged whole-prompt admission, no radix reuse")
    n_mamba = cfg.n_periods * sum(k.startswith("mamba") for k in cfg.block_pattern)
    rng = np.random.default_rng(SEED + 3)
    groups = [rng.integers(0, cfg.vocab, n).tolist() for n in (2048, 1500)]
    run = Script(torch, cfg)

    _reset_launches()                                       # jamba path starts here
    for sid in range(8):
        run.timed("prefill", lambda: w0.prefill(sid, groups[sid // 4]))
    admissions = 8
    run.decode(w0, list(range(8)), 64)
    run.timed("extend_per_token", lambda: w0.extend(0, rng.integers(0, cfg.vocab, 16).tolist()))
    w0.preempt(1)
    held = _lane_state(w0, 1)
    run.decode(w0, [0, 2, 3, 4, 5, 6, 7], 8)
    _same_state(torch, "preempted lane", held, _lane_state(w0, 1))   # masked: state kept
    run.decode(w0, [1], 8)                                  # resume
    for src, dst, leg in ((w0, w1, "paged -> paged"), (w1, wd, "paged -> dense"),
                          (wd, w0, "dense -> paged")):
        held = _lane_state(src, 2)
        pkg = run.timed("migrate", lambda: src.migrate_out(2))
        run.timed("migrate", lambda: dst.migrate_in(pkg))
        _same_state(torch, f"migration {leg}", held, _lane_state(dst, 2))
        run.decode(dst, [2], 8)
    ck = run.timed("checkpoint", lambda: w0.checkpoint_out(3))
    run.timed("checkpoint", lambda: w1.migrate_in(dict(ck, seq_id=100)))
    _same_state(torch, "checkpoint restore", _lane_state(w0, 3), _lane_state(w1, 100))
    run.decode(w1, [100], 8)
    run.decode(w0, [3], 8)
    run.release_all(w0, w1, wd)
    launches = _read_launches(torch)                        # jamba path ends
    paged_steps = sum(w.decode_steps + w.absorbed_tokens for w in (w0, w1))
    dense_steps = wd.decode_steps + wd.absorbed_tokens
    want = {"mamba_scan": n_mamba * admissions, "paged_decode_attention": paged_steps,
            "decode_attention": dense_steps}            # one attention layer a period
    if launches != want:
        raise AssertionError(f"jamba launches {launches}, want {want}")
    for i, w in enumerate((w0, w1)):
        bad = check_block_conservation(w.dispatch_stats())
        if bad:
            raise AssertionError(f"jamba worker {i}: {bad}")
    log(f"[jamba] {admissions} admissions (prompts of {len(groups[0])} and {len(groups[1])} "
        f"tokens, two groups of 4) by whole-prompt forward; decode steps paged {w0.decode_steps} + "
        f"{w1.decode_steps}, dense {wd.decode_steps}; per-token extend steps "
        f"{w0.absorbed_tokens}; launches {launches} (mamba_scan = {n_mamba} x "
        f"{admissions} admissions; decode kernels = 1 attention layer x each step); "
        f"lane state held exactly through preemption, 3 migrations and a checkpoint")
    steps = w0.decode_steps + w1.decode_steps + wd.decode_steps
    run.report("jamba", steps)
    del w0, w1, wd, pkg, ck
    torch.cuda.empty_cache()
    _profile_jamba(torch, cfg, params)
    del params
    torch.cuda.empty_cache()
    return launches


def _device_time(prof, n):
    """(kernel events by device time, device-busy ms per step) of a profile."""
    from torch.autograd import DeviceType
    kern = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    return kern, sum(e.self_device_time_total for e in kern) / 1e3 / n


def _profile_jamba(torch, cfg, params):
    """One 2,048-token admission and one decode step at 8 lanes of ~2,050
    tokens: wall time, device busy time, launches, the scan kernel's share,
    beside the step's bound (every weight read once: the MoE einsum runs
    all 16 experts)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.engine.sampler import SamplerConfig
    from repro_torch.engine.worker import RolloutWorker

    w = RolloutWorker(cfg, params, capacity=4096, page_size=16, max_slots=8,
                      sampler=SamplerConfig(1.0, 0.9), seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg.vocab, 2048).tolist() for _ in range(8)]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    w.prefill(0, prompts[0])                                # warm-up
    _, wall = sync_ms(torch, lambda: w.prefill(1, prompts[1]))
    with profile(activities=acts) as prof:
        w.prefill(2, prompts[2])
        torch.cuda.synchronize()
    kern, busy = _device_time(prof, 1)
    scan = [e for e in kern if "mamba_scan_kernel" in e.key]
    scan_ms = sum(e.self_device_time_total for e in scan) / 1e3
    log(f"[profile] jamba admission, {len(prompts[2])} tokens: wall {wall:.3f} ms, device "
        f"busy {busy:.3f} ms ({100 * busy / wall:.1f}% of wall), "
        f"{sum(e.count for e in kern)} device launches; mamba_scan_kernel {scan_ms:.3f} ms "
        f"in {sum(e.count for e in scan)} launches "
        f"({100 * scan_ms / busy if busy else 0:.1f}% of busy)")
    for e in kern[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x  {e.key[:90]}")
    for sid in range(3, 8):
        w.prefill(sid, prompts[sid])
    lanes, n = list(range(8)), 8
    w.decode(lanes, 2)                                      # warm-up
    context = sum(len(w.store[s].tokens) for s in lanes)
    _, wall = sync_ms(torch, lambda: w.decode(lanes, n))
    with profile(activities=acts) as prof:
        w.decode(lanes, n)
        torch.cuda.synchronize()
    kern, busy = _device_time(prof, n)
    attn = sum(e.self_device_time_total for e in kern if "paged_decode_kernel" in e.key)
    # bound: every weight once (the embedding table: 8 rows), the attention
    # layer's KV at the mean context of the profiled steps, and the Mamba
    # state read and written
    item = params["tok_embed"].element_size()
    weight_bytes = (_nbytes(params) - _nbytes(params["tok_embed"])
                    + len(lanes) * cfg.d_model * item)
    kv_bytes = ((context + len(lanes) * (n + 1) / 2) * cfg.n_periods
                * 2 * cfg.n_kv_heads * cfg.hd * item)
    state_bytes = 2 * _nbytes({k: c for k, c in w.pool["blocks"].items() if "mamba" in k})
    bound = (weight_bytes + kv_bytes + state_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"[profile] jamba decode step, 8 lanes, {context / 8:.0f} tokens of context each: "
        f"wall {wall / n:.3f} ms, device busy {busy:.3f} ms ({100 * busy * n / wall:.1f}% "
        f"of wall), {sum(e.count for e in kern) / n:.0f} device launches; paged decode "
        f"kernel {attn / 1e3 / n:.3f} ms; bound {bound:.3f} ms (weights "
        f"{weight_bytes / 1e9:.3f} GB + KV {kv_bytes / 1e9:.3f} GB + Mamba state "
        f"{state_bytes / 1e9:.3f} GB read once at 3.35 TB/s)")
    for e in kern[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / n:8.3f} ms/step "
            f"{e.count / n:6.0f}x  {e.key[:90]}")
    del w
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 8
def phase_reference(torch):
    """Teacher-forced decode logits, card (kernels) vs CPU (plain versions):
    the paged plane, and a sliding-window ring (window 32, a 50-token prompt
    admitted by a full forward, so the ring has wrapped)."""
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
    err = _teacher_forced(torch, cfg, params, gparams, pools, torch.tensor([[0], [28]]))
    log(f"[reference] reduced {cfg.name} (2 layers, f32), paged: 8 teacher-forced decode "
        f"steps, logits card vs CPU max |err| {err:.2e} (tol 1e-4)")
    wcfg = cfg.with_sliding_window(32)
    prompt = torch.tensor([list(range(3, 53))])
    for dev, prm in (("cpu", params), ("cuda", gparams)):
        _, _, lane = M.forward_full(wcfg, prm, {"tokens": prompt.to(dev)}, capacity=32)
        pools[dev] = M.write_slot(M.init_cache(wcfg, 2, 32, dev), lane, 1)
    err = _teacher_forced(torch, wcfg, params, gparams, pools, torch.tensor([[0], [52]]))
    log(f"[reference] reduced {cfg.name} (2 layers, f32), sliding-window ring (window 32, "
        f"50-token prompt): 8 teacher-forced decode steps, logits card vs CPU max |err| "
        f"{err:.2e} (tol 1e-4)")
    _reference_jamba(torch)


def _reference_jamba(torch):
    """The reduced jamba period (f32): a 40-token whole-prompt admission into
    a paged lane (the scan kernel on the card, its plain version on the CPU),
    its Mamba state and KV card vs CPU, then teacher-forced decode logits."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba_scan
    from repro_torch.models import model as M
    from repro_torch.models.model import init_params, tree_to

    cfg = get_config("jamba_v0_1_52b").reduced(n_periods=1)
    params = init_params(cfg, seed=SEED, device="cpu")
    gparams = tree_to(params, "cuda")
    prompt = torch.tensor([[(7 * i + 3) % cfg.vocab for i in range(40)]])
    row = torch.tensor([3, 5, 7, 0], dtype=torch.int32)
    pools = {}
    scans = mamba_scan.launches["mamba_scan"]
    for dev, prm in (("cpu", params), ("cuda", gparams)):
        _, _, lane = M.forward_full(cfg, prm, {"tokens": prompt.to(dev)}, capacity=40)
        pools[dev] = M.paged_write_lane(M.init_paged_pool(cfg, 2, 9, 16, 4, dev), lane, 1,
                                        row, 40)
    torch.cuda.synchronize()
    if mamba_scan.launches["mamba_scan"] - scans != 7:
        raise AssertionError("the card's admission did not run the scan kernel 7 times")
    state_err = max(float((pools["cuda"]["blocks"][k][n].cpu() - c[n]).abs().max())
                    for k, c in pools["cpu"]["blocks"].items() for n in c
                    if n in ("h", "conv"))
    if not state_err < 1e-4:
        raise AssertionError(f"jamba admission state card vs CPU max |err| {state_err}")
    err = _teacher_forced(torch, cfg, params, gparams, pools, torch.tensor([[0], [39]]))
    log(f"[reference] reduced {cfg.name} (1 period, f32: 7 Mamba, 4 MoE): 40-token "
        f"admission, Mamba state card vs CPU max |err| {state_err:.2e} (tol 1e-4); 8 "
        f"teacher-forced decode steps, logits card vs CPU max |err| {err:.2e} (tol 1e-4)")


def _teacher_forced(torch, cfg, params, gparams, pools, tok):
    from repro_torch.models import model as M
    err = 0.0
    for _ in range(8):
        lc, _ = M.decode_step(cfg, params, pools["cpu"], tok)
        lg, _ = M.decode_step(cfg, gparams, pools["cuda"], tok.cuda())
        err = max(err, float((lg.cpu() - lc).abs().max()))
        tok = lc.argmax(-1, keepdim=True)
    if not err < 1e-4:
        raise AssertionError(f"{cfg.name} window {cfg.sliding_window}: decode logits card "
                             f"vs CPU max |err| {err} >= 1e-4")
    return err


# ---------------------------------------------------------------- phase 9
RUNTIME_CAPACITY = 512               # lanes of 32 pages of 16 tokens; the workload needs 285
CAPTURE_EVERY = 2_500                # keep the inputs of every 2,500th decode-kernel call


class _Capture:
    """While the runtime runs, keeps a copy of the inputs of every
    ``CAPTURE_EVERY``-th call of a decode kernel's wrapper: the inputs the
    runtime's decode steps give it, masked lanes at their frozen positions
    included.  The wrapper is called as before and counts its own launches;
    the copy costs one call in 2,500 a few device copies."""

    def __init__(self, module, name):
        self.module, self.name, self.calls, self.kept = module, name, 0, []
        self.launch = getattr(module, name)

    def __enter__(self):
        def capturing(*args):
            self.calls += 1
            if self.calls % CAPTURE_EVERY == 0:
                self.kept.append([a.clone() for a in args])
            return self.launch(*args)

        setattr(self.module, self.name, capturing)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.launch)


def _hold_kept(torch, tag, kept):
    """The kept live calls of one run against the plain version."""
    if not kept:
        raise AssertionError(f"[runtime] {tag}: no decode-kernel call was kept")
    err, limit, _ = _held(torch, f"[runtime] {tag} live calls", kept)
    q, *_, vl = kept[-1]
    log(f"[runtime] {tag}: {len(kept)} live decode-kernel calls (every {CAPTURE_EVERY}th; "
        f"the last: q {tuple(q.shape)}, cache {tuple(kept[-1][1].shape)}, valid_len "
        f"{sorted(vl.tolist())}) against the plain version, cache poisoned where no lane "
        f"reads: max|err| {err:.3e} (tol {limit:.3e})")
    return err


def _hold_runtime_shapes(torch, paged_args, dense_args):
    """Both decode kernels at the runtime's shapes (taken from a kept live
    call of each) on drawn inputs whose lengths span the whole lane, so that
    every piece of the split the wrapper picks, the ragged last one too,
    holds tokens: lane 0 full, lane 1 one token into the last piece, lane 2
    exactly one piece, lane 3 one token, the rest drawn in [1, C]."""
    from repro_torch.kernels import decode_attention as kernel
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs = {}
    for label, args in (("paged_decode_attention", paged_args),
                        ("decode_attention", dense_args)):
        q = args[0]
        B, KV, G, hd = q.shape
        ps, C = (args[1].shape[1], args[3].shape[1] * args[1].shape[1]) if len(args) == 5 \
            else (1, args[1].shape[1])
        L, n_split = kernel._split_plan(B, KV, C, ps, sms)
        vl = torch.randint(1, C + 1, (B,), generator=gen, device="cuda", dtype=torch.int32)
        vl[:4] = torch.tensor([C, min(C, (n_split - 1) * L + 1), min(C, L), 1])
        if len(args) == 5:
            q, k, v, pt, vl = _paged_inputs(torch, gen, q.dtype, 1, B, KV, G, hd, ps, C // ps,
                                            B * (C // ps) + 1, C, vl=vl)
            inputs = (q[0], k[0], v[0], pt, vl)
        else:
            q, k, v = _dense_inputs(torch, gen, q.dtype, 1, B, C, KV, G, hd)
            inputs = (q[0], k[0], v[0], vl)
        err, limit, _ = _hold_decode(torch, f"[runtime] {label} at the runtime's shape", inputs)
        errs[label] = err
        log(f"[runtime] {label} at the runtime's shape: B={B} KV={KV} G={G} hd={hd} "
            f"ps={ps} C={C}, n_split {n_split} (pieces of {L}, the last "
            f"{C - (n_split - 1) * L}), valid_len sum {int(vl.sum())} max {int(vl.max())}; "
            f"max|err| {err:.3e} (tol {limit:.3e}, cache poisoned where no lane reads)")
    return errs


def _runtime_run(torch, tag, cfg, params, batch, predictor, config, faults=None,
                 profile_run=False):
    """One RolloutRuntime run on the card beside its analytic twin: counts
    zeroed just before the run and read just after; the engine's trace held to
    the sim's; the decode kernel's inputs kept every ``CAPTURE_EVERY``-th
    call.  Returns (result, launches, checkpoints written, kept inputs)."""
    import copy
    from repro_torch.engine.runtime import make_runtime, run_on_sim, split_restores
    from repro_torch.kernels import decode_attention as kernel

    sim = run_on_sim(copy.deepcopy(batch), predictor, n_workers=2, config=config,
                     faults=faults)
    rt = make_runtime(cfg, params, batch, predictor, n_workers=2, config=config,
                      capacity=RUNTIME_CAPACITY, faults=faults)
    written = {}
    checkpoint = rt.backend.checkpoint

    def recording(traj):
        checkpoint(traj)
        if traj.traj_id in rt.backend.ckpts:
            written[traj.traj_id] = rt.backend.ckpts[traj.traj_id]

    rt.backend.checkpoint = recording
    name = "decode_attention" if config.paged is False else "paged_decode_attention"
    torch.cuda.synchronize()
    with _Capture(kernel, name) as capture:
        _reset_launches()                                   # the run starts here
        if profile_run:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                res = rt.run()
                torch.cuda.synchronize()
        else:
            res = rt.run()
        launches = _read_launches(torch)                    # the run ends
    if not all(t.finished for t in batch):
        raise AssertionError(f"[runtime] {tag}: unfinished trajectories")
    if res.sanitizer.get("violations") != 0 or res.sanitizer.get("block_conservation") != "ok":
        raise AssertionError(f"[runtime] {tag}: sanitizer {res.sanitizer}")
    if res.total_tokens != sum(t.payload.total_tokens for t in batch):
        raise AssertionError(f"[runtime] {tag}: decoded {res.total_tokens} tokens")
    if faults is None:
        same = res.trace == sim.trace
    else:
        same = split_restores(res.trace) == split_restores(sim.trace)
    if not same or res.makespan != sim.makespan or len(res.trace) == 0:
        raise AssertionError(f"[runtime] {tag}: engine trace ({len(res.trace)} events, "
                             f"makespan {res.makespan}) differs from the sim's "
                             f"({len(sim.trace)}, {sim.makespan})")
    stats = [view.engine.dispatch_stats() for view in rt.workers]
    log(f"[runtime] {tag}: wall {res.wall_time * 1e3:.1f} ms, {rt.backend.wall * 1e3:.1f} ms "
        f"of it inside the workers' calls (host clock, nothing added to the run); "
        f"{res.total_tokens} real tokens decoded ({res.total_tokens / res.wall_time:.1f} "
        f"tokens/s); decode calls {[s['decode_calls'] for s in stats]}, decode steps "
        f"{[s['decode_steps'] for s in stats]}, decode wall "
        f"{[round(s['decode_wall_s'] * 1e3, 1) for s in stats]} ms (the workers' own clock, "
        f"to the one host copy of the emitted tokens a call, which also waits for work "
        f"queued before the call); {len(res.trace)} trace events == sim, virtual makespan "
        f"{res.makespan:.6f} s, preemptions {res.preemptions}, migrations "
        f"{res.migrations}; launches {launches}")
    if profile_run:
        # the run's raw device events: key_averages() would take minutes over
        # its 1.6 M launches
        from torch.autograd import DeviceType
        device = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        busy = sum(e.duration_ns() for e in device) / 1e6
        log(f"[runtime] {tag} under torch.profiler: device busy {busy:.1f} ms of the "
            f"run's {res.wall_time * 1e3:.1f} ms wall ({100 * busy / (res.wall_time * 1e3):.1f}%), "
            f"{len(device)} device events")
        if busy == 0:
            log("[runtime] torch.profiler recorded no device time on this machine")
    return res, launches, written, capture.kept


def phase_runtime(torch, smi):
    """The control plane over the port's workers on the card: qwen3-1.7b at
    full width, two RolloutWorkers driven by the orchestrator through
    EngineBackend on the reference harness's workload, each run held to the
    sim's decision trace, and the decode kernels held to their plain versions
    on live calls of each run and at the runtime's shapes.  Returns the
    decode kernels' launches per run and their largest errors there."""
    import copy
    import math
    import os
    import tempfile
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core.faults import FaultPlan
    from repro_torch.engine.runtime import RuntimeConfig, build_workbench, run_on_sim
    from repro_torch.models import model as M

    cfg, params = _full_width(torch)
    log(f"[runtime] {smi}")
    base = dict(scheduler="pps", migration=True, max_active=2, quantum=8,
                link_bandwidth=math.inf, trace=True, seed=5, sanitize=True)
    out = {}
    batch, predictor = build_workbench(n_prompts=6, group_size=4, seed=5)
    res, launches, _, kept = _runtime_run(torch, "paged", cfg, params, batch, predictor,
                                          RuntimeConfig(**base))
    if res.preemptions == 0 or res.migrations == 0:
        raise AssertionError(f"[runtime] paged: preemptions {res.preemptions}, "
                             f"migrations {res.migrations}: the parity does not bite")
    out["paged"] = launches["paged_decode_attention"]
    errs = {"paged_decode_attention": [_hold_kept(torch, "paged", kept)]}
    paged_args = kept[-1]

    batch, predictor = build_workbench(n_prompts=6, group_size=4, seed=5)
    _, launches, _, kept = _runtime_run(torch, "dense", cfg, params, batch, predictor,
                                        RuntimeConfig(**dict(base, paged=False,
                                                             migration=False)),
                                        profile_run=True)
    out["dense"] = launches["decode_attention"]
    errs["decode_attention"] = [_hold_kept(torch, "dense", kept)]
    for name, err in _hold_runtime_shapes(torch, paged_args, kept[-1]).items():
        errs[name].append(err)
    del paged_args, kept

    batch, predictor = build_workbench(n_prompts=6, group_size=4, seed=5)
    horizon = run_on_sim(copy.deepcopy(batch), predictor, n_workers=2,
                         config=RuntimeConfig(**base)).makespan
    faults = FaultPlan.chaos(seed=5, n_workers=2, horizon=horizon)
    with tempfile.TemporaryDirectory() as tmp:
        res, launches, written, kept = _runtime_run(
            torch, "chaos", cfg, params, batch, predictor,
            RuntimeConfig(**dict(base, checkpoint_dir=tmp)), faults=faults)
        if res.worker_deaths < 1 or res.recoveries < 1:
            raise AssertionError(f"[runtime] chaos: deaths {res.worker_deaths}, "
                                 f"recoveries {res.recoveries}")
        if not written or len(os.listdir(tmp)) != len(written):
            raise AssertionError(f"[runtime] chaos: {len(written)} checkpoints held, "
                                 f"{len(os.listdir(tmp))} persisted")
        for tid, pkg in written.items():
            tree = {"pages": pkg["pages"], "state": pkg["state"], "key": pkg["key"]}
            back = ckpt.restore(os.path.join(tmp, f"traj_{tid:05d}"), tree)
            if not (back["key"] == pkg["key"]).all():
                raise AssertionError(f"[runtime] chaos: checkpoint of {tid}: key differs")
            for part in ("pages", "state"):
                for a, b in zip(M.tree_leaves(back[part]), M.tree_leaves(pkg[part])):
                    if a.dtype != b.dtype or not torch.equal(a, b):
                        raise AssertionError(f"[runtime] chaos: checkpoint of {tid} "
                                             f"loads back different")
    log(f"[runtime] chaos: {res.worker_deaths} worker death(s), {res.recoveries} "
        f"recoveries, {res.tool_retries} tool retries; {len(written)} checkpoints "
        f"persisted and loaded back equal")
    out["chaos"] = launches["paged_decode_attention"]
    errs["paged_decode_attention"].append(_hold_kept(torch, "chaos", kept))
    out["max_abs_err"] = {name: max(e) for name, e in errs.items()}
    del params, kept
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                          "qwen3-1.7b", "--requests", "8", "--steps", "2"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    lines = cli.stdout.strip().splitlines()
    if cli.returncode != 0 or not any("served 8 trajectories on cuda" in ln for ln in lines):
        raise AssertionError(f"[runtime] serve CLI exited {cli.returncode}:\n"
                             f"{cli.stdout[-2000:]}\n{cli.stderr[-2000:]}")
    for ln in lines:
        if ln.startswith(("served", "virtual makespan", "preemptions")):
            log(f"[runtime] serve: {ln}")
    log(f"[runtime] serve CLI (a process of its own, qwen3-1.7b reduced to 2 layers, "
        f"f32): exit 0 in {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False      # f32 matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    try:
        info = timed("device", phase_device, torch)
        timed("build", phase_build)
        rows = timed("kernels", phase_kernels, torch)
        paged_launches = timed("slice", phase_slice, torch)
        dense_launches = timed("dense", phase_dense, torch)
        timed("profile", phase_profile, torch)
        jamba_launches = timed("jamba", phase_jamba, torch)
        timed("reference", phase_reference, torch)
        runtime = timed("runtime", phase_runtime, torch, info["smi"])
        if min(runtime[run] for run in ("paged", "dense", "chaos")) == 0:
            raise AssertionError(f"a decode kernel never launched under the runtime: "
                                 f"{runtime}")
    except Exception:                                  # a failed phase fails the run
        traceback.print_exc()
        return 1
    csrc = "src/repro_torch/kernels/csrc"
    kernels = [                                        # the main paths' dtype: bf16
        {"name": "paged_decode_attention", "route": "cuda",
         "source": f"{csrc}/paged_decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:112",
         "launches": paged_launches,
         "runtime_launches": runtime["paged"] + runtime["chaos"],
         "runtime_max_abs_err": runtime["max_abs_err"]["paged_decode_attention"],
         **rows["paged_decode_attention"]["bfloat16"]},
        {"name": "decode_attention", "route": "cuda",
         "source": f"{csrc}/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:159",
         "launches": dense_launches, "runtime_launches": runtime["dense"],
         "runtime_max_abs_err": runtime["max_abs_err"]["decode_attention"],
         **rows["decode_attention"]["bfloat16"]},
        {"name": "mamba_scan", "route": "cuda",
         "source": f"{csrc}/mamba_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan.py:55",
         "launches": jamba_launches["mamba_scan"], **rows["mamba_scan"]["bfloat16"]},
    ]
    log(f"[device] {info['smi']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
