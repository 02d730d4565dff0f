#!/usr/bin/env python3
"""Time the decode-attention and selective-scan kernels of several checkouts on
one GPU, each with three yardsticks, so that two versions are compared under
the same clocks.

    python3 tools/decode_timers.py --tree parent=PATH --tree change=. \
        --order parent,change,change,parent [--rows PREFIXES] [--out FILE]

Each checkout's ``src/repro_torch`` is imported in a process of its own, in
the order given (its kernels build into that checkout's ``build/``).  The
inputs are those of ``chip_smoke.py`` phase 3 (its seed, shapes and 28
periods, drawn in its order): the paged kernel at B 8, 128 pages of 16, and
the dense kernel at B 8, C 2,048 and at the ring's B 4, C 8,192, in bf16 and
f32; the selective scan at one jamba admission (B 1, S 2,048, di 8,192, N
16; x/B/C bf16, then f32: phase 3's two timed rows), and the scan's backward
at the same two rows (phase 3's ``_scan_bwd_rows`` inputs), whose
``profiler`` column is the sum of its launches and whose ``split`` gives each
launch's device ms under torch.profiler.  ``--rows scan_bwd`` (prefixes,
comma-separated) times only the rows named so.  This script's own code (and
``chip_smoke.py`` beside it) makes the inputs and times the calls, so every
checkout is held to one yardstick:

- ``held``: CUDA events while a spin kernel holds the stream as the host
  enqueues (``chip_smoke.event_ms``): the device's time;
- ``unheld``: CUDA events without the hold: the device's time or the host's
  rate of enqueueing, whichever is longer;
- ``profiler``: the kernel's device time per launch under torch.profiler,
  as ``chip_smoke.py`` phases 6 and 7 read it.

Beside them: the host's ms to enqueue one kernel call, and the library call
(gather + SDPA for the paged kernel, SDPA for the dense one; none for the
scan) held and unheld.
Prints a table, then the card's name and power limit, then one JSON object
of every run as the last line (also written to ``--out``).  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("held_ms", "unheld_ms", "profiler_ms", "host_ms", "library_held_ms",
          "library_unheld_ms")


def _profiled_ms(torch, fn, n_iter, kernel_name, tries=3):
    """Mean device ms per launch of the kernels named ``kernel_name`` over
    ``n_iter`` calls under torch.profiler, after warm-up.  The profiler can
    drop device events from a window (it once reported 93 of 112 launches on
    the H100); such a window is profiled again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n_iter):
                fn(i)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and kernel_name in e.key]
        count = sum(e.count for e in events)
        if count == n_iter:
            return sum(e.self_device_time_total for e in events) / 1e3 / count
        print(f"decode_timers: torch.profiler saw {count} launches of {kernel_name}, not "
              f"{n_iter}; profiling again", file=sys.stderr, flush=True)
    raise RuntimeError(f"torch.profiler saw {count} launches of {kernel_name}, not {n_iter}, "
                       f"in {tries} windows")


def _bwd_row(torch, cs, args, g_y, g_h):
    """The scan's backward at one of phase 3's timed rows: its largest |err|
    against the plain backward, held and unheld events over 20 calls, and
    each launch's device ms under torch.profiler."""
    from repro_torch.kernels import mamba_scan as scan
    from repro_torch.kernels import ref
    got = scan.mamba_scan_bwd(*args, g_y, g_h)
    want = ref.mamba_scan_bwd_ref(*(t.float() for t in args), g_y, g_h)
    err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
    del got, want
    call = lambda i: scan.mamba_scan_bwd(*args, g_y, g_h)   # noqa: E731
    held, host = cs.event_ms(torch, call, 20)
    split = cs.launch_split(torch, call, 20, cs.BWD_LAUNCHES)
    return {"max_abs_err": err, "held_ms": held,
            "unheld_ms": cs.event_ms(torch, call, 20, hold=False)[0],
            "profiler_ms": sum(split.values()), "host_ms": host, "library_held_ms": None,
            "library_unheld_ms": None, "split": split}


def _row(torch, cs, P, kernel_name, kernel_fn, plain_fn, library_fn):
    """One shape: the kernel's max |err| against its plain version on period
    0, then the three yardsticks over 4 passes of the P periods (the library
    call, where there is one: one pass), each call on another period's
    inputs."""
    err = float((kernel_fn(0).float() - plain_fn(0).float()).abs().max())
    held, host = cs.event_ms(torch, lambda i: kernel_fn(i % P), 4 * P)
    lib = (lambda hold: cs.event_ms(torch, lambda i: library_fn(i % P), P, hold=hold)[0]
           if library_fn else None)
    return {"max_abs_err": err, "held_ms": held,
            "unheld_ms": cs.event_ms(torch, lambda i: kernel_fn(i % P), 4 * P, hold=False)[0],
            "profiler_ms": _profiled_ms(torch, lambda i: kernel_fn(i % P), 4 * P, kernel_name),
            "host_ms": host, "library_held_ms": lib(True), "library_unheld_ms": lib(False)}


def worker(tree: Path, prefixes: tuple[str, ...]) -> dict:
    """The rows for the checkout at ``tree`` whose names start with one of
    ``prefixes`` (every row when empty), in chip_smoke.py phase 3's order;
    the inputs of every row are drawn, timed or not, so that each row's are
    the same whatever is chosen."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as kernel
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is false")
    if Path(kernel.__file__).resolve().parents[3] != tree.resolve():
        raise RuntimeError(f"repro_torch came from {kernel.__file__}, not from {tree}")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rows = {}
    want = lambda row: not prefixes or row.startswith(prefixes)   # noqa: E731
    P, B, KV, G, hd, ps, num_pages, NB = 28, 8, 8, 2, 128, 16, 128, 1025
    for name in ("bfloat16", "float32"):
        q, k, v, pt, vl = cs._paged_inputs(torch, gen, getattr(torch, name), P, B, KV, G,
                                           hd, ps, num_pages, NB, max_len=2048)
        if want(f"paged {name}"):
            rows[f"paged {name}"] = _row(
                torch, cs, P, "paged_decode_kernel",
                lambda i: kernel.paged_decode_attention(q[i], k[i], v[i], pt, vl),
                lambda i: ref.paged_decode_attention_ref(q[i], k[i], v[i], pt, vl),
                lambda i: cs._library_call(torch, q[i], k[i], v[i], pt, vl))
        del q, k, v
        torch.cuda.empty_cache()
    for label, B, C in (("dense", 8, 2048), ("ring", 4, 8192)):
        for name in ("bfloat16", "float32"):
            vl = (torch.full((B,), C, dtype=torch.int32, device="cuda") if C == 8192 else
                  torch.randint(1, C + 1, (B,), generator=gen, device="cuda",
                                dtype=torch.int32))
            q, k, v = cs._dense_inputs(torch, gen, getattr(torch, name), P, B, C, KV, G, hd)
            if want(f"{label} {name}"):
                rows[f"{label} {name}"] = _row(
                    torch, cs, P, "dense_decode_kernel",
                    lambda i: kernel.decode_attention(q[i], k[i], v[i], vl),
                    lambda i: ref.decode_attention_ref(q[i], k[i], v[i], vl),
                    lambda i: cs._dense_library_call(torch, q[i], k[i], v[i], vl))
            del q, k, v
            torch.cuda.empty_cache()
    from repro_torch.kernels import mamba_scan as scan
    for label, B, S, name in cs.SCAN_SHAPES[:2]:
        args = cs._scan_inputs(torch, gen, B, S, name)     # one input: 5 calls a pass
        if want(f"scan {name}"):
            rows[f"scan {name}"] = _row(
                torch, cs, 5, "mamba_scan_kernel", lambda i: scan.mamba_scan(*args)[0],
                lambda i: ref.mamba_scan_ref(*args)[0], None)
        del args
        torch.cuda.empty_cache()
    bwd_gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 7)   # _scan_bwd_rows'
    di, N = 8192, 16
    for label, B, S, name in cs.SCAN_SHAPES[:2]:
        args = cs._scan_inputs(torch, bwd_gen, B, S, name)
        g_y = torch.randn((B, S, di), generator=bwd_gen, device="cuda")
        g_h = torch.randn((B, di, N), generator=bwd_gen, device="cuda")
        if want(f"scan_bwd {name}"):
            rows[f"scan_bwd {name}"] = _bwd_row(torch, cs, args, g_y, g_h)
        del args, g_y, g_h
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=PATH",
                    help="a checkout to time (repeat for each)")
    ap.add_argument("--order", help="comma-separated names, the order of the runs "
                    "(default: each tree once, as given)")
    ap.add_argument("--rows", default="", help="comma-separated prefixes of the rows to time "
                    "(default: every row)")
    ap.add_argument("--out", type=Path, help="also write the JSON object here")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    prefixes = tuple(p for p in args.rows.split(",") if p)
    if args.worker:
        print(json.dumps(worker(args.worker, prefixes)), flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    if not trees:
        ap.error("give at least one --tree NAME=PATH")
    order = args.order.split(",") if args.order else list(trees)
    runs = []
    for name in order:
        proc = subprocess.run([sys.executable, __file__, "--worker", str(Path(trees[name])),
                               "--rows", args.rows], capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stdout, proc.stderr, sep="\n", file=sys.stderr)
            print(f"decode_timers: the run of {name} failed", file=sys.stderr)
            return 1
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"tree": name, "rows": rows})
        print(f"run {len(runs)}: {name} ({trees[name]})")
        print(f"  {'row':18s} " + " ".join(f"{f:>17s}" for f in (*FIELDS, "max_abs_err")))
        for row, r in rows.items():
            print(f"  {row:18s} " + " ".join(f"{r[f]:17.6f}" if r[f] is not None
                                               else f"{'none':>17s}" for f in FIELDS)
                  + f" {r['max_abs_err']:17.3e}", flush=True)
            if "split" in r:
                print("  " + " " * 19 + ", ".join(f"{k} {v:.6f}" for k, v in r["split"].items()),
                      flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    result = {"device": smi.splitlines()[0], "runs": runs}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
