"""Run one cell of the benchmark once and print its result line.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix
and its metrics are found by name: ``BENCHMARK.json``'s ``workloads`` entry,
``bench/configs/<config>.json``, ``bench/traffic/<traffic>.json``,
``bench/limits/<cell>.json`` (the output check's limits and sample) and one
``bench/metrics/<metric>.py`` a metric.  With ``--trace 0`` the result holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics and
the device's busy and window seconds from the trace.  The last line of
standard output is the result, one JSON object; the numbers the output check
compared, each beside its limit, end standard error and the result.
``--control 1`` (not a benchmark run) puts the fp8 control in the program's
place: ``correct`` and ``checks`` are the control's, at the same positions
and under the same limits, and ``program`` holds the program's own.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

from bench import traffic

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The process's start on the wall clock (``/proc``; this module's import
    where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROCESS = process_start()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cell_spec(spec: dict, name: str) -> dict:
    """The cell's files and metrics, resolved by name from ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg_file = json.loads((ROOT / conf["file"]).read_text())
    mix = traffic.load_mix(cell["traffic"])
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return {"cell": cell, "cfg_file": cfg_file, "mix": mix, "limits": limits,
            "end_to_end": e2e, "per_layer": layer}


def judged(verdict: dict, limits: dict, failed: int, error) -> tuple[dict, bool]:
    """The numbers compared, each beside its limit, and whether all keep to
    them.  Every number the cell's limits file gives a limit is compared;
    with no token judged there is no reading (null), which fails."""
    checks = {k: {"value": verdict[k] if math.isfinite(verdict[k]) else None,
                  "limit": limits[k]}
              for k in ("served_gap", "mean_gap") if limits.get(k) is not None}
    checks["tokens_judged_at_least"] = {"value": verdict["tokens"],
                                        "limit": limits["min_tokens"]}
    checks["failed"] = {"value": failed, "limit": 0}
    correct = bool(all(c["value"] is not None and c["value"] <= c["limit"]
                       for k, c in checks.items() if k != "tokens_judged_at_least")
                   and verdict["tokens"] >= limits["min_tokens"] and not error)
    return checks, correct


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False) -> tuple[dict, list[str]]:
    """One run of a resolved cell (``cell_spec``): the result object and the
    check lines for standard error."""
    import torch

    from bench import check, harness, trace as tracing
    from bench.metrics import reader

    cfg_file, mix, limits = spec["cfg_file"], spec["mix"], spec["limits"]
    cfg = cfg_file["model"]
    name = spec["cell"]["name"]
    with torch.no_grad():
        h = harness.Harness(cfg, mix, seed, device, trace, cfg_file["serve"]["num_blocks"])
        h.warm()
        if trace:
            with tracing.Trace() as tr:
                rec = h.window(seconds, T_PROCESS)
            rec.device = tr.read(h.t0, h.t0 + rec.window_s,
                                 [(k, a + h.t0, b + h.t0) for k, a, b in rec.spans],
                                 (harness.DECODE_KERNEL, harness.SCAN_KERNEL))
        else:
            rec = h.window(seconds, T_PROCESS)
        found = forbidden_modules()
        if found:
            raise SystemExit(f"modules of JAX or of the JAX package are loaded: {found}")
        dev = torch.device(device)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        mem = torch.cuda.memory_stats(dev) if dev.type == "cuda" else {}
        max_slots = h.worker.max_slots
        h.release_program()
        picked = check.sample(check.checkable(rec, cfg, max_slots), seed,
                              limits["max_lanes"])
        verdict = check.judge(h.params, cfg, cfg_file["reference"], picked, seed,
                              h.temperature, control=control)
    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        try:
            value = reader(m["name"])(rec)
        except (RuntimeError, KeyError, ZeroDivisionError) as exc:
            log(f"[bench] {m['name']} not read: {exc}")
            value = None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks, correct = judged(verdict, limits, rec.failed, rec.error)
    if control:
        # the fp8 reference in the program's place, held to the same limits
        program = {"correct": correct, "checks": checks}
        checks, correct = judged({k: verdict["control_" + k.replace("served_", "")]
                                  for k in ("served_gap", "mean_gap")}
                                 | {"tokens": verdict["tokens"]}, limits, 0, None)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    if trace:
        device_info.update(busy_s=rec.device["busy_s"], window_s=rec.device["window_s"])
    result = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed,
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": rec.device["device_ops"],
                               "idle_gaps": rec.device["idle_gaps"]}
    marks = h.marks
    phases = ", ".join(f"{n} {b - a:.2f} s" for (_, a), (n, b) in zip(marks, marks[1:]))
    lines = [f"[bench] set-up {rec.setup_s:.2f} s: imports and the device "
             f"{rec.setup_s - (marks[-1][1] - marks[0][1]):.2f} s, {phases}"]
    lines += [f"[bench] {name} seed {seed}: window {rec.window_s:.3f} s, {rec.batches} "
             f"batch(es), {rec.generated} tokens generated, {len(rec.tpot)} per-token "
             f"samples over {sum(c for _, c in rec.tpot)} tokens, reference "
             f"{verdict['seconds']:.1f} s over {verdict['lanes']} lanes"]
    st = rec.stats
    steps = st.get("decode_timed_steps", 0)
    step_ms = 1e3 * st.get("decode_wall_s", 0.0) / max(steps, 1)
    lines.append(f"[bench] worker: {st.get('decode_calls', 0)} decode calls, {steps} "
                 f"steps, "
                 f"{step_ms:.2f} ms a step (its own clock), "
                 f"{st.get('prefill_dispatches', 0)} chunks, "
                 f"{st.get('absorbed_tokens', 0)} tokens absorbed; allocator: "
                 f"{mem.get('num_alloc_retries', 0)} retries, reserved peak "
                 f"{mem.get('reserved_bytes.all.peak', 0) / 2**30:.2f} GiB")
    kinds = sorted({k for k, _, _ in rec.spans})
    spans = {k: sorted(b - a for kk, a, b in rec.spans if kk == k) for k in kinds}
    lines.append("[bench] spans: " + "; ".join(
        f"{k} {len(v)} calls, {sum(v):.2f} s, median {1e3 * v[len(v) // 2]:.1f} ms, "
        f"max {1e3 * v[-1]:.1f} ms" for k, v in spans.items()))
    lines.append("[bench] per-token ms: " + ", ".join(
        f"p{q} {1e3 * harness.weighted_quantile(rec.tpot, q / 100):.1f}"
        for q in (5, 50, 90, 95, 99)))
    if rec.error:
        lines.append(f"[bench] the program raised: {rec.error}")
    lines.append(f"[bench] served: widest gap {verdict['served_gap']!r}, flip share "
                 f"{verdict['flip_share']!r} %, mean gap {verdict['mean_gap']!r} over "
                 f"{verdict['tokens']} tokens")
    if control:
        result["program"] = program
        result["control"] = {k: verdict[k] for k in (
            "served_gap", "flip_share", "mean_gap", "control_gap", "control_flip_share",
            "control_mean_gap")}
        lines.append(f"[bench] control (fp8): widest gap {verdict['control_gap']!r}, flip "
                     f"share {verdict['control_flip_share']!r} %, mean gap "
                     f"{verdict['control_mean_gap']!r}")
    if control:
        lines += [f"[bench] program: {k} {v['value']!r} limit {v['limit']!r}"
                  for k, v in program["checks"].items()]
    lines += [f"[check] {'control: ' if control else ''}{k} {v['value']!r} limit "
              f"{v['limit']!r}" for k, v in checks.items()]
    result["checks"] = checks
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        log(f"[bench] the program is missing: no {src / 'repro_torch'}")
        return 2
    sys.path.insert(0, str(src))
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    spec = cell_spec(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload)
    import torch
    torch.set_num_threads(1)           # one process, few threads: the host path is serial
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[bench] {args.workload} needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2
    result, lines = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                             control=bool(args.control))
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
