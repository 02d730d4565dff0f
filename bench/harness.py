"""One run of one cell: set-up, the measured window, and the run's record.

The window drives ``repro_torch.engine.runtime.RolloutRuntime.run()`` over a
``RolloutFleet`` of one ``RolloutWorker``, batch after batch, from the entry
of the first batch's ``run()`` until the first call into the worker that
returns after the window's seconds.  The harness's own spans wrap every call
into the worker and the backend's tool boundaries; they stamp each generated
token and rebuild each lane's fed stream for the output check.  In a traced
run each span ends with a device synchronise and the profiler covers the
window.
"""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bench import flops, traffic

DECODE_KERNEL = "paged_decode_kernel"
SCAN_KERNEL = "mamba_scan_kernel"


class WindowClosed(Exception):
    """Raised from a worker call that returns after the window's end."""


@dataclass
class Lane:
    """The harness's record of one trajectory."""

    traj_id: int
    request: traffic.Request
    ctx: list[int] = field(default_factory=list)       # the worker's context
    stream: list[int] = field(default_factory=list)    # token fed at each position
    served: list[tuple[int, int]] = field(default_factory=list)  # (position, token)
    last: float = 0.0                                   # stamp the next token counts from
    step_tokens: int = 0
    steps: list[int] = field(default_factory=list)     # tokens of each finished step
    admitted: bool = False
    slot: int = -1
    trajectory: object = None


@dataclass
class Run:
    """What a run measured; the metric readers read only this."""

    cfg: dict
    trace: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    generated: int = 0
    tpot: list[tuple[float, int]] = field(default_factory=list)   # (s a token, tokens)
    spans: list[tuple[str, float, float]] = field(default_factory=list)
    stats: dict = field(default_factory=dict)          # worker counters over the window
    model_flops: float = 0.0
    decode_bytes: list[tuple[int, float]] = field(default_factory=list)  # (launches, bytes)
    scan_tokens: list[int] = field(default_factory=list)    # S of a whole-prompt admission
    n_scan_layers: int = 0
    device: dict = field(default_factory=dict)         # the trace's reduction
    lanes: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    error: str = ""
    batches: int = 0


class _Env:
    """The tool environment of a batch: each plan's outcome and the
    generator's tool-output ids; the terminal step calls no tool."""

    def __init__(self, lanes: dict[int, Lane]):
        self.lanes = lanes

    def step_outcome(self, traj, step, gen_tokens, context):
        from repro_torch.engine.runtime import ToolResult
        req = self.lanes[traj.traj_id].request
        plan = req.plan
        last = step + 1 >= len(plan.gen)
        out = [] if last else list(req.tool_ids[step])
        return ToolResult(float(plan.tool_latency[step]), bool(plan.tool_failed[step]), out,
                          terminal=last)


def _trajectories(reqs: list[traffic.Request], base: int):
    from repro_torch.core.trajectory import Trajectory
    from repro_torch.engine.workload import TrajectoryPlan
    out = []
    for r in reqs:
        t = Trajectory(prompt_id=r.group, sample_id=r.sample, prompt_tokens=len(r.prompt),
                       traj_id=base + r.index, context_tokens=len(r.prompt))
        p = r.plan
        t.payload = TrajectoryPlan(list(p.gen), list(p.tool_latency), list(p.tool_failed),
                                   list(p.tool_out))
        t.true_total_tokens = sum(p.gen)
        t.true_num_steps = len(p.gen)
        out.append(t)
    return out


def _history(mix: dict):
    """Finished trajectories of the mix's history, for the predictor."""
    from repro_torch.core.trajectory import StepRecord, Trajectory
    out = []
    for i, (prompt, plan) in enumerate(traffic.history(mix)):
        t = Trajectory(prompt_id=i // mix["group_size"], sample_id=i % mix["group_size"],
                       prompt_tokens=prompt, traj_id=-1 - i, context_tokens=prompt)
        for s in range(len(plan.gen)):
            t.record_step(StepRecord(s, plan.gen[s], plan.tool_latency[s],
                                     tool_failed=plan.tool_failed[s],
                                     tool_output_tokens=plan.tool_out[s]))
            t.record_tool_output(plan.tool_out[s])
        t.true_total_tokens = sum(plan.gen)
        t.true_num_steps = len(plan.gen)
        t.finished = True
        out.append(t)
    return out


class Harness:
    """Builds the system for one cell and drives its window."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, traced: bool,
                 num_blocks: int):
        from repro_torch.core.controller import HeddleConfig, HeddleController
        from repro_torch.core.placement import InterferenceModel
        from repro_torch.core.predictor import ProgressivePredictor
        from repro_torch.core.resource_manager import WorkerLatencyModel
        from repro_torch.engine.fleet import FleetSpec, RolloutFleet
        from repro_torch.engine.sampler import SamplerConfig
        from repro_torch.models.config import ModelConfig

        from bench import weights

        self.marks = [("start", time.perf_counter())]   # set-up phases, for the log
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.traced = traced
        self.model = ModelConfig(**dict(cfg, block_pattern=tuple(cfg["block_pattern"])))
        self.params = weights.make(self.model, cfg, seed, self.device)
        self._sync()
        self.marks.append(("weights", time.perf_counter()))
        rt = mix["runtime"]
        self.batch_size = mix["n_prompts"] * mix["group_size"]
        samp = mix["sampler"]
        self.temperature = samp["temperature"]
        if samp["top_p"] != 1.0 or self.temperature <= 0:
            raise ValueError("the output check reads sampled tokens at top_p 1 and a "
                             "positive temperature only")
        self.fleet = RolloutFleet(
            self.model, self.params, FleetSpec((1,)), capacity=mix["capacity"],
            max_slots=self.batch_size,
            sampler=SamplerConfig(samp["temperature"], samp["top_p"]),
            seed=seed, device=self.device, paged=True, page_size=16,
            chunk_size=rt["chunk_size"], num_blocks=num_blocks)
        self.worker = self.fleet.workers[0]
        self._sync()
        self.marks.append(("fleet and pool", time.perf_counter()))
        predictor = ProgressivePredictor().fit_trajectories(_history(mix))
        self.controller = HeddleController(
            predictor, InterferenceModel.analytic(0.02), WorkerLatencyModel(t1=0.02),
            gpu_budget=1,
            config=HeddleConfig(scheduler=rt["scheduler"], adaptive_resources=False,
                                migration=False, migration_load_gap=1,
                                migration_cooldown_steps=1, rank_hysteresis=0.2),
            max_workers=1)
        self.marks.append(("predictor", time.perf_counter()))
        self.lanes: dict[int, Lane] = {}
        self.run_rec = Run(cfg, traced)
        self.deadline = math.inf
        self.t_end = 0.0
        self._wrap_worker()

    # ------------------------------------------------------------ set-up
    def warm(self) -> None:
        """The cell's own shapes, once: an admission (one chunk, or one
        whole-prompt forward where the worker admits so) and one decode step
        of the whole pool; then an empty worker."""
        reqs = traffic.make_batch(self.mix, self.seed, 0, self.cfg["vocab"])
        n = (self.mix["runtime"]["chunk_size"] if self.worker._chunked
             else len(reqs[0].prompt))
        toks = reqs[0].prompt[:n]
        w, cls = self.worker, type(self.worker)        # the methods, not the spans
        cls.prefill(w, -1, toks)
        cls.decode(w, [-1], 1)
        w.reset_cache()
        self._sync()
        self._snapshot = dict(w.dispatch_stats())
        gc.collect()
        gc.freeze()            # set-up's objects leave the collector's scans in the window
        self.marks.append(("warm-up", time.perf_counter()))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ spans
    def _span(self, kind: str, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if self.traced:
            self._sync()
        t1 = time.perf_counter()
        self.run_rec.spans.append((kind, t0, t1))
        self.t_end = t1
        return out, t1

    def _check_deadline(self, t1: float) -> None:
        if t1 >= self.deadline:
            raise WindowClosed

    def _wrap_worker(self) -> None:
        w = self.worker
        prefill, extend, decode = w.prefill, w.extend, w.decode
        preempt, release = w.preempt, w.release
        rec = self.run_rec

        def do_prefill(seq_id, tokens):
            before = w.reused_tokens
            _, t1 = self._span("admission", prefill, seq_id, tokens)
            lane = self.lanes[seq_id]
            lane.admitted = True
            lane.ctx = list(tokens)
            lane.stream = list(tokens)
            lane.slot = w.store[seq_id].slot
            if self.traced:
                reused = w.reused_tokens - before
                rec.model_flops += flops.span_flops(self.cfg, reused, len(tokens))
                if not w._chunked:
                    rec.scan_tokens.append(len(tokens))
            self._check_deadline(t1)

        def do_extend(seq_id, tool_tokens):
            lane = self.lanes[seq_id]
            pos = len(lane.ctx)
            _, t1 = self._span("absorption", extend, seq_id, tool_tokens)
            lane.ctx.extend(int(t) for t in tool_tokens)
            lane.stream.extend(int(t) for t in tool_tokens)
            if self.traced:
                rec.model_flops += flops.span_flops(self.cfg, pos, pos + len(tool_tokens))
            self._check_deadline(t1)

        def do_decode(seq_ids, n_tokens, stop_token=None):
            pos0 = {sid: len(self.lanes[sid].ctx) for sid in seq_ids}
            out, t1 = self._span("decode", decode, seq_ids, n_tokens, stop_token)
            live = []
            for sid, toks in out.items():
                if not toks:
                    continue
                lane = self.lanes[sid]
                p = pos0[sid]
                k = len(toks)
                # a call feeds the lane's last context token at the lane's
                # position, then each token it draws but the last
                lane.stream.append(lane.ctx[-1])
                lane.stream.extend(toks[:-1])
                lane.served.extend((p + i, t) for i, t in enumerate(toks))
                lane.ctx.extend(toks)
                rec.tpot.append(((t1 - lane.last) / k, k))
                lane.last = t1
                lane.step_tokens += k
                rec.generated += k
                live.append((sid, p, k))
            if self.traced and live:
                self._decode_counts(live)
            self._check_deadline(t1)
            return out

        def do_preempt(seq_id):
            _, t1 = self._span("bookkeeping", preempt, seq_id)
            self._check_deadline(t1)

        def do_release(seq_id):
            _, t1 = self._span("bookkeeping", release, seq_id)
            self._check_deadline(t1)

        w.prefill, w.extend, w.decode = do_prefill, do_extend, do_decode
        w.preempt, w.release = do_preempt, do_release

    def _decode_counts(self, live: list[tuple[int, int, int]]) -> None:
        """A traced decode call's model FLOPs and, per step, the bytes each of
        its paged-kernel launches needs: the distinct pages the live lanes'
        valid tokens reference (a lane's new pages are its own; a shared
        prefix page counts once) and the live lanes' q and output."""
        w, rec, cfg = self.worker, self.run_rec, self.cfg
        ps = w.page_size
        n_attn = cfg["n_periods"] * sum(k.startswith("attn") for k in cfg["block_pattern"])
        steps = max(k for _, _, k in live)
        alive, first = None, 0
        for i in range(steps):
            lanes_i = [(sid, p) for sid, p, k in live if k > i]
            if alive != len(lanes_i):          # pages its lanes held at the call's start
                alive = len(lanes_i)
                first = len(set().union(*(w.lane_pages[self.lanes[sid].slot][
                    :flops.pages(p + 1, ps)] for sid, p in lanes_i)))
            grown = sum(flops.pages(p + i + 1, ps) - flops.pages(p + 1, ps)
                        for _, p in lanes_i)
            nbytes = flops.paged_decode_bytes(cfg, first + grown, len(lanes_i), ps)
            rec.decode_bytes.append((n_attn, nbytes))
            rec.model_flops += sum(flops.token_flops(cfg, p + i + 1, head=True)
                                   for _, p in lanes_i)

    def _wrap_backend(self, backend) -> None:
        submit, absorb = backend.tool_submit, backend.tool_absorb

        def do_submit(traj):
            out = submit(traj)
            lane = self.lanes[traj.traj_id]
            lane.steps.append(lane.step_tokens)
            lane.step_tokens = 0
            return out

        def do_absorb(traj):
            absorb(traj)
            self.lanes[traj.traj_id].last = time.perf_counter()

        backend.tool_submit, backend.tool_absorb = do_submit, do_absorb

    # ------------------------------------------------------------ the window
    def _runtime(self, k: int):
        from repro_torch.engine.runtime import RolloutRuntime, RuntimeConfig
        reqs = traffic.make_batch(self.mix, self.seed, k, self.cfg["vocab"])
        trajs = _trajectories(reqs, k * self.batch_size)
        lanes = {}
        for r, t in zip(reqs, trajs):
            lanes[t.traj_id] = Lane(t.traj_id, r, trajectory=t)
        self.lanes.update(lanes)
        rt = self.mix["runtime"]
        config = RuntimeConfig(scheduler=rt["scheduler"], migration=False,
                               max_active=rt["max_active"], quantum=rt["quantum"],
                               paged=True, page_size=16)
        runtime = RolloutRuntime(self.fleet, self.controller, trajs, _Env(lanes), config,
                                 prompts={t.traj_id: r.prompt for r, t in zip(reqs, trajs)})
        self._wrap_backend(runtime.backend)
        return runtime, lanes

    def window(self, seconds: float, t_process: float) -> Run:
        """Run batches back to back for ``seconds``; the record of the run."""
        rec = self.run_rec
        runtime, lanes = self._runtime(0)
        self._sync()
        t0 = time.perf_counter()
        rec.setup_s = time.time() - t_process
        self.deadline = t0 + seconds
        k = 0
        while True:
            for lane in lanes.values():
                lane.last = time.perf_counter() if k else t0
            rec.batches = k + 1
            try:
                runtime.run()
            except WindowClosed:
                break
            except Exception as exc:           # the program raised: its lanes failed
                rec.error = f"{type(exc).__name__}: {exc}"
                for lane in lanes.values():
                    if not lane.trajectory.finished:
                        lane.steps.append(-1)
                break
            k += 1
            self.worker.reset_cache()
            runtime, lanes = self._runtime(k)
        rec.window_s = self.t_end - t0
        rec.spans = [(kind, a - t0, b - t0) for kind, a, b in rec.spans if a >= t0]
        after = self.worker.dispatch_stats()
        rec.stats = {k: after[k] - self._snapshot.get(k, 0) for k in after
                     if isinstance(after[k], (int, float))}
        rec.n_scan_layers = sum(1 for k in self.cfg["block_pattern"]
                                if k.startswith("mamba")) * self.cfg["n_periods"]
        self.t0 = t0
        self._judge_counts()
        return rec

    def _judge_counts(self) -> None:
        """Attempted: admitted in the window.  Failed: a lane whose steps
        decoded another count than its plan, or that the program lost."""
        rec = self.run_rec
        for lane in self.lanes.values():
            if not lane.admitted:
                continue
            rec.attempted += 1
            plan = lane.request.plan.gen
            done = lane.steps
            wrong = (done != plan[:len(done)] or lane.step_tokens > (
                plan[len(done)] if len(done) < len(plan) else 0)
                or (lane.trajectory.finished and len(done) != len(plan)))
            rec.failed += bool(wrong)
        rec.lanes = self.lanes

    def release_program(self) -> None:
        """Drop the program's state (pool, fleet, runtime); the weights stay
        for the reference.  The wrapped worker holds itself through its
        wrappers, a cycle that set-up's ``gc.freeze`` keeps from the
        collector: unfreeze and collect, or the pool outlives the window."""
        self.fleet = self.worker = self.controller = None
        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def weighted_quantile(samples: list[tuple[float, int]], q: float) -> float:
    """The q-quantile of values repeated by their counts (the lower value at
    a tie)."""
    if not samples:
        return math.nan
    vals = np.array([v for v, _ in samples])
    counts = np.array([c for _, c in samples])
    order = np.argsort(vals, kind="stable")
    cum = np.cumsum(counts[order])
    i = int(np.searchsorted(cum, q * cum[-1], side="left"))
    return float(vals[order][min(i, len(vals) - 1)])
