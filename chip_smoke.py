#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it
(phase 17 on every visible card, where there are two or more).

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero with no result line):

1. device  -- the card's name and power limit (nvidia-smi), torch's device name
              and count; no CUDA device is a failure.
2. build   -- nvcc builds every kernel of the path from the sources in this
              checkout (src/repro_torch/kernels/csrc/) into one library, one
              nvcc per source, all started together, then a link; the scan
              kernels' registers, and the scan backward's two passes' dynamic
              shared memory a block and blocks an SM, for each dtype and N.
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
              the copy widths its wrapper chose; its backward kernel at the
              same four shapes (gradients of y and of the last state drawn),
              each of the five gradients held to the plain backward, two
              runs bit-equal, timed at the main shape and all-f32 beside the
              plain backward and split into its three launches
              (torch.profiler), its scratch bytes logged.  Each
              decode row also logs the split the wrapper chose (n_split, L,
              blocks), the achieved GB/s, the share of the bound and the
              host's time to enqueue one call.  The paged kernel is also
              timed at qwen2-moe's runtime decode shape (B 24, KV 16, G 1,
              lanes of 512), and both decode kernels are held at phase 10's
              other paged paths' own shapes, so at the splits they get
              (arctic KV 8 G 7, B 4, lanes of 2,048; nemotron KV 8 G 6 and
              phi3 KV 10 G 4, B 8, lanes of 1,024), lengths filling every
              piece.  Last, the dense kernel at phase 11's cross-attention
              decode shapes, timed as the other dense rows (SDPA with no
              mask): whisper's B 8, C 1,500, KV 16, G 1, hd 64 (the split's
              last piece and last tile ragged) over its 24 layers' caches,
              and the VLM's B 8, C 1,600, KV 8, G 4, hd 128 over 8; every
              slot valid, each cache the first B lanes of a buffer whose
              extra lane is NaN; then the same at phase 15's shard shapes
              (whisper KV 8 and 4, the VLM KV 4 and 2).
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
              once).  Then the paper's F(batch) on the card
              (engine/profiler.py: profile_decode, then
              interference_from_profile, the two halves of
              measured_interference; dense decode_step, capacity 2,048,
              context 1,024, batch 1-24, 8 steps after 2): each batch's raw
              per-step time, every one finite and > 0, and F.
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
              admission, its Mamba state card vs CPU; the reduced xLSTM
              period after a chunked recurrent admission, its state card vs
              CPU; engine.sampler.sample at qwen3's vocabulary (151,936), B
              8, seeds 0-3, greedy and at temperature 1.0, top-p 0.9, its
              tokens card == CPU.
9. runtime -- the control plane over the port's workers: qwen3-1.7b at full
              width cut to 7 of its 28 layers (RUNTIME_LAYERS, for the
              script's time: the three runs are host-bound, a step's wall
              about proportional to the layers), two RolloutWorkers on the
              card driven by the orchestrator through EngineBackend on the
              reference trace harness's workload (24 trajectories, 448
              planned tokens; pps, migration, 2 active lanes a worker,
              quantum 8, an infinite link, the sanitizer on),
              each run's decision trace and makespan held to the sim's: the
              paged plane (preemptions and migrations must occur), the dense
              plane (paged=False, migration off, under torch.profiler), and
              the paged plane under a chaos plan (a worker death and revival,
              injected tool faults, checkpoints persisted to a temporary
              directory and loaded back).  The decode kernels' counts are
              zeroed before each run and read after it.  The inputs of every
              500th decode-kernel call of each run are kept, and after the
              run the kernel is held to its plain version on them (the cache
              also poisoned wherever no lane reads), and on drawn inputs at
              the runtime's shapes whose lengths fill every piece of the
              split, the ragged last one too.  Then the serve CLI
              (python -m repro_torch.launch.serve) runs as a process of its
              own, with no --device flag: on the card.
10. families -- the other language-model families, weights from the seed,
              each model freed before the next, peak memory logged:
              (a) qwen2-moe-a2.7b at full width cut to 4 of its 24 layers
              (60 experts top-4 and the gated shared experts, MHA) under the
              runtime on phase 9's workload and settings, the paged and the
              dense plane (migration off), each trace held to the sim's, the
              decode kernel's launches equal to 4 x the decode steps (per-token
              tool absorptions included), kept live calls held to the plain
              version; (b) xlstm-350m at its published widths, cut to 1
              of its 4 periods (5 mLSTM, 1 sLSTM) for the script's time
              (phase 15 runs all 24 layers): two paged workers (pure-state
              pools) and a dense one, two GRPO groups of 4 (prompts of 512
              and 300 tokens) by chunked recurrent prefill, decode, a
              chunked extend, preempt and resume, migration paged -> dense
              -> paged, a checkpoint, each lane's state held exactly, and a
              released lane readmitted equal to a fresh one; (c)
              arctic-480b at its published widths cut to 1 of 35 layers (128 experts top-2 and the dense
              residual): 4 whole-prompt admissions of 1,024 tokens, 32
              decode steps (the paged kernel at G 7); (d) nemotron-4-15b
              (relu2, G 6) and phi3-medium-14b (KV 10) at full width: 8
              requests in 2 groups (prompts of 300 and 257 tokens, radix
              sharing), 32 decode steps.  Counts zeroed before each path and
              read after it; 4 live paged-kernel calls of each of (c) and (d),
              the last among them, kept and held to the plain version.
11. encoders -- the audio encoder-decoder and the VLM's gated cross-attention
              through the model API (forward_full, then decode_step on its
              dense cache, sampled at temperature 1.0 / top-p 0.9), weights
              from the seed, each model freed before the next, peak memory
              logged: (a) whisper-medium at full width (24 encoder and 24
              decoder layers, d 1,024, MHA hd 64, layernorm, GELU, sinusoidal
              positions): 8 requests of frame embeddings (8, 1,500, 1,024)
              bf16 and 64-token prompts admitted at capacity 448, 64 decode
              steps; (b) llama-3.2-vision-11b at full width (32 self- and 8
              gated cross-attention layers, G 4, gates set to 0.7): patch
              embeddings (8, 1,600, 4,096) bf16, 512-token prompts, capacity
              1,024, 64 decode steps.  The dense kernel's count is zeroed
              before each and must equal steps x 48 (whisper: 24 self + 24
              cross) and steps x 40 (the VLM) after; 4 live cross- and 4
              self-attention calls of each are kept and held to the plain
              version.  Then both reduced (f32, gates open): admission and 8
              teacher-forced decode steps, logits card vs CPU.
12. train  -- the training plane: (a) flash attention forward and backward
              (the port's autograd Function) at qwen3-1.7b's layer shape (B 1,
              KV 8, G 2, S 4,096, hd 128), causal and with a 1,024-token
              window, f32 and bf16, against plain attention under autograd in
              f32 on the same inputs; fwd+bwd timed beside SDPA's; (b) one
              GRPO step at qwen3-1.7b full width (B 2, S 4,096, remat on,
              advantages +-1): the loss and every gradient finite, every leaf
              with a gradient moved, AdamW moments f32, the step's wall and
              peak memory; (c) HeddleTrainer at full width, cut to 7 of its
              28 layers (TRAINER_LAYERS), on two paged workers: train(2),
              an update on records with a reward spread (the workers'
              tensors unchanged until the next sync), then
              train_async(3 updates, staleness <= 2, epochs [1, 2]); the
              paged kernel's count zeroed before and read after, every
              100th live call kept and held to the plain version; (d) the
              train CLI as a process of its own with no --device: on the
              card (it and (f)(iii) run beside (e) and (f)(i), which time
              nothing, and end before (f)(ii)); (e) the legacy per-sequence worker against the dense
              worker (qwen3 reduced, 2 layers, f32): equal tokens, the dense
              kernel's launches counted, every 8th live call kept and held
              to the plain version; (f) training through the Mamba mixer:
              (i) jamba reduced (1 period, f32), the GRPO loss and every
              gradient on the card (the scan's forward and backward kernels)
              against the CPU (plain versions); (ii) one jamba period at its
              published widths (phase 7's config and seed, built anew after
              the others are freed): the GRPO loss and gradients at B 1, S
              2,048, remat on (no AdamW: its f32 moments alone are 106 GB),
              every gradient finite and every leaf reached, wall and peak
              memory, the scan kernels' launches counted (backward 7, one a
              Mamba layer; forward 7 x the forwards the step runs); (iii)
              the train CLI on jamba reduced as a process of its own with no
              --device (one iteration, one group of 2): on the card.
13. tp     -- tensor-parallel rollout workers, every shard on this one card
              (a worker of MP degree d on the mesh [cuda:0] * d): qwen3-1.7b
              at full width (28 layers, 16/8 heads, hd 128, vocab 151,936,
              weights from the seed), paged workers at degree 1, 2 and 4 and
              dense ones at 1 and 2, each admitting 8 requests in 2 groups
              (prompts of 300 and 257 tokens, radix reuse), one
              teacher-forced step on the admitted contexts, then 32 greedy
              decode steps.  In f32: each sharded worker's tokens equal to
              its plane's degree-1 worker's and its logits within TP_TOL;
              in bf16 (the f32 weights rounded): the largest logit
              difference and the tokens equal before each lane's first
              difference, logged, beside the same of the bf16 paged d1
              worker against the f32 one (bf16's own error) and of each
              dense d1 worker against its paged d1.  The decode
              kernel's count is zeroed before each decode and must equal
              degree x 28 x 32 after it.  Each worker's bytes a shard and its
              step wall are logged.  A lane then moves d2 -> d1 -> d4 -> d2
              (bf16), each package bit-equal to the first.  Last, the paged
              kernel at the shards' shapes (KV 4 and 2, G 2) and the dense
              one at KV 4, held and timed as in phase 3.
14. tp-mixers -- tensor-parallel workers of the configs that admit by one
              whole-prompt forward on the mesh, every shard on this one card:
              (a) jamba-v0.1-52b at its published widths (d 4,096, 32/8
              heads, di 8,192, 16 experts top-2), weights from the seed,
              paged workers, 8 requests in 2 groups (prompts of 1,024 and
              700), one teacher-forced step on the admitted contexts, 32
              greedy decode steps: in f32 the period's first four layers
              (mamba+mlp, mamba+moe, mamba+mlp, attn+moe) at degree 1, 2
              and 4, each sharded worker's tokens equal to d1's and its
              logits within TP_TOL; the whole period in f32 at degree 1,
              then its weights rounded to bf16 at degree 1, 2 and 4, the
              logit differences logged beside the bf16 d1's from the f32
              d1, and each bf16 worker's top-2 expert choices recorded: the
              choices that differ between d1 and d2 are counted for the
              admissions, the teacher-forced step and the decode, and d2's
              two shards' choices against each other (both route over all
              16 experts); a lane moved d2 -> d1 -> d4 -> d2, each package (K/V
              pages, Mamba state, pos) bit-equal to the first; (b)
              qwen2-moe-a2.7b at full width cut to 4 of 24 layers, f32, at
              1, 2 and 4 (60 experts over 30 and 15 a shard, the shared
              experts' width cut); (c) qwen3-1.7b at full width with a
              2,048-token window (cut from 8,192), f32, one 2,500-token
              prompt (the ring wraps at admission) at 1 and 2.  The counts
              are zeroed before the admissions and before the decode: the
              scan's launches must equal d x (Mamba layers) x admissions
              and the decode kernel's d x (attention layers) x 32.  Last,
              the scan at the shards' channels (di 4,096 and 2,048; B 1,
              S 2,048, N 16; bf16 and f32) and the paged kernel at jamba's
              shard shapes (B 8, G 4, KV 4 and 2), held and timed as in
              phase 3.
15. tp-cross -- the xLSTM and cross-attention splits, every shard on this
              one card: (a) xlstm-350m at full width (20 mLSTM, 4 sLSTM; d
              1,024, 4 heads), paged pure-state workers at degree 1, 2 and 4,
              f32 then the same weights rounded to bf16: 8 requests in 2
              groups (prompts of 16 and 12 tokens, admitted one step a
              token; cut from 64 and 48 for the script's time), one
              teacher-forced step, 32 greedy steps; in f32 the
              sharded workers' tokens equal to d1's and their logits within
              TP_TOL, in bf16 no farther from the bf16 d1 than twice the
              bf16 d1 lies from the f32 d1; a lane's state and params a
              shard logged; a lane d2 -> d1 -> d4 -> d2 bit-equal; no kernel
              of the repo launches.  (b) whisper-medium at full width
              through the model API (``forward_full(mesh=)`` over 1,500
              frames, 8 requests of 64 tokens, capacity 448, then 32 greedy
              decode steps), f32 then bf16 at degree 1, 2 and 4; (c)
              llama-3.2-vision-11b at full width (gates 0.7, 1,600 patches,
              prompts of 512, capacity 1,024) in f32 at degree 1 alone (its
              f32 weights and their d2 shards do not fit together; its
              tokens and logits kept on the host), then the same weights
              rounded to bf16 in place at degree 1 and 2, and its first
              period (4 self-, 1 cross-attention layer) in f32 at 1, 2 and
              4.  For (b) and (c) the counts are zeroed before each
              admission and read after its decode: the dense kernel's must
              be d x 48 (whisper) or d x 40 (the VLM; d x 5 on the period) a
              step, nothing else launched (the VLM's f32 d1 adds 40 x 32);
              f32 sharded runs hold their tokens equal and logits within
              TP_TOL of d1's; every bf16 d2 and d4 (whisper, the VLM's d2)
              no farther from its bf16 d1 than twice the bf16 d1 lies from
              the f32 d1; a few live cross-attention calls of each run, at
              the shard's kv heads, held to the plain version.  The peak
              memory is logged.
16. examples -- the port's linter (repro_torch.analysis.lint) over
              src/repro_torch and examples/torch_*.py: 0 violations; then
              three of the four examples run in this process by calling
              their main() with no --device (the card): torch_quickstart
              (its control plane cut to 12 of 48 prompts for the script's
              time, then the reduced qwen3 engine step), torch_serve_rollout
              and torch_train_agentic_grpo --iters 2, at their default model
              sizes.  The counts are zeroed before each example and read
              after it: the paged kernel's must be the example's layers x
              its workers' decode steps (above 0), nothing else launched;
              about 4 live paged-kernel calls of each example (every 3rd,
              12th, 376th) are kept and held to the plain version.
17. cards  -- tensor-parallel workers with one shard a card, where two or
              more cards are visible (four for all of it); on one card it
              prints one line saying it was not run and claims nothing.
              Peer access is logged for each card pair.  First, each
              kernel's first launch on cuda:1 .. cuda:n-1 (the paged and
              dense kernels at qwen3's MP-2 shard, the scan and its
              backward at jamba's, bf16), through its wrapper with cuda:0
              current: ordered on that card's stream (held by a spin
              kernel, then given a new input the launch must read), its
              output there and bit-equal to cuda:0's launch on the same
              inputs, held to the plain version there.  (a) qwen3-1.7b at full
              width, paged, 4 of phase 13's 8 requests (2 of each group), a
              teacher-forced step and 8 greedy steps (phase 13: 32), at d 2
              and 4, f32 then bf16 (the f32 weights rounded): each degree
              with every shard on cuda:0, then one shard a card, the tokens and logits
              bit-equal; init_params(mesh=) over the cards bit-equal to the
              worker's cut of the whole tree (f32 d4); the paged kernel 28
              x 9 times on each card (8 steps and the teacher-forced one),
              2 live calls a card other than 0 held; the step wall at
              d 1, 2, 4 and each card's busy share over 8 steps under
              torch.profiler.  (d) a lane of the bf16 d2 worker on
              cuda:0-1 moved to a d2 worker on cuda:2-3 and back, 4 moves
              card to card, then 4 through the host (the package copied
              there first): every package leaf on its source's device 0,
              the package bit-equal at every move, each move timed; then
              one move each way under one TorchDispatchMode that counts
              the ATen ops copying a card's tensor or a count read off a
              card to the host (_host_copies): 0 card to card, at least
              one a package leaf through the host.  (b)
              jamba-v0.1-52b at its full depth (4 periods, 32 layers,
              nothing cut), initialised sharded
              (init_params(mesh=), each leaf drawn on cuda:0, cut, moved):
              f32 at d 4 on cuda:0-3 (the reference, 51.6 GB a card), the
              same weights rounded to bf16 in place at d 4, then the f32
              draws rounded leaf by leaf and cut at d 2 on cuda:0-1 (51.6
              GB a card); 4 of phase 14's requests (prompts of 1,024 and
              700), a teacher-forced step, 8 greedy steps; each card's peak
              memory; the scan 28 times an admission and the paged kernel
              4 x 9 times on each card, 2 live calls of each a card other
              than 0 held; the bf16 d2 logits no farther from the bf16
              d4's than TP_BF16_SPREAD x the bf16 d4's from the f32 d4's;
              the MoE top-2 flips between d4 and d2 counted.  (c) half of
              phase 9's workload (3 of its 6 prompts, 12 trajectories) on a
              {2, 1, 1} fleet over cuda:0-3, paged: the trace held to the
              sim's, as phase 9 holds its one-card runs (the run is not
              repeated on one card, for the script's time), the paged
              kernel launched on every card, the kept live calls (every
              1,000th, and 2 a card other than 0) held; then a {2, 1, 1}
              fleet reconfigured to {4} and back with 4 live lanes, on one
              card and on four, the
              lanes' tokens equal; then the serve CLI with --degrees 2,1,1
              over the visible cards as a process of its own.  The cuts
              (requests, steps, the runtime's prompts) fit the script's
              1,200 s on four cards, where phases 1-16 took 1,063 s.
18. dryrun -- the dry run (repro_torch.launch.dryrun: every step reckoned
              per card on meta tensors, nothing allocated) held against this
              card: (a) qwen3-1.7b's decode_32k at full width on a one-card
              layout (degree 1, 16 lanes of 32,768 slots: 60 GB of KV, 3.4
              GB of weights), reckoned by run_one, then the same step run on
              cuda:0: the argument bytes equal the real params' and cache's,
              the product FLOPs equal torch.utils.flop_counter's over the
              real step and the kernel's operations its formula, the
              predicted dense-kernel launches (28) the real ones, the
              reckoned temp within 1% + 64 MiB of the card's peak above the
              arguments; (b) the same at degree 2 on [cuda:0] * 2 (4 lanes):
              the reckoned all-reduces and all-gathers and their wire bytes
              equal to the real step's WorkerMesh calls, each shard's
              argument bytes, the FLOPs in all and the launches; (c) one
              2,048-token admission on phase 7's one-period jamba: the
              predicted scan launches (7) the real ones, the FLOPs and
              argument bytes held, the temp gap logged.

float32 matrix products run in full float32: TF32 is switched off for matmuls
and cuDNN.  The next-to-last line is one JSON object describing each kernel;
the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
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


def sync_all(torch):
    """Wait for every visible card: a worker's shards may lie on any of them."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def sync_ms(torch, fn):
    sync_all(torch)
    t0 = time.perf_counter()
    out = fn()
    sync_all(torch)
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
    # every card's context before torch.profiler first runs (phase 3): a later
    # profile saw no device events on a card whose context was made after the
    # process's first one (phase 17, on a four-card H100 host)
    sync_all(torch)
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
        bwd = re.search(r"(scan_bwd_(?:states|kernel))I(.*?)EEEv", entry)
        if "registers" in line and bwd:
            log(f"[build]   {bwd.group(1)}<{bwd.group(2)}>: {line.split(':', 1)[1].strip()}")
    _log_bwd_occupancy()


def _log_bwd_occupancy():
    """The scan backward's two passes for each dtype and built N: dynamic
    shared memory a block and the blocks an SM that it allows on this card."""
    import torch
    from repro_torch.kernels import mamba_scan as scan_kernel
    for dtype in (torch.bfloat16, torch.float32):
        for N in scan_kernel._STATE_DIMS:
            occ = scan_kernel.bwd_occupancy(dtype, N)
            log(f"[build]   mamba_scan_bwd {str(dtype)[6:]} N {N}: scan_bwd_states "
                f"{occ['states_smem']} B shared, {occ['states_blocks_per_sm']} blocks an SM; "
                f"scan_bwd_kernel {occ['kernel_smem']} B shared, "
                f"{occ['kernel_blocks_per_sm']} blocks an SM")


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


def _dense_library_call(torch, q, k, v, vl=None):
    """Yardstick only (never called by the port): PyTorch SDPA with a
    valid_len mask, or with none where every slot is valid (``vl`` None)."""
    import torch.nn.functional as F
    B, KV, G, hd = q.shape
    C = k.shape[1]
    mask = (None if vl is None else
            (torch.arange(C, device=q.device)[None] < vl[:, None])[:, None, None])
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


def _bf16_ulp(scale):
    """bf16's spacing (8 significant bits) at |values| of ``scale``."""
    return 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)


def _limit(name, scale):
    """The tolerance against the plain version for outputs whose largest
    |value| is ``scale``.  In bf16, TOL (1.6 ulps at outputs in [2, 4)) and
    the same number of ulps above 4, where bf16's spacing outgrows TOL
    (0.03125 in [4, 8)); also relative, so that small outputs (8,192 tokens
    averaged) are checked."""
    if name == "float32":
        return TOL[name]
    return min(TOL[name] * max(1.0, _bf16_ulp(scale) / 2.0 ** -6), BF16_REL * scale)


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
    The plain version rounds its probabilities to bf16, as the reference
    does, and the kernel keeps them in f32; so the kernel is also held to the
    exact answer (the plain version on the inputs in f32): in bf16 within
    one ulp at the output's scale, since its output is the f32 result
    rounded once.  Returns (max |err|, limit, max |reference|, the kernel's
    and the plain version's max |err| against the exact answer)."""
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
    exact = plain(q.float(), k.float(), v.float(), *rest)
    got = [fn(*args), fn(q, kp, vp, *rest)]
    torch.cuda.synchronize()
    err = max(float((g.float() - want).abs().max()) for g in got)
    name, scale = str(q.dtype).removeprefix("torch."), float(want.abs().max())
    limit = _limit(name, scale)
    _check_err(label, name, got, err, limit)
    exact_err = max(float((g.float() - exact).abs().max()) for g in got)
    _check_err(f"{label} against the exact answer", name, got, exact_err,
               TOL[name] if name == "float32" else _bf16_ulp(scale))
    return err, limit, scale, exact_err, float((want - exact).abs().max())


def _held(torch, label, calls):
    """``_hold_decode`` over several calls, each held to its own limit: the
    largest error with that call's limit and max |reference| (the tighter
    limit on a tie), and the largest errors against the exact answer."""
    held = [_hold_decode(torch, label, args) for args in calls]
    worst = max(held, key=lambda h: (h[0], -h[1]))
    return (*worst[:3], max(h[3] for h in held), max(h[4] for h in held))


def _log_split(torch, kernel, label, name, B, KV, C, page_size, nbytes, row, host_ms):
    """The split the wrapper chose for this shape on this card, the kernel's
    achieved rate and share of its bound, and the host's time per call."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    L, n_split = kernel._split_plan(B, KV, C, page_size, sms)
    log(f"[kernels]   {label} {name}: n_split {n_split}, L {L}, {B * KV * n_split} blocks on "
        f"{sms} SMs; {nbytes / row['ms'] / 1e6:.1f} GB/s, {row['bound_ms'] / row['ms']:.1%} "
        f"of the bound; the host enqueues a call in {host_ms:.4f} ms")


def _paged_row(torch, gen, label, name, P, B, KV, G, hd, ps, num_pages, max_len):
    """The paged kernel at one shape: held to its plain version on the first
    and last period's pool, then timed against the plain version and gather
    + SDPA over the P periods (L2 cold).  Returns the row."""
    from repro_torch.kernels import decode_attention as kernel
    from repro_torch.kernels import ref
    NB = B * num_pages + 1
    q, k, v, pt, vl = _paged_inputs(torch, gen, getattr(torch, name), P, B, KV, G, hd, ps,
                                    num_pages, NB, max_len=max_len)
    err, limit, scale, *_ = _held(torch, label, [(q[p], k[p], v[p], pt, vl) for p in (0, P - 1)])
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
    log(f"[kernels] {label} {name}: B={B} KV={KV} G={G} hd={hd} ps={ps} "
        f"num_pages={num_pages} NB={NB}, valid_len sum {tokens} max {int(vl.max())}; "
        f"max|err| {err:.3e} (tol {limit:.3e}, max|ref| {scale:.3e}, poisoned "
        f"scratch/unmapped/tail); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, gather+SDPA {library_ms:.4f} ms "
        f"(|err| {lib_err:.2e}); bound {row['bound_ms']:.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {row['bound_by']}-bound)")
    _log_split(torch, kernel, label, name, B, KV, num_pages * ps, ps, nbytes, row, host_ms)
    del q, k, v
    torch.cuda.empty_cache()
    return row


def _hold_spanning(torch, gen, label, dtype, B, KV, G, hd, C, ps=None):
    """A decode kernel (paged, with pages of ``ps`` slots; dense when ``ps``
    is None) at one shape, on drawn inputs whose lengths span the whole lane,
    so that every piece of the split the wrapper picks for this shape, the
    ragged last one too, holds tokens: lane 0 full, lane 1 one token into the
    last piece, lane 2 exactly one piece, lane 3 one token, the rest drawn in
    [1, C].  Returns (max |err|, limit, a description of the shape)."""
    from repro_torch.kernels import decode_attention as kernel
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    L, n_split = kernel._split_plan(B, KV, C, ps or 1, sms)
    vl = torch.randint(1, C + 1, (B,), generator=gen, device="cuda", dtype=torch.int32)
    vl[:4] = torch.tensor([C, min(C, (n_split - 1) * L + 1), min(C, L), 1])
    if ps:
        q, k, v, pt, vl = _paged_inputs(torch, gen, dtype, 1, B, KV, G, hd, ps, C // ps,
                                        B * (C // ps) + 1, C, vl=vl)
        inputs = (q[0], k[0], v[0], pt, vl)
    else:
        q, k, v = _dense_inputs(torch, gen, dtype, 1, B, C, KV, G, hd)
        inputs = (q[0], k[0], v[0], vl)
    err, limit, _, exact, plain_exact = _hold_decode(torch, label, inputs)
    return err, limit, (f"B={B} KV={KV} G={G} hd={hd} ps={ps or 1} C={C}, n_split {n_split} "
                        f"(pieces of {L}, the last {C - (n_split - 1) * L}), valid_len sum "
                        f"{int(vl.sum())} max {int(vl.max())}; against the exact answer: "
                        f"kernel {exact:.3e}, plain {plain_exact:.3e}")


# (family, KV, G, B, C) of phase 10's paged paths, whose (KV, G) no other row
# holds: arctic's 4 lanes of 2,048 slots, nemotron's and phi3's 8 of 1,024
FAMILY_SHAPES = (("arctic-480b", 8, 7, 4, 2048), ("nemotron-4-15b", 8, 6, 8, 1024),
                 ("phi3-medium-14b", 10, 4, 8, 1024))


def _family_holds(torch, gen):
    """Both decode kernels held to their plain versions at the families'
    paged paths' own (KV, G, B, C), so at the split plans those paths get,
    with lengths that fill every piece; hd 128, pages of 16, bf16 and f32;
    raises on a mismatch."""
    for fam, KV, G, B, C in FAMILY_SHAPES:
        for name in ("bfloat16", "float32"):
            dtype = getattr(torch, name)
            perr, plimit, shape = _hold_spanning(torch, gen, f"paged {fam}", dtype, B, KV, G,
                                                 128, C, ps=16)
            derr, dlimit, dshape = _hold_spanning(torch, gen, f"dense {fam}", dtype, B, KV, G,
                                                  128, C)
            log(f"[kernels] {fam} heads {name}: paged {shape}: max|err| {perr:.3e} (tol "
                f"{plimit:.3e}); dense {dshape}: max|err| {derr:.3e} (tol {dlimit:.3e}); "
                f"caches poisoned where no lane reads")
    torch.cuda.empty_cache()


def phase_kernels(torch):
    from repro_torch.kernels import decode_attention as kernel
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {"paged_decode_attention": {}, "decode_attention": {}, "decode_attention_ring": {}}
    P, B, KV, G, hd = 28, 8, 8, 2, 128
    for name in ("bfloat16", "float32"):
        rows["paged_decode_attention"][name] = _paged_row(
            torch, gen, "paged_decode_attention", name, P, B, KV, G, hd, ps=16, num_pages=128,
            max_len=2048)
    # the dense kernel: the linear pool's shape (random lengths) and the
    # sliding-window ring's (every slot valid)
    for label, B, C in (("decode_attention", 8, 2048), ("decode_attention_ring", 4, 8192)):
        for name in ("bfloat16", "float32"):
            vl = (torch.full((B,), C, dtype=torch.int32, device="cuda") if C == 8192 else
                  torch.randint(1, C + 1, (B,), generator=gen, device="cuda",
                                dtype=torch.int32))
            rows[label][name] = _dense_row(torch, gen, label, name, P, B, C, KV, G, hd, vl)
    rows["mamba_scan"] = _scan_rows(torch, gen)
    rows["mamba_scan_bwd"] = _scan_bwd_rows(torch)
    # drawn after the rows above, whose inputs stay those of earlier runs:
    # qwen2-moe-a2.7b's runtime decode (phase 10), 24 lanes, MHA (KV 16, G
    # 1), lanes of 512 slots, one pool a layer (24); logged only
    for name in ("bfloat16", "float32"):
        _paged_row(torch, gen, "paged_decode_attention qwen2-moe", name, 24, 24, 16, 1, hd,
                   ps=16, num_pages=32, max_len=512)
    _family_holds(torch, gen)
    # drawn last: the cross-attention decode of the audio and VLM models
    # (phase 11), one cross cache a layer, every slot valid
    for label, P, C, KV, G, hd in CROSS_SHAPES + TP_CROSS_SHAPES:
        rows[label] = {name: _dense_row(torch, gen, label, name, P, 8, C, KV, G, hd, None)
                       for name in ("bfloat16", "float32")}
    return rows


# (row, layers P, C, KV, G, hd) of phase 11's cross-attention decode:
# whisper-medium's 24 decoder layers over 1,500 encoder frames (MHA, hd 64),
# llama-3.2-vision-11b's 8 cross layers over 1,600 image patches (G 4)
CROSS_SHAPES = (("decode_attention_cross_whisper", 24, 1500, 16, 1, 64),
                ("decode_attention_cross_vlm", 8, 1600, 8, 4, 128))
# the same on a tensor-parallel shard (phase 15): whisper's 16 kv heads over
# 2 and 4 shards, the VLM's 8 over 2 and 4
TP_CROSS_SHAPES = (("decode_attention_cross_whisper_kv8", 24, 1500, 8, 1, 64),
                   ("decode_attention_cross_whisper_kv4", 24, 1500, 4, 1, 64),
                   ("decode_attention_cross_vlm_kv4", 8, 1600, 4, 4, 128),
                   ("decode_attention_cross_vlm_kv2", 8, 1600, 2, 4, 128))


def _dense_row(torch, gen, label, name, P, B, C, KV, G, hd, vl):
    """The dense kernel at one shape over P periods' caches: held to its
    plain version on the first and last period, then timed against the
    plain version and SDPA (L2 cold).  ``vl`` None is cross-attention decode:
    every slot valid (valid_len = C), SDPA with no mask, and each period's
    cache the first B lanes of a B + 1 lane buffer whose last lane is NaN, so
    that a read past a lane's end shows.  Returns the row."""
    from repro_torch.kernels import decode_attention as kernel
    from repro_torch.kernels import ref
    dtype = getattr(torch, name)
    cross = vl is None
    q, k, v = _dense_inputs(torch, gen, dtype, P, B + 1 if cross else B, C, KV, G, hd)
    if cross:
        k[:, B], v[:, B] = float("nan"), float("nan")
        q, k, v = q[:, :B].contiguous(), k[:, :B], v[:, :B]
        vl = torch.full((B,), C, dtype=torch.int32, device="cuda")
    lib_vl = None if cross else vl
    err, limit, scale, *_ = _held(torch, label, [(q[p], k[p], v[p], vl) for p in (0, P - 1)])
    ms, plain_ms, library_ms, host_ms = _time_three(
        torch, P, lambda i: kernel.decode_attention(q[i], k[i], v[i], vl),
        lambda i: ref.decode_attention_ref(q[i], k[i], v[i], vl),
        lambda i: _dense_library_call(torch, q[i], k[i], v[i], lib_vl))
    lib_err = float((_dense_library_call(torch, q[0], k[0], v[0], lib_vl).float()
                     - ref.decode_attention_ref(q[0], k[0], v[0], vl).float()).abs().max())
    tokens = int(vl.sum())
    item = q.element_size()
    nbytes = 2 * tokens * KV * hd * item + 2 * q[0].numel() * item + B * 4
    row = _row(name, err, ms, plain_ms, library_ms, nbytes, 4 * tokens * KV * G * hd)
    where = ("every slot valid, a NaN lane past the last" if cross
             else "poisoned past valid_len")
    log(f"[kernels] {label} {name}: B={B} C={C} KV={KV} G={G} hd={hd}, valid_len "
        f"sum {tokens} max {int(vl.max())}; max|err| {err:.3e} (tol {limit:.3e}, "
        f"max|ref| {scale:.3e}, {where}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA{'' if cross else ' (masked)'} {library_ms:.4f} ms (|err| {lib_err:.2e}); bound "
        f"{row['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB, {row['bound_by']}-bound)")
    _log_split(torch, kernel, label, name, B, KV, C, 1, nbytes, row, host_ms)
    del q, k, v
    torch.cuda.empty_cache()
    return row


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


def _scan_inputs(torch, gen, B, S, name, di=8192):
    """A jamba Mamba layer's scan inputs (di 8,192, or a shard's part of it;
    N 16, the model's A_log): dt f32, x/B/C in ``name``."""
    import torch.nn.functional as F
    dtype = getattr(torch, name)
    N = 16
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


def _scan_bwd_bound(B, S, di, N, item):
    """The least time for one backward of the scan: the larger of the bytes
    (dt, g_y, d dt in f32 and x, dx in ``item`` bytes a (b, t, d); B, C, dB,
    dC in ``item`` bytes a (b, t, n); A_log, dA_log and g_h in f32; each
    once), the exponentials (one per (t, d, n)) on the special-function units,
    and 19 f32 flops per (t, d, n) at the f32 peak: the adjoint's 7 products
    and 5 FMAs (2 flops each) per state in csrc/mamba_scan_bwd.cu, and the
    two sums over channels of dB and dC.  Returns (bound ms, bound_by, bytes,
    each of the three times in ms)."""
    nbytes = (B * S * di * (3 * 4 + 2 * item) + 4 * B * S * N * item + 2 * di * N * 4
              + B * di * N * 4)
    n = B * S * di * N
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "exp": n / SFU_PER_S * 1e3,
             "flops": 19 * n / PEAK_FLOPS["float32"] * 1e3}
    bound = max(times.values())
    return bound, "bytes" if times["bytes"] >= bound else "operations", nbytes, times


def _hold_scan_bwd(torch, label, got, want):
    """Each of the five gradients within SCAN_TOL x max(1, max |plain|) of the
    plain backward computed in f32; a bf16 gradient (dB, dC, dx) also within
    half a bf16 ulp of each value, the rounding of its cast.  Returns the
    largest |err| and a log string."""
    errs, worst = [], 0.0
    for part, g, w in zip(("d_dt", "dB", "dC", "dx", "dA_log"), got, want):
        scale = max(1.0, float(w.abs().max())) if w.numel() else 1.0
        limit = SCAN_TOL * scale * torch.ones_like(w)
        if g.dtype == torch.bfloat16:
            limit += torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 9)
        diff = (g.float() - w).abs()
        err = float(diff.max()) if w.numel() else 0.0
        if not bool(g.float().isfinite().all()) or not bool((diff <= limit).all()):
            raise AssertionError(f"mamba_scan_bwd {label} {part}: max |err| {err} "
                                 f"(scale {scale})")
        worst = max(worst, err)
        errs.append(f"{part} {err:.3e} ({err / scale:.1e} of {scale:.3g})")
    return worst, "max|err| " + ", ".join(errs)


BWD_LAUNCHES = ("scan_bwd_states", "scan_bwd_kernel", "scan_bwd_reduce")


def launch_split(torch, fn, n_iter, names):
    """Mean device ms per launch of each kernel in ``names`` (substrings of
    the kernels' names) over ``n_iter`` calls under torch.profiler, after
    warm-up; each call must launch each kernel once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n_iter):
            fn(i)
        torch.cuda.synchronize()
    split = {}
    for name in names:
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and name in e.key]
        count = sum(e.count for e in events)
        if count != n_iter:
            raise RuntimeError(f"torch.profiler saw {count} launches of {name}, not {n_iter}")
        split[name] = sum(e.self_device_time_total for e in events) / 1e3 / count
    return split


def _scan_bwd_rows(torch):
    """The scan's backward kernel against the plain backward at the forward
    rows' shapes, its inputs from a generator of its own (the rows drawn
    after it keep their inputs): y's and the last state's gradients drawn
    (N(0, 1)); two runs bit-equal; the main shape and all-f32 timed (held
    events, 20 calls; the plain backward unheld over 2) and split into its
    three launches (torch.profiler, 20 calls)."""
    from repro_torch.kernels import mamba_scan as scan_kernel
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    di, N = 8192, 16
    rows = {}
    for label, B, S, name in SCAN_SHAPES:
        args = _scan_inputs(torch, gen, B, S, name)
        g_y = torch.randn((B, S, di), generator=gen, device="cuda")
        g_h = torch.randn((B, di, N), generator=gen, device="cuda")
        got = scan_kernel.mamba_scan_bwd(*args, g_y, g_h)
        again = scan_kernel.mamba_scan_bwd(*args, g_y, g_h)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"mamba_scan_bwd {label}: two runs differ")
        want = ref.mamba_scan_bwd_ref(*(t.float() for t in args), g_y, g_h)
        err, msg = _hold_scan_bwd(torch, label, got, want)
        del again, want
        bound, bound_by, nbytes, times = _scan_bwd_bound(B, S, di, N, args[1].element_size())
        msg = (f"[kernels] mamba_scan_bwd {label}: B={B} S={S} di={di} N={N}, dt/g_y/g_h f32, "
               f"x/B/C {name}; {msg}; two runs bit-equal; scratch "
               f"{scan_kernel.bwd_scratch_bytes(B, S, di, N) / 1e6:.1f} MB")
        if label in ("main", "f32"):
            ms = event_ms(torch, lambda i: scan_kernel.mamba_scan_bwd(*args, g_y, g_h), 20)[0]
            plain_ms = event_ms(torch, lambda i: ref.mamba_scan_bwd_ref(*args, g_y, g_h), 2,
                                n_warm=1, hold=False)[0]
            split = launch_split(torch, lambda i: scan_kernel.mamba_scan_bwd(*args, g_y, g_h),
                                 20, BWD_LAUNCHES)
            rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "library_ms": None, "bound_ms": bound, "bound_by": bound_by,
                          "split_ms": split}
            msg += (f"; kernel {ms:.4f} ms ({bound / ms:.1%} of the bound; by launch under "
                    f"torch.profiler " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                    + f" ms), plain "
                    f"{plain_ms:.2f} ms, library none (no PyTorch call computes a selective "
                    f"scan's backward); bound {bound:.4f} ms ({bound_by}: bytes "
                    f"{nbytes / 1e6:.1f} MB {times['bytes']:.4f} ms, {B * S * di * N / 1e6:.1f} "
                    f"M exp2 on the SFUs {times['exp']:.4f} ms, 19 f32 flops a (t, d, n) "
                    f"{times['flops']:.4f} ms)")
        log(msg)
        del args, got, g_y, g_h
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


def _full_width(torch, n_layers=None):
    """qwen3-1.7b at its published widths from the seed, its depth cut to
    ``n_layers`` where given."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, param_count
    cfg = get_config("qwen3_1_7b")
    full = cfg.n_layers
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_periods=n_layers)
    params, ms = sync_ms(torch, lambda: init_params(cfg, seed=SEED, device="cuda"))
    depth = f"{cfg.n_layers} layers" + ("" if cfg.n_layers == full else f" of its {full}")
    log(f"[model] {cfg.name}: {depth}, d_model {cfg.d_model}, "
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
    sync_all(torch)
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


INTERFERENCE_BATCHES = (1, 2, 4, 8, 16, 24)


def _interference(torch, cfg, params):
    """The paper's F(batch) on the card through the port's profiler (dense
    ``decode_step``, capacity 2,048, context 1,024, 8 steps after 2 warm-up
    steps): the two halves of ``measured_interference``, so that the raw
    per-step times of ``profile_decode`` are logged beside F."""
    from repro_torch.engine import profiler
    t0 = time.perf_counter()
    raw = profiler.profile_decode(cfg, params, batch_sizes=INTERFERENCE_BATCHES,
                                  capacity=2048, context=1024, steps=8, warmup=2)
    F = profiler.interference_from_profile(raw)
    if sorted(raw) != list(INTERFERENCE_BATCHES) or \
            not all(math.isfinite(t) and t > 0 for t in raw.values()):
        raise AssertionError(f"[profile] F(batch): profile {raw}")
    log(f"[profile] F(batch) ({cfg.name} full width, dense decode_step, capacity 2048, "
        f"context 1024, 8 steps after 2; {time.perf_counter() - t0:.1f} s): "
        + ", ".join(f"b {b}: {raw[b] * 1e3:.3f} ms a step, F {F(b):.4f}"
                    for b in INTERFERENCE_BATCHES))


def phase_profile(torch):
    cfg, params = _full_width(torch)
    for paged in (True, False):
        _profile_step(torch, cfg, params, paged)
    _interference(torch, cfg, params)
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
    """Copies of one lane's KV at its resident positions and its recurrent
    state (Mamba, mLSTM or sLSTM: every leaf but k and v)."""
    seq = w.store[sid]
    n = len(seq.tokens)
    out = {}
    for key, c in w.pool["blocks"].items():
        for name, leaf in c.items():
            if name not in ("k", "v"):
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
    want = {"mamba_scan": n_mamba * admissions, "mamba_scan_bwd": 0,
            "paged_decode_attention": paged_steps,
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
    from repro_torch.models import model as M

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
    state_bytes = 2 * _nbytes(dict(M._state_blocks(w.pool)))
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
    admitted by a full forward, so the ring has wrapped); then the reduced
    jamba and xLSTM periods, and ``sample``'s tokens card vs CPU."""
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
    _reference_xlstm(torch)
    _reference_sample(torch)


def _reference_sample(torch):
    """``engine.sampler.sample`` (one key for the batch) at qwen3's
    vocabulary, B 8, seeds 0-3, greedy and at temperature 1.0, top-p 0.9:
    the tokens on the card equal to the same call's on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.engine.prng import prng_key
    from repro_torch.engine.sampler import SamplerConfig, sample

    V = get_config("qwen3_1_7b").vocab
    gen = torch.Generator().manual_seed(SEED)
    drawn = off_argmax = 0
    for seed in range(4):
        logits = 3 * torch.randn(8, V, generator=gen)
        for cfg in (SamplerConfig(0.0, 1.0), SamplerConfig(1.0, 0.9)):
            want = sample(prng_key(seed), logits, cfg)
            got = sample(prng_key(seed, "cuda"), logits.cuda(), cfg)
            if got.device.type != "cuda" or got.dtype != torch.int32:
                raise AssertionError(f"sample on the card gave {got.dtype} on {got.device}")
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"sample seed {seed} {cfg}: card {got.tolist()} vs CPU "
                                     f"{want.tolist()}")
            drawn += want.numel()
            if cfg.temperature > 0:
                off_argmax += int((want != logits.argmax(-1)).sum())
    log(f"[reference] sample (one key a batch) at V {V:,}, B 8, seeds 0-3, greedy and t 1.0 "
        f"top-p 0.9: {drawn} tokens card == CPU ({off_argmax} of the 32 drawn off the argmax)")


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
                    if n not in ("k", "v"))
    if not state_err < 1e-4:
        raise AssertionError(f"jamba admission state card vs CPU max |err| {state_err}")
    err = _teacher_forced(torch, cfg, params, gparams, pools, torch.tensor([[0], [39]]))
    log(f"[reference] reduced {cfg.name} (1 period, f32: 7 Mamba, 4 MoE): 40-token "
        f"admission, Mamba state card vs CPU max |err| {state_err:.2e} (tol 1e-4); 8 "
        f"teacher-forced decode steps, logits card vs CPU max |err| {err:.2e} (tol 1e-4)")


def _reference_xlstm(torch):
    """The reduced xLSTM period (f32: 5 mLSTM, 1 sLSTM): a 40-token chunked
    recurrent admission into a paged lane, its state card vs CPU, then
    teacher-forced decode logits."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.model import init_params, tree_to

    cfg = get_config("xlstm_350m").reduced(n_periods=1)
    params = init_params(cfg, seed=SEED, device="cpu")
    gparams = tree_to(params, "cuda")
    prompt = [(7 * i + 3) % cfg.vocab for i in range(40)]
    pools = {}
    for dev, prm in (("cpu", params), ("cuda", gparams)):
        pool = M.init_paged_pool(cfg, 2, 9, 16, 4, dev)
        M.paged_set_lane(pool, 1, np.asarray([3, 5, 7, 0], np.int32), 0)
        for off in range(0, len(prompt), 16):
            part = prompt[off:off + 16]
            buf = torch.zeros((1, 16), dtype=torch.int64)
            buf[0, :len(part)] = torch.tensor(part)
            M.prefill_chunk_paged(cfg, prm, pool, 1, buf.to(dev), len(part))
        pools[dev] = pool
    state_err = max(float((pools["cuda"]["blocks"][k][n].cpu() - c[n]).abs().max())
                    for k, c in pools["cpu"]["blocks"].items() for n in c)
    if not state_err < 1e-4:
        raise AssertionError(f"xlstm admission state card vs CPU max |err| {state_err}")
    err = _teacher_forced(torch, cfg, params, gparams, pools, torch.tensor([[0], [39]]))
    log(f"[reference] reduced {cfg.name} (1 period, f32: 5 mLSTM, 1 sLSTM): 40-token "
        f"chunked admission, state card vs CPU max |err| {state_err:.2e} (tol 1e-4); 8 "
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
# the reference trace harness's config (tests/test_orchestrator.py)
RUNTIME_BASE = dict(scheduler="pps", migration=True, max_active=2, quantum=8,
                    link_bandwidth=float("inf"), trace=True, seed=5, sanitize=True)
RUNTIME_LAYERS = 7                   # qwen3 cut from 28 layers for the script's time
CAPTURE_EVERY = 500                  # keep the inputs of every 500th decode-kernel call


class _Capture:
    """While a path runs, keeps a copy of the inputs of the first call of a
    decode kernel's wrapper and of every ``every``-th after it (of the calls
    whose arguments ``keep`` accepts, when given): the inputs the path's
    decode steps give it, masked lanes at their frozen positions included.
    The wrapper is called as before and counts its own launches; a kept call
    costs a few device copies.  Captures nest: each wraps the wrapper it
    finds.  A worker on one card replays its decode step as a CUDA graph,
    whose replays call no wrapper: a call made while such a graph is
    captured is neither counted nor kept (its inputs are made at each
    replay), so on the card the calls kept are eager ones, such as the step
    each capture runs first and the steps of a per-token absorption."""

    def __init__(self, module, name, every=CAPTURE_EVERY, keep=None):
        self.module, self.name, self.every, self.calls, self.kept = module, name, every, 0, []
        self.keep = keep

    def __enter__(self):
        import torch
        self.launch = getattr(self.module, self.name)

        def capturing(*args):
            if ((self.keep is None or self.keep(args))
                    and not (args[0].is_cuda and torch.cuda.is_current_stream_capturing())):
                self.calls += 1
                if self.calls % self.every == 1 % self.every:
                    self.kept.append([a.clone() for a in args])
            return self.launch(*args)

        setattr(self.module, self.name, capturing)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.launch)


def _hold_kept(torch, tag, kept, every=CAPTURE_EVERY):
    """The kept live calls of one run against the plain version."""
    if not kept:
        raise AssertionError(f"[runtime] {tag}: no decode-kernel call was kept")
    err, limit, scale, exact, plain_exact = _held(torch, f"[runtime] {tag} live calls", kept)
    q, *_, vl = kept[-1]
    log(f"[runtime] {tag}: {len(kept)} live decode-kernel calls (the first eager one and "
        f"every {every}th after; "
        f"the last: q {tuple(q.shape)}, cache {tuple(kept[-1][1].shape)}, valid_len "
        f"{sorted(vl.tolist())}) against the plain version, cache poisoned where no lane "
        f"reads: max|err| {err:.3e} (tol {limit:.3e}, max|ref| {scale:.3e}); against the "
        f"exact answer: kernel {exact:.3e}, plain {plain_exact:.3e}")
    return err


def _hold_runtime_shapes(torch, paged_args, dense_args):
    """Both decode kernels at the runtime's shapes (taken from a kept live
    call of each) on drawn inputs whose lengths fill every piece of the split
    (``_hold_spanning``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    for label, args in (("paged_decode_attention", paged_args),
                        ("decode_attention", dense_args)):
        q = args[0]
        B, KV, G, hd = q.shape
        ps, C = (args[1].shape[1], args[3].shape[1] * args[1].shape[1]) if len(args) == 5 \
            else (None, args[1].shape[1])
        err, limit, shape = _hold_spanning(torch, gen, f"[runtime] {label} at the runtime's shape",
                                           q.dtype, B, KV, G, hd, C, ps=ps)
        errs[label] = err
        log(f"[runtime] {label} at the runtime's shape: {shape}; max|err| {err:.3e} "
            f"(tol {limit:.3e}, cache poisoned where no lane reads)")
    return errs


def _runtime_run(torch, tag, cfg, params, batch, predictor, config, faults=None,
                 profile_run=False, fleet=None, devices=None, every=CAPTURE_EVERY):
    """One RolloutRuntime run on the card beside its analytic twin: counts
    zeroed just before the run and read just after; the engine's trace held to
    the sim's; the decode kernel's inputs kept every ``every``-th call.  Two
    workers of degree 1 on cuda:0, or the ``fleet`` spec carved
    over ``devices``.  Returns (result, launches, checkpoints written, kept
    inputs, each worker's dispatch_stats)."""
    import copy
    from repro_torch.engine.runtime import make_runtime, run_on_sim, split_restores
    from repro_torch.kernels import decode_attention as kernel

    sim = run_on_sim(copy.deepcopy(batch), predictor, n_workers=2, config=config,
                     faults=faults, fleet=fleet)
    rt = make_runtime(cfg, params, batch, predictor, n_workers=2, config=config,
                      capacity=RUNTIME_CAPACITY, faults=faults, fleet=fleet, devices=devices)
    written = {}
    checkpoint = rt.backend.checkpoint

    def recording(traj):
        checkpoint(traj)
        if traj.traj_id in rt.backend.ckpts:
            written[traj.traj_id] = rt.backend.ckpts[traj.traj_id]

    rt.backend.checkpoint = recording
    rt.fleet.tracer.on = True                   # the workers' calls, timed on the host
    name = "decode_attention" if config.paged is False else "paged_decode_attention"
    torch.cuda.synchronize()
    with _Capture(kernel, name, every) as capture:
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
    for view, s in zip(rt.workers, stats):
        # a worker on one card replays its decode graph for every step but
        # each capture's own eager one; a sharded worker runs the eager loop
        graphed = s["decode_graph_steps"] + s["decode_graph_captures"]
        if graphed != (s["decode_steps"] if view.engine._graph is not None else 0):
            raise AssertionError(f"[runtime] {tag}: {graphed} graphed decode steps of "
                                 f"{s['decode_steps']} ({s})")
    totals = rt.fleet.tracer.export()["totals"]
    inside = sum(t["seconds"] for name, t in totals.items() if name.startswith("worker."))
    log(f"[runtime] {tag}: wall {res.wall_time * 1e3:.1f} ms, {inside * 1e3:.1f} ms "
        f"of it inside the workers' calls (the fleet's tracer, host clock); "
        f"{res.total_tokens} real tokens decoded ({res.total_tokens / res.wall_time:.1f} "
        f"tokens/s); decode calls {[s['decode_calls'] for s in stats]}, decode steps "
        f"{[s['decode_steps'] for s in stats]} (by graph replay "
        f"{[s['decode_graph_steps'] for s in stats]}, graph captures "
        f"{[s['decode_graph_captures'] for s in stats]}), decode wall "
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
    return res, launches, written, capture.kept, stats


def phase_runtime(torch, smi):
    """The control plane over the port's workers on the card: qwen3-1.7b at
    full width (RUNTIME_LAYERS of its layers), two RolloutWorkers driven by
    the orchestrator through EngineBackend on the reference harness's
    workload, each run held to the sim's decision trace, and the decode
    kernels held to their plain versions on live calls of each run and at
    the runtime's shapes.  Returns the
    decode kernels' launches per run and their largest errors there."""
    import copy
    import os
    import tempfile
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core.faults import FaultPlan
    from repro_torch.engine.runtime import RuntimeConfig, build_workbench, run_on_sim
    from repro_torch.models import model as M

    cfg, params = _full_width(torch, RUNTIME_LAYERS)
    log(f"[runtime] {smi}")
    base = RUNTIME_BASE
    out = {}
    batch, predictor = build_workbench(n_prompts=6, group_size=4, seed=5)
    res, launches, _, kept, _ = _runtime_run(torch, "paged", cfg, params, batch, predictor,
                                             RuntimeConfig(**base))
    if res.preemptions == 0 or res.migrations == 0:
        raise AssertionError(f"[runtime] paged: preemptions {res.preemptions}, "
                             f"migrations {res.migrations}: the parity does not bite")
    out["paged"] = launches["paged_decode_attention"]
    errs = {"paged_decode_attention": [_hold_kept(torch, "paged", kept)]}
    paged_args = kept[-1]

    batch, predictor = build_workbench(n_prompts=6, group_size=4, seed=5)
    _, launches, _, kept, _ = _runtime_run(torch, "dense", cfg, params, batch, predictor,
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
        res, launches, written, kept, _ = _runtime_run(
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


# ---------------------------------------------------------------- phase 10
def _family_model(torch, name, **cut):
    """A config of the port's registry (depth cut by ``cut``) and its random
    params on the card, with the peak-memory counter reset.  The previous
    model's runtime holds reference cycles, so garbage is collected first
    and the peak is this model's alone."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, param_count
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[families] allocated before {name}: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    full = get_config(name)
    cfg = dataclasses.replace(full, **cut)
    params, ms = sync_ms(torch, lambda: init_params(cfg, seed=SEED, device="cuda"))
    depth = (f"{cfg.n_layers} layers" if cfg == full
             else f"{cfg.n_layers} of its {full.n_layers} layers")
    log(f"[families] {cfg.name}: {depth} ({' '.join(cfg.block_pattern)}), d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff {cfg.d_ff}, "
        f"experts {cfg.n_experts} top-{cfg.top_k} x {cfg.moe_d_ff}, shared {cfg.shared_d_ff}, "
        f"dense residual {cfg.dense_residual_ff}, vocab {cfg.vocab}, {cfg.dtype}; "
        f"{param_count(params) / 1e9:.3f} B params, {_nbytes(params) / 1e9:.2f} GB "
        f"(init {ms:.0f} ms)")
    return cfg, params


def _peak(torch, tag):
    log(f"[families] {tag}: peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def _check_launches(tag, launches, want):
    full = {name: 0 for name in launches}
    full.update(want)
    if launches != full or not any(want.values()):
        raise AssertionError(f"[families] {tag}: launches {launches}, want {full}")


FAMILY_MOE_LAYERS = 4                # qwen2-moe cut from 24 layers for the script's time


def _families_moe(torch):
    """qwen2-moe-a2.7b at full width under the runtime, on phase 9's workload
    and settings: the paged plane and the dense plane, each trace held to the
    sim's; every decode step (a per-token tool absorption included) launches
    the plane's decode kernel once a layer.  The depth is cut to
    FAMILY_MOE_LAYERS of 24 layers to keep the script's time: the two runs
    are host-bound at ~859 steps each, and took 200 s at 24 layers and
    118.8 s at 12 (on a four-card H100 host).  Returns {plane: (launches,
    largest error of the kept live calls)}."""
    import gc
    from repro_torch.engine.runtime import RuntimeConfig, build_workbench

    cfg, params = _family_model(torch, "qwen2_moe_a2_7b", n_periods=FAMILY_MOE_LAYERS)
    out = {}
    for plane, config in (("paged", RuntimeConfig(**RUNTIME_BASE)),
                          ("dense", RuntimeConfig(**dict(RUNTIME_BASE, paged=False,
                                                         migration=False)))):
        tag = f"qwen2-moe {plane}"
        gc.collect()                                # the previous run's runtime
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        batch, predictor = build_workbench(n_prompts=6, group_size=4, seed=5)
        res, launches, _, kept, stats = _runtime_run(torch, tag, cfg, params, batch, predictor,
                                                     config)
        if plane == "paged" and (res.preemptions == 0 or res.migrations == 0):
            raise AssertionError(f"[families] {tag}: preemptions {res.preemptions}, "
                                 f"migrations {res.migrations}: the parity does not bite")
        if any(s["prefill_dispatches"] for s in stats):
            raise AssertionError(f"[families] {tag}: MoE took chunked admission")
        steps = sum(s["decode_steps"] + s["absorbed_tokens"] for s in stats)
        name = "paged_decode_attention" if plane == "paged" else "decode_attention"
        _check_launches(tag, launches, {name: cfg.n_layers * steps})
        log(f"[families] {tag}: {sum(s['decode_steps'] for s in stats)} decode steps + "
            f"{sum(s['absorbed_tokens'] for s in stats)} tool tokens absorbed one step each "
            f"= {steps} steps; {name} launches {launches[name]} = {cfg.n_layers} x {steps}")
        _peak(torch, tag)
        out[plane] = (launches[name], _hold_kept(torch, tag, kept))
        del kept
    del params
    return out


def _families_xlstm(torch):
    """xlstm-350m at its published widths: two paged workers (pure-state pools) and a
    dense one; two GRPO groups of 4 admitted by chunked recurrent prefill;
    decode, a chunked extend, preempt and resume, migration paged -> dense ->
    paged, a checkpoint restored, each lane's state held exactly; a released
    slot readmitted, its state equal to a fresh lane's.  No kernel of the
    repo runs (xLSTM has no TPU kernel).  The depth is cut to one of its
    four periods (6 of 24 layers) to keep the script's time: its chunked
    admissions, one step a token, took 79 s at 24 layers, and phase 15 runs
    the whole depth."""
    import numpy as np
    from repro_torch.engine.paging import check_block_conservation
    from repro_torch.engine.sampler import SamplerConfig
    from repro_torch.engine.worker import RolloutWorker

    cfg, params = _family_model(torch, "xlstm_350m", n_periods=1)
    kw = dict(capacity=1024, max_slots=8, sampler=SamplerConfig(1.0, 0.9), seed=SEED,
              device="cuda")
    w0 = RolloutWorker(cfg, params, worker_id=0, page_size=16, **kw)
    w1 = RolloutWorker(cfg, params, worker_id=1, page_size=16, **kw)
    wd = RolloutWorker(cfg, params, worker_id=2, paged=False, **kw)
    if not (w0._paged and w0._chunked and not w0._reuse and w0._page_bytes == 0
            and not wd._paged):
        raise AssertionError("xlstm must take paged chunked admission into a pure-state pool")
    lane_mb = w0._state_bytes / 1e6
    rng = np.random.default_rng(SEED + 5)
    groups = [rng.integers(0, cfg.vocab, n).tolist() for n in (512, 300)]
    run = Script(torch, cfg)

    _reset_launches()                                       # the xlstm path starts here
    for sid in range(8):
        run.timed("prefill", lambda: w0.prefill(sid, groups[sid // 4]))
    _same_state(torch, "GRPO siblings", _lane_state(w0, 0), _lane_state(w0, 1))
    run.decode(w0, list(range(8)), 32)
    run.timed("extend", lambda: w0.extend(0, rng.integers(0, cfg.vocab, 16).tolist()))
    w0.preempt(1)
    held = _lane_state(w0, 1)
    run.decode(w0, [0, 2, 3, 4, 5, 6, 7], 8)
    _same_state(torch, "preempted lane", held, _lane_state(w0, 1))   # masked: state kept
    run.decode(w0, [1], 8)                                  # resume
    for src, dst, leg in ((w0, wd, "paged -> dense"), (wd, w1, "dense -> paged")):
        held = _lane_state(src, 2)
        pkg = run.timed("migrate", lambda: src.migrate_out(2))
        run.timed("migrate", lambda: dst.migrate_in(pkg))
        _same_state(torch, f"migration {leg}", held, _lane_state(dst, 2))
        run.decode(dst, [2], 8)
    ck = run.timed("checkpoint", lambda: w0.checkpoint_out(3))
    run.timed("checkpoint", lambda: w1.migrate_in(dict(ck, seq_id=100)))
    _same_state(torch, "checkpoint restore", _lane_state(w0, 3), _lane_state(w1, 100))
    # slot reuse: seq 2's released lane on w0 takes a new admission, which
    # must start fresh: its state equals the same admission on an unused lane
    prompt = rng.integers(0, cfg.vocab, 64).tolist()
    run.timed("prefill", lambda: w0.prefill(200, prompt))
    run.timed("prefill", lambda: w1.prefill(201, prompt))
    if w0.store[200].slot != 2 or w1.store[201].slot != 2:
        raise AssertionError(f"readmission took lanes {w0.store[200].slot}, "
                             f"{w1.store[201].slot}, not the released lane 2 and a fresh one")
    _same_state(torch, "readmitted lane vs a fresh lane", _lane_state(w1, 201),
                _lane_state(w0, 200))
    run.decode(w0, [200], 8)
    run.release_all(w0, w1, wd)
    launches = _read_launches(torch)                        # the xlstm path ends
    if any(launches.values()):
        raise AssertionError(f"[families] xlstm launched a repo kernel: {launches}")
    for i, w in enumerate((w0, w1)):
        bad = check_block_conservation(w.dispatch_stats())
        if bad:
            raise AssertionError(f"xlstm worker {i}: {bad}")
    admitted = 4 * sum(map(len, groups)) + 2 * len(prompt)
    log(f"[families] xlstm: state {lane_mb:.1f} MB a lane; 10 admissions ({admitted} tokens, "
        f"chunked recurrent prefill, {run.times['prefill'] / admitted:.3f} ms a token); decode "
        f"steps paged {w0.decode_steps} + {w1.decode_steps}, dense {wd.decode_steps}; a "
        f"16-token chunked extend; lane state held exactly through sibling admission, "
        f"preemption, 2 migrations, a checkpoint and slot reuse; launches {launches}")
    steps = w0.decode_steps + w1.decode_steps + wd.decode_steps
    run.report("families xlstm", steps)
    del w0, w1, wd, pkg, ck, params


def _families_paged(torch, name, prompt_lens, steps, lanes, capacity, **cut):
    """One paged worker of a config at its published widths: ``lanes``
    requests in groups of 4 (radix page sharing where the config chunks),
    ``steps`` decode steps, with 4 of the paged kernel's live calls (the
    last one included) kept and held to the plain version.  Returns (the
    paged kernel's launches, the largest error of the kept calls)."""
    import numpy as np
    from repro_torch.engine.paging import check_block_conservation
    from repro_torch.engine.sampler import SamplerConfig
    from repro_torch.engine.worker import RolloutWorker
    from repro_torch.kernels import decode_attention as kernel

    cfg, params = _family_model(torch, name, **cut)
    w = RolloutWorker(cfg, params, capacity=capacity, max_slots=lanes, page_size=16,
                      sampler=SamplerConfig(1.0, 0.9), seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED + 6)
    groups = [rng.integers(0, cfg.vocab, n).tolist() for n in prompt_lens]
    run = Script(torch, cfg)
    _reset_launches()                                       # the path starts here
    for sid in range(lanes):
        run.timed("prefill", lambda: w.prefill(sid, groups[sid // 4]))
    stats = w.dispatch_stats()
    if w._reuse and (stats["blocks_shared"] == 0
                     or stats["reused_tokens"] < 3 * sum(map(len, groups))):
        raise AssertionError(f"{cfg.name}: radix page sharing did not engage: {stats}")
    every = cfg.n_layers * steps // 4
    with _Capture(kernel, "paged_decode_attention", every) as capture:
        run.decode(w, list(range(lanes)), steps)
    run.release_all(w)
    launches = _read_launches(torch)                        # the path ends
    _check_launches(cfg.name, launches, {"paged_decode_attention": cfg.n_layers * steps})
    bad = check_block_conservation(w.dispatch_stats())
    if bad:
        raise AssertionError(f"{cfg.name}: {bad}")
    log(f"[families] {cfg.name}: {lanes} requests (prompts of "
        f"{', '.join(map(str, prompt_lens))} tokens, "
        f"{'chunked, radix page sharing' if w._reuse else 'whole-prompt admission'}; "
        f"{stats['reused_tokens']} prompt tokens reused), {steps} decode steps; "
        f"paged_decode_attention launches {launches['paged_decode_attention']} = "
        f"{cfg.n_layers} x {steps}")
    run.report(f"families {cfg.name}", steps)
    err = _hold_kept(torch, cfg.name, capture.kept, every)
    del w, params, capture
    return launches["paged_decode_attention"], err


def phase_families(torch, smi):
    """The remaining language-model families on the card: qwen2-moe under the
    runtime (the main path), xlstm's recurrent lanes, arctic at its published
    widths cut to one layer, nemotron and phi3 at full width.  Each model is
    freed before the next.  Returns the decode kernels' launches and their
    largest errors on kept live calls."""
    log(f"[families] {smi}")
    moe = _families_moe(torch)
    torch.cuda.empty_cache()
    _families_xlstm(torch)
    torch.cuda.empty_cache()
    # arctic: 35 layers of 13.6 B params do not fit on one 80 GB card
    paged = [moe["paged"],
             _families_paged(torch, "arctic_480b", (1024,), 32, 4, 2048, n_periods=1)]
    torch.cuda.empty_cache()
    for name in ("nemotron_4_15b", "phi3_medium_14b"):
        paged.append(_families_paged(torch, name, (300, 257), 32, 8, 1024))
        torch.cuda.empty_cache()
    return {"paged": sum(n for n, _ in paged), "dense": moe["dense"][0],
            "max_abs_err": {"paged_decode_attention": max(e for _, e in paged),
                            "decode_attention": moe["dense"][1]}}


# ---------------------------------------------------------------- phase 11
ENC_LANES, ENC_STEPS = 8, 64
# (config, prompt tokens, capacity): whisper's decoder context is 448 tokens
# (its n_text_ctx); the VLM's prompts stay at 512, so that its plain
# cross-attention at admission (S x T scores in f32) stays under 1 GB
ENCODER_PATHS = (("whisper_medium", 64, 448), ("llama_3_2_vision_11b", 512, 1024))
XGATE = 0.7


def _open_gates(tree):
    """Every ``xgate`` of a param tree set to XGATE, in place: the VLM's gates
    start at 0, and tanh(0) = 0 would hide its cross-attention."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _open_gates(leaf)
        elif name == "xgate":
            leaf.fill_(XGATE)
    return tree


def _cross_batch(torch, cfg, B, S, gen, device):
    """B prompts of S tokens and the config's embeddings (B, T, d) in its
    dtype (frames for audio, patches for the VLM), drawn from ``gen``."""
    from repro_torch.models.model import torch_dtype
    key, T = (("encoder_embeds", cfg.encoder_seq) if cfg.arch_type == "audio"
              else ("image_embeds", cfg.image_seq))
    return {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device),
            key: torch.randn((B, T, cfg.d_model), generator=gen, device=device,
                             dtype=torch_dtype(cfg))}


def _decode_calls(cfg):
    """(self-, cross-attention) decode-kernel calls of one decode step."""
    kinds = [k.partition("+")[0] for k in cfg.block_pattern]
    return ((kinds.count("attn") + kinds.count("dec")) * cfg.n_periods,
            (kinds.count("xattn") + kinds.count("dec")) * cfg.n_periods)


def _encoders_full(torch, name, prompt, capacity):
    """One model of phase 11 at its published widths, gates open: 8 requests
    admitted by one ``forward_full`` over their embeddings (the encoder or
    the projector included), then ENC_STEPS decode steps sampled at
    temperature 1.0 / top-p 0.9.  The dense kernel's launches must be one a
    self- and one a cross-attention layer a step; 4 live calls of each kind
    (the last among them) are held to the plain version.  Returns (launches,
    largest error of the kept calls)."""
    from repro_torch.engine import prng
    from repro_torch.engine.sampler import SamplerConfig, sample_slots
    from repro_torch.kernels import decode_attention as kernel
    from repro_torch.models import model as M

    cfg, params = _family_model(torch, name)
    _open_gates(params)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = _cross_batch(torch, cfg, ENC_LANES, prompt, gen, "cuda")
    T = cfg.encoder_seq or cfg.image_seq
    n_self, n_cross = _decode_calls(cfg)
    sampler = SamplerConfig(1.0, 0.9)
    keys = prng.fold_in(prng.prng_key(SEED, "cuda"), torch.arange(ENC_LANES, device="cuda"))
    source = (f"an encoder of {cfg.encoder_layers} layers over {T} frames"
              if cfg.arch_type == "audio" else f"a projector over {T} patches, gates {XGATE}")
    log(f"[encoders] {cfg.name}: {source}; {n_self} self- and {n_cross} cross-attention "
        f"layers; {ENC_LANES} requests, prompts of {prompt} tokens, capacity {capacity}")

    _reset_launches()                                       # the path starts here
    (logits, _, cache), admit_ms = sync_ms(
        torch, lambda: M.forward_full(cfg, params, batch, capacity=capacity))
    tok = sample_slots(prng.fold_in(keys, cache["pos"] - 1), logits[:, -1], sampler)
    out = []

    def decode():
        nonlocal tok
        for _ in range(ENC_STEPS):
            step_keys = prng.fold_in(keys, cache["pos"])
            lg, _ = M.decode_step(cfg, params, cache, tok[:, None])
            tok = sample_slots(step_keys, lg, sampler)
            out.append(tok)
        return lg

    with _Capture(kernel, "decode_attention", n_cross * ENC_STEPS // 4,
                  keep=lambda a: a[1].shape[1] == T) as cross, \
            _Capture(kernel, "decode_attention", n_self * ENC_STEPS // 4,
                     keep=lambda a: a[1].shape[1] == capacity) as self_:
        last, decode_ms = sync_ms(torch, decode)
    launches = _read_launches(torch)                        # the path ends
    tag = f"encoders {cfg.name}"
    _check_launches(tag, launches, {"decode_attention": ENC_STEPS * (n_self + n_cross)})
    toks = torch.stack(out)
    if not (bool(logits.isfinite().all()) and bool(last.isfinite().all())
            and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab):
        raise AssertionError(f"[encoders] {cfg.name}: non-finite logits or bad tokens")
    item = torch.empty((), dtype=M.torch_dtype(cfg)).element_size()
    weights = _nbytes({k: v for k, v in params.items()
                       if k in ("blocks", "lm_head", "final_norm")})
    cross_kv = sum(leaf.numel() * leaf.element_size() for c in cache["blocks"].values()
                   for n, leaf in c.items() if n in ("xk", "xv"))
    mean_len = prompt + (ENC_STEPS + 1) / 2
    self_kv = 2 * n_self * ENC_LANES * mean_len * cfg.n_kv_heads * cfg.hd * item
    bound = (weights + cross_kv + self_kv) / HBM_BYTES_PER_S * 1e3
    log(f"[encoders] {cfg.name}: admission {admit_ms:.1f} ms ({ENC_LANES} x {prompt} tokens "
        f"over {T} embeddings, {source.split(' over ')[0]} included); decode {decode_ms / ENC_STEPS:.2f} ms a step ({ENC_STEPS} steps, "
        f"{ENC_LANES * ENC_STEPS / (decode_ms / 1e3):.1f} tokens/s, sampling included); "
        f"bound of a step {bound:.4f} ms (weights {weights / 1e9:.3f} GB + cross K/V "
        f"{cross_kv / 1e9:.3f} GB + self K/V {self_kv / 1e9:.3f} GB read once); "
        f"decode_attention launches {launches['decode_attention']} = {ENC_STEPS} x "
        f"({n_self} + {n_cross}); peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    err = max(_hold_kept(torch, f"{tag} cross-attention", cross.kept, cross.every),
              _hold_kept(torch, f"{tag} self-attention", self_.kept, self_.every))
    _profile_decode(torch, cfg, params, cache, tok, decode_ms / ENC_STEPS)
    del params, cache, batch, logits, last, cross, self_
    return launches["decode_attention"], err


def _profile_decode(torch, cfg, params, cache, tok, wall_ms, n=4):
    """Device time of ``n`` more greedy decode steps under torch.profiler:
    busy ms and launches a step, the dense kernel's share, and the busy
    share of the unprofiled wall ``wall_ms`` of a step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            lg, _ = M.decode_step(cfg, params, cache, tok[:, None])
            tok = lg.argmax(-1)
        torch.cuda.synchronize()
    kern, busy = _device_time(prof, n)
    attn = sum(e.self_device_time_total for e in kern if "decode_kernel" in e.key) / 1e3 / n
    log(f"[encoders] {cfg.name}: a decode step under torch.profiler ({n} steps): device "
        f"busy {busy:.3f} ms, {busy / wall_ms:.1%} of the unprofiled wall "
        f"{wall_ms:.2f} ms; {sum(e.count for e in kern) / n:.0f} device launches; "
        f"dense decode kernel {attn:.3f} ms ({attn / busy if busy else 0:.1%} of busy)")
    for e in kern[:6]:
        log(f"[encoders]   {e.self_device_time_total / 1e3 / n:8.3f} ms/step "
            f"{e.count / n:6.0f}x  {e.key[:90]}")


def _reference_cross(torch, name):
    """A reduced model of phase 11 (f32, gates open) on the card and on the
    CPU: admission logits from one ``forward_full`` over embeddings drawn
    from the seed, then 8 teacher-forced decode steps; logits card (the
    kernel) vs CPU (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.model import init_params, tree_to

    full = get_config(name)
    cfg = full.reduced(n_periods=2 if len(full.block_pattern) == 1 else 1)
    params = _open_gates(init_params(cfg, seed=SEED, device="cpu"))
    gparams = tree_to(params, "cuda")
    batch = _cross_batch(torch, cfg, 2, 12, torch.Generator().manual_seed(SEED), "cpu")
    pools, logits = {}, {}
    for dev, prm in (("cpu", params), ("cuda", gparams)):
        logits[dev], _, pools[dev] = M.forward_full(cfg, prm, tree_to(batch, dev), capacity=24)
    admit = float((logits["cuda"].cpu() - logits["cpu"]).abs().max())
    if not admit < 1e-4:
        raise AssertionError(f"{cfg.name}: admission logits card vs CPU max |err| {admit}")
    err = _teacher_forced(torch, cfg, params, gparams, pools, torch.tensor([[0], [1]]))
    gates = f", gates {XGATE}" if cfg.arch_type == "vlm" else ""
    log(f"[encoders] reduced {cfg.name} ({cfg.n_layers} layers, f32{gates}): "
        f"admission logits card vs CPU max |err| {admit:.2e}, 8 teacher-forced decode "
        f"steps max |err| {err:.2e} (tol 1e-4)")


def phase_encoders(torch, smi):
    """The audio encoder-decoder and the VLM's gated cross-attention through
    the model API: whisper-medium and llama-3.2-vision-11b at their published
    widths, each freed before the next, then both reduced, card vs CPU.
    Returns the dense kernel's launches and the largest error of the kept
    live calls."""
    log(f"[encoders] {smi}")
    runs = []
    for name, prompt, capacity in ENCODER_PATHS:
        runs.append(_encoders_full(torch, name, prompt, capacity))
        torch.cuda.empty_cache()
    for name, _, _ in ENCODER_PATHS:
        _reference_cross(torch, name)
    return {"launches": sum(n for n, _ in runs), "max_abs_err": max(e for _, e in runs)}


# ---------------------------------------------------------------- phase 12
# qwen3-1.7b's layer shape for flash attention: B 1, KV 8, G 2, S 4,096, hd 128
FLASH_SHAPE = (1, 8, 2, 4096, 128)
FLASH_TOL = {"float32": (1e-5, 5e-5),       # (output, gradients) x max(1, max |plain|):
             "bfloat16": (4e-3, 6e-3)}      # f32 sums in another order; bf16 inputs, outputs
#                                             (bf16: 1.6-2.4x the largest errors measured on
#                                             an H100, 2.4e-3 / 3.7e-3 of max |plain|)
TRAIN_S = 4096                              # the GRPO step's sequence (B 2, remat on)
TRAIN_LR = 1e-2                             # large enough to move every bf16 leaf in one step
TRAIN_CAPTURE = 100                         # keep every 100th paged-kernel call of (c)
TRAINER_LAYERS = 7                          # (c)'s qwen3 cut from 28 layers
LEGACY_CAPTURE = 8                          # keep every 8th dense-kernel call of (e)


def _plain_attention(torch, q, k, v, window):
    """Causal (optionally windowed) GQA attention in f32 as one softmax:
    q (B, KV, G, S, hd), k/v (B, T, KV, hd)."""
    S, T = q.shape[3], k.shape[1]
    s = torch.einsum("bkgqd,btkd->bkgqt", q.float(), k.float()) / math.sqrt(q.shape[-1])
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    mask = i >= j
    if window:
        mask &= i - j < window
    s = s.masked_fill(~mask, -1e30)
    return torch.einsum("bkgqt,btkd->bkgqd", torch.softmax(s, -1), v.float())


def _train_flash(torch):
    """(a) flash forward and backward at qwen3's layer shape, causal and with
    a 1,024-token window, f32 and bf16, against plain attention under
    autograd in f32 on the same inputs; fwd+bwd timed beside SDPA's."""
    from repro_torch.models import layers as TL
    from repro_torch.models.flash import flash_attention

    B, KV, G, S, hd = FLASH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    base = [torch.randn(shape, generator=gen, device="cuda")
            for shape in ((B, KV, G, S, hd), (B, S, KV, hd), (B, S, KV, hd), (B, KV, G, S, hd))]
    pos = torch.arange(S, device="cuda")
    scale = 1 / math.sqrt(hd)
    for window in (0, 1024):
        for dtype in ("float32", "bfloat16"):
            q, k, v, dout = (t.to(getattr(torch, dtype)) for t in base)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            got = flash_attention(*leaves, pos, pos, scale, True, window, TL._QBLK, TL._KBLK)
            grads = torch.autograd.grad(got, leaves, dout)
            ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
            want = _plain_attention(torch, *ref_leaves, window)
            want_grads = torch.autograd.grad(want, ref_leaves, dout.float())
            tol_out, tol_grad = FLASH_TOL[dtype]
            errs = []
            for name, a, b, tol in (("out", got, want, tol_out),
                                    *(("d" + n, a, b, tol_grad)
                                      for n, a, b in zip("qkv", grads, want_grads))):
                scale_ref = max(1.0, float(b.detach().abs().max()))
                err = float((a.float() - b).detach().abs().max())
                if not (err <= tol * scale_ref and bool(a.isfinite().all())):
                    raise AssertionError(f"[train] flash {dtype} window {window} {name}: "
                                         f"max|err| {err:.3e} > {tol} x {scale_ref:.3g}")
                errs.append(f"{name} {err:.2e} (max|ref| {scale_ref:.3g})")
            log(f"[train] flash B {B}, KV {KV}, G {G}, S {S}, hd {hd}, causal, window "
                f"{window}, {dtype}: against plain attention in f32 under autograd: "
                f"{', '.join(errs)}; limits {tol_out} / {tol_grad} x max(1, max|ref|)")
            del got, grads, want, want_grads, ref_leaves
            if window == 0:
                def flash_step(_):
                    o = flash_attention(*leaves, pos, pos, scale, True, 0, TL._QBLK, TL._KBLK)
                    torch.autograd.grad(o, leaves, dout)

                qh = q.reshape(B, KV * G, S, hd).detach().requires_grad_()
                kh, vh = (t.permute(0, 2, 1, 3).repeat_interleave(G, 1).contiguous()
                          .requires_grad_() for t in (k, v))
                douth = dout.reshape(B, KV * G, S, hd)

                def sdpa_step(_):
                    o = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh,
                                                                         is_causal=True)
                    torch.autograd.grad(o, (qh, kh, vh), douth)

                # ~1,100 launches a call: more than the launch queue holds behind
                # a spin kernel, so the stream is not held (the ops are long)
                ms, host = event_ms(torch, flash_step, 3, n_warm=2, hold=False)
                lib_ms, _ = event_ms(torch, sdpa_step, 10)
                flops = 4 * B * KV * G * S * S * hd          # the forward's two products
                log(f"[train] flash fwd+bwd {dtype}: {ms:.3f} ms (host {host:.3f} ms to "
                    f"enqueue); SDPA fwd+bwd (is_causal, K/V expanded to {KV * G} heads) "
                    f"{lib_ms:.3f} ms; bound of fwd+bwd (3.5 x the forward's {flops / 1e9:.1f} "
                    f"GFLOP, no causal skip; its products run in f32, at 67 TFLOP/s) "
                    f"{3.5 * flops / PEAK_FLOPS['float32'] * 1e3:.3f} ms")
            del leaves
    torch.cuda.empty_cache()


def _train_step(torch):
    """(b) one GRPO step at qwen3-1.7b full width: B 2, S 4,096, remat on,
    advantages +-1, old logprobs from the policy's own forward.  The loss and
    every gradient finite, every leaf with a gradient moved, f32 moments."""
    import gc
    from repro_torch.models import model as M
    from repro_torch.rl import grpo as G
    from repro_torch.rl.optimizer import AdamW

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = _full_width(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, S = 2, TRAIN_S
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda",
                           dtype=torch.int32)
    mask = torch.zeros(B, S, device="cuda")
    mask[0, 64:S - 1] = 1.0                                 # rows of unequal length, so
    mask[1, 64:S - 257] = 1.0                               # the loss is not 0 at ratio 1
    batch = {"tokens": tokens, "loss_mask": mask,
             "advantages": torch.tensor([1.0, -1.0], device="cuda")}
    with torch.no_grad():
        (logits, _), old_ms = sync_ms(torch, lambda: M.forward_full(cfg, params,
                                                                    {"tokens": tokens}))
        batch["old_logprobs"] = G.token_logprobs(logits, tokens)
    del logits
    opt = AdamW(lr=TRAIN_LR)
    state = opt.init(params)
    before_gib = torch.cuda.max_memory_allocated() / 2**30
    gcfg = G.GRPOConfig(group_size=2)
    (loss, metrics, grads), grad_ms = sync_ms(torch, lambda: G.value_and_grad(
        lambda p: G.grpo_loss(cfg, gcfg, p, batch), params))
    grad_peak = torch.cuda.max_memory_allocated() / 2**30
    (new, state), opt_ms = sync_ms(torch, lambda: opt.update(grads, state, params))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"[train] step: loss {float(loss)}")
    leaves = list(zip(M.tree_leaves(params), M.tree_leaves(grads), M.tree_leaves(new)))
    for p, g, n in leaves:
        if not bool(g.isfinite().all()):
            raise AssertionError("[train] step: a non-finite gradient")
        if bool(g.ne(0).any()) and torch.equal(n, p):
            raise AssertionError(f"[train] step: a leaf {tuple(p.shape)} with a gradient "
                                 "did not move")
    if any(m.dtype != torch.float32 for m in M.tree_leaves(state.mu)):
        raise AssertionError("[train] step: AdamW moments are not f32")
    tokens_step = B * S
    flops = 6 * M.param_count(params) * tokens_step
    log(f"[train] GRPO step at full width ({cfg.name}, B {B}, S {S}, remat on, bf16): loss "
        f"{float(loss):+.5f}, pg_loss {float(metrics['pg_loss']):+.5f}, approx_kl "
        f"{float(metrics['approx_kl']):+.3e}; {len(leaves)} leaves, every gradient finite, "
        f"every leaf with a gradient moved (lr {TRAIN_LR}); moments f32")
    log(f"[train] step wall {grad_ms + opt_ms:.1f} ms (loss and gradients {grad_ms:.1f}, "
        f"AdamW {opt_ms:.1f}; old-policy forward {old_ms:.1f}); {tokens_step} tokens, "
        f"{tokens_step / ((grad_ms + opt_ms) / 1e3):.0f} tokens/s; 6 x params x tokens = "
        f"{flops / 1e12:.1f} TFLOP ({flops / PEAK_FLOPS['bfloat16'] * 1e3:.1f} ms at the bf16 "
        f"peak); peak allocated {before_gib:.2f} GiB before the step, {grad_peak:.2f} GiB "
        f"through the backward, {peak:.2f} GiB through AdamW")
    del params, grads, new, state, batch
    gc.collect()
    torch.cuda.empty_cache()


def _train_trainer(torch):
    """(c) HeddleTrainer at qwen3-1.7b full width (TRAINER_LAYERS of its
    layers), two paged workers on the card: two synchronous iterations, an
    update on records with a reward spread (the workers keep their tensors
    until the next rollout's sync), then three asynchronous updates.  The
    paged kernel's count is zeroed before and read after; kept live calls
    held to the plain version."""
    import gc
    from repro_torch.kernels import decode_attention as kernel
    from repro_torch.models import model as M
    from repro_torch.rl import data as D
    from repro_torch.rl.loop import HeddleTrainer, RolloutRecord, TrainerConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = _full_width(torch, TRAINER_LAYERS)
    tr = HeddleTrainer(cfg, TrainerConfig(seed=SEED), params=params, device="cuda")
    del params
    times = {}
    with _Capture(kernel, "paged_decode_attention", TRAIN_CAPTURE) as capture:
        _reset_launches()                                   # the path starts here
        hist, times["train(2)"] = sync_ms(torch, lambda: tr.train(2, tasks_per_iter=2))
        task = D.sample_tasks(1, seed=SEED)[0]
        p = task.prompt_tokens()
        records = [RolloutRecord(p + [D.TOOL_CALL, 20, D.EOS], 4, 1.0, 1),
                   RolloutRecord(p + [7, D.EOS], 4, 0.0, 1),
                   RolloutRecord(p + [D.TOOL_CALL, D.EOS], 4, 0.25, 1),
                   RolloutRecord(p + [11, 12, D.EOS], 4, 0.0, 1)]
        held = [list(M.tree_leaves(w.params)) for w in tr.workers]
        snap = [t.clone() for t in held[0]]
        pre = list(M.tree_leaves(tr.params))
        m, times["update"] = sync_ms(torch, lambda: tr.update(records))
        if m["pg_loss"] == 0:
            raise AssertionError(f"[train] trainer: no policy loss on a reward spread: {m}")
        for w, leaves in zip(tr.workers, held):
            now = list(M.tree_leaves(w.params))
            if any(a is not b for a, b in zip(now, leaves)):
                raise AssertionError("[train] trainer: a worker's tensors were replaced "
                                     "before the sync")
        if not all(torch.equal(a, b) for a, b in zip(held[0], snap)):
            raise AssertionError("[train] trainer: the update wrote into the workers' tensors")
        if all(torch.equal(a, b) for a, b in zip(M.tree_leaves(tr.params), pre)):
            raise AssertionError("[train] trainer: the update did not move the policy")
        del snap, held, pre
        async_hist, times["train_async(3)"] = sync_ms(torch, lambda: tr.train_async(
            n_updates=3, groups_per_update=2, max_staleness=2, backlog_groups=4))
        launches = _read_launches(torch)                    # the path ends
    if len(async_hist) != 3 or max(h["staleness"] for h in async_hist) > 2 or \
            [h["weight_epoch"] for h in async_hist[:-1]] != [1.0, 2.0]:
        raise AssertionError(f"[train] train_async: {async_hist}")
    for h in hist + [m] + async_hist:
        if not all(math.isfinite(v) for v in h.values()):
            raise AssertionError(f"[train] trainer: non-finite metrics {h}")
    n = launches["paged_decode_attention"]
    if n == 0 or launches["mamba_scan"] or launches["mamba_scan_bwd"] or \
            launches["decode_attention"]:
        raise AssertionError(f"[train] trainer: launches {launches}")
    steps = sum(w.decode_steps for w in tr.workers)
    log(f"[train] HeddleTrainer ({cfg.name} full width, {cfg.n_layers} layers, 2 paged "
        f"workers, group 4, "
        f"capacity 96): " + ", ".join(f"{k} {v / 1e3:.2f} s" for k, v in times.items())
        + f"; rewards {[h['mean_reward'] for h in hist]}, spread update pg_loss "
        f"{m['pg_loss']:+.4f}; async staleness {[h['staleness'] for h in async_hist]}, "
        f"epochs {[h.get('weight_epoch') for h in async_hist]}; decode steps {steps}; "
        f"paged_decode_attention launches {n}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("[train] the workers kept their tensors, bit for bit, through the update until "
        "the next rollout's sync")
    err = _hold_kept(torch, "train", capture.kept, TRAIN_CAPTURE)
    del tr, capture
    gc.collect()
    torch.cuda.empty_cache()
    return n, err


def _start_cli(arch="smollm-135m", iters=2, *extra):
    """(d), (f)(iii) the train CLI as a process of its own with no --device
    (on the card), started in the background; ``_finish_cli`` waits for it
    and checks it."""
    import os
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                             arch, "--iters", str(iters), *extra], cwd=ROOT, env=env,
                            stdout=out, stderr=err, text=True)
    return proc, out, err, (arch, iters, extra), time.perf_counter()


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _finish_cli(cli):
    proc, out, err, (arch, iters, extra), t0 = cli
    try:
        rc = proc.wait(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
    finally:
        _stop(proc)
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    out.close()
    err.close()
    lines = stdout.strip().splitlines()
    if rc != 0 or not any(" on cuda " in ln for ln in lines) or \
            not any(ln.startswith(f"iter {iters:4d}") and "nan" not in ln for ln in lines):
        raise AssertionError(f"[train] train CLI exited {rc}:\n"
                             f"{stdout[-2000:]}\n{stderr[-2000:]}")
    for ln in lines:
        log(f"[train] train CLI: {ln}")
    log(f"[train] train CLI (a process of its own, {arch} reduced to 2 periods, "
        f"f32{', ' + ' '.join(extra) if extra else ''}): exit 0 in "
        f"{time.perf_counter() - t0:.1f} s, run beside the other CLI, (e) and (f)(i)")


def _train_legacy(torch):
    """(e) the legacy per-sequence worker against the port's dense worker on
    the card (qwen3 reduced, 2 layers, f32; same prompts and keys): equal
    tokens through prefill, decode, extend and more decode.  The dense
    kernel's launches of the legacy worker alone are counted, and its kept
    live calls held to the plain version (the dense worker runs the same
    kernel, so equal tokens alone would not show a fault of it)."""
    from repro_torch.configs import get_config
    from repro_torch.engine.legacy import LegacyRolloutWorker
    from repro_torch.kernels import decode_attention as kernel
    from repro_torch.engine.sampler import SamplerConfig
    from repro_torch.engine.worker import RolloutWorker
    from repro_torch.models.model import init_params

    cfg = get_config("qwen3_1_7b").reduced(n_periods=2)
    params = init_params(cfg, seed=SEED, device="cuda")
    sampler = SamplerConfig(1.0, 0.9)
    legacy = LegacyRolloutWorker(cfg, params, capacity=128, sampler=sampler, seed=SEED,
                                 device="cuda")
    dense = RolloutWorker(cfg, params, capacity=128, max_slots=4, sampler=sampler, seed=SEED,
                          paged=False, device="cuda")
    prompts = {1: list(range(5, 45)), 2: list(range(7, 30)), 3: list(range(100, 160))}
    script = [("prefill", 1), ("prefill", 2), ("decode", [1, 2], 16), ("prefill", 3),
              ("decode", [1, 2, 3], 8), ("extend", 2, [300, 301, 302, 303]),
              ("decode", [2, 3], 12), ("decode", [1, 2, 3], 8)]
    runs = {}
    for tag, w in (("legacy", legacy), ("dense", dense)):
        with _Capture(kernel, "decode_attention", LEGACY_CAPTURE) as capture:
            _reset_launches()
            outs = []
            for op in script:
                if op[0] == "prefill":
                    w.prefill(op[1], prompts[op[1]])
                elif op[0] == "extend":
                    w.extend(op[1], op[2])
                else:
                    outs.append(w.decode(op[1], op[2]))
            runs[tag] = (outs, _read_launches(torch), capture.kept)
    if runs["legacy"][0] != runs["dense"][0]:
        raise AssertionError(f"[train] legacy tokens differ from the dense worker's:\n"
                             f"{runs['legacy'][0]}\n{runs['dense'][0]}")
    n = runs["legacy"][1]["decode_attention"]
    want = cfg.n_layers * (legacy.decode_steps + 4)         # a step a tool token
    if n != want:
        raise AssertionError(f"[train] legacy: decode_attention launched {n} times, "
                             f"want {want} ({legacy.decode_steps} steps + 4 tool tokens)")
    log(f"[train] legacy worker ({cfg.name} reduced, 2 layers, f32): tokens equal to the "
        f"dense worker's through prefill, decode, extend and decode "
        f"({sum(len(t) for o in runs['legacy'][0] for t in o.values())} tokens); "
        f"decode_attention launches {n} = 2 x ({legacy.decode_steps} steps + 4 tool tokens)")
    err = _hold_kept(torch, "legacy", runs["legacy"][2], LEGACY_CAPTURE)
    return n, err


def _jamba_grads_card_vs_cpu(torch):
    """(f)(i) jamba reduced (1 period, f32): the GRPO loss (remat on), its
    metrics and every gradient on the card (the scan's forward and backward
    kernels) against the CPU (their plain versions), from the same params and
    batch, within 1e-4 x max(1, max |CPU value|)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.rl import grpo as G
    cfg = get_config("jamba_v0_1_52b").reduced()
    params = M.init_params(cfg, seed=SEED, device="cpu")
    gen = torch.Generator().manual_seed(SEED + 1)
    tokens = torch.randint(5, cfg.vocab, (4, 40), generator=gen, dtype=torch.int32)
    batch = {"tokens": tokens, "loss_mask": (torch.arange(40) >= 4).float().expand(4, 40),
             "advantages": torch.tensor([1.0, -1.0, 0.5, -0.5]),
             "old_logprobs": -6.0 + 0.3 * torch.randn((4, 40), generator=gen)}
    res, launches = {}, {}
    t0 = time.perf_counter()
    for dev in ("cpu", "cuda"):
        _reset_launches()
        res[dev] = G.value_and_grad(
            lambda p: G.grpo_loss(cfg, G.GRPOConfig(group_size=2), p, M.tree_to(batch, dev)),
            M.tree_to(params, dev))
        launches[dev] = _read_launches(torch)
    (lc, mc, gc), (lg, mg, gg) = res["cpu"], res["cuda"]
    worst = abs(float(lg) - float(lc))
    if worst > 1e-4 * max(1.0, abs(float(lc))):
        raise AssertionError(f"[train] jamba reduced: loss {float(lg)} vs {float(lc)}")
    for k in mc:
        if abs(float(mg[k]) - float(mc[k])) > 1e-4 * max(1.0, abs(float(mc[k]))):
            raise AssertionError(f"[train] jamba reduced: {k} {mg[k]} vs {mc[k]}")
    leaves = list(zip(M.tree_leaves(gc), M.tree_leaves(gg)))
    rel = 0.0
    for c, g in leaves:
        g = g.cpu()
        scale = max(1.0, float(c.abs().max()))
        err = float((g - c).abs().max())
        if not bool(g.isfinite().all()) or err > 1e-4 * scale:
            raise AssertionError(f"[train] jamba reduced: a gradient {tuple(c.shape)} off by "
                                 f"{err} (scale {scale})")
        rel = max(rel, err / scale)
    n_mamba = cfg.n_periods * sum(k.startswith("mamba") for k in cfg.block_pattern)
    want = {"mamba_scan": 2 * n_mamba, "mamba_scan_bwd": n_mamba}   # forward, remat's re-run
    got = {k: launches["cuda"][k] for k in want}
    if got != want or any(launches["cpu"].values()):
        raise AssertionError(f"[train] jamba reduced: launches {launches}, want {want} on cuda")
    log(f"[train] jamba reduced (1 period, f32, B 4, S 40): GRPO loss {float(lg):+.6f} (CPU "
        f"{float(lc):+.6f}), {len(leaves)} gradient leaves card vs CPU within "
        f"{rel:.2e} of max(1, max|CPU|) (limit 1e-4); card launches {got}; "
        f"{time.perf_counter() - t0:.1f} s")


def _jamba_step(torch):
    """(f)(ii) the GRPO loss and gradients of one jamba period at its
    published widths (13.3 B params, bf16): B 1, S 2,048, remat on, advantage
    +1, old logprobs from the policy's own forward.  No AdamW: its f32
    moments alone take 106 GB.  Every gradient finite, every leaf reached;
    the scan kernels' launches counted from the old-policy forward on."""
    import gc
    from repro_torch.models import model as M
    from repro_torch.rl import grpo as G

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = _jamba_model(torch)
    n_mamba = cfg.n_periods * sum(k.startswith("mamba") for k in cfg.block_pattern)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, S = 1, 2048
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda",
                           dtype=torch.int32)
    mask = torch.zeros(B, S, device="cuda")
    mask[:, 64:S - 1] = 1.0
    batch = {"tokens": tokens, "loss_mask": mask,
             "advantages": torch.ones(B, device="cuda")}
    _reset_launches()                                       # the path starts here
    with torch.no_grad():
        (logits, _), old_ms = sync_ms(torch, lambda: M.forward_full(cfg, params,
                                                                    {"tokens": tokens}))
        batch["old_logprobs"] = G.token_logprobs(logits, tokens)
    del logits
    before_gib = torch.cuda.max_memory_allocated() / 2**30
    (loss, metrics, grads), grad_ms = sync_ms(torch, lambda: G.value_and_grad(
        lambda p: G.grpo_loss(cfg, G.GRPOConfig(group_size=1), p, batch), params))
    launches = _read_launches(torch)                        # the path ends
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"[train] jamba step: loss {float(loss)}")
    leaves = list(M.tree_leaves(grads))
    for g in leaves:
        if not bool(g.isfinite().all()):
            raise AssertionError("[train] jamba step: a non-finite gradient")
    dead = [tuple(g.shape) for g in leaves if not bool(g.ne(0).any())]
    if dead:
        raise AssertionError(f"[train] jamba step: leaves with a zero gradient {dead}")
    # the old-policy forward, the loss's forward, remat's re-run in the backward
    want = {"mamba_scan": 3 * n_mamba, "mamba_scan_bwd": n_mamba,
            "paged_decode_attention": 0, "decode_attention": 0}
    if launches != want:
        raise AssertionError(f"[train] jamba step: launches {launches}, want {want}")
    tokens_step = B * S
    flops = 6 * M.param_count(params) * tokens_step
    log(f"[train] jamba GRPO loss and gradients at its published widths ({cfg.name}, 1 period "
        f"of 4, {M.param_count(params) / 1e9:.3f} B params, bf16; B {B}, S {S}, remat on, "
        f"advantage +1): loss {float(loss):+.5f}, pg_loss {float(metrics['pg_loss']):+.5f}, "
        f"aux {float(metrics['aux_loss']):.4f}; {len(leaves)} leaves, every gradient finite "
        f"and nonzero; launches {launches} (mamba_scan = {n_mamba} x 3 forwards: the "
        f"old-policy forward, the loss's, remat's re-run; mamba_scan_bwd = {n_mamba})")
    log(f"[train] jamba step wall: loss and gradients {grad_ms:.1f} ms (old-policy forward "
        f"{old_ms:.1f} ms); {tokens_step / (grad_ms / 1e3):.0f} tokens/s; 6 x params x tokens "
        f"= {flops / 1e12:.1f} TFLOP ({flops / PEAK_FLOPS['bfloat16'] * 1e3:.1f} ms at the bf16 "
        f"peak); peak allocated {before_gib:.2f} GiB after the old-policy forward, "
        f"{peak:.2f} GiB through the backward (weights {_nbytes(params) / 1e9:.2f} GB, "
        f"gradients {_nbytes(grads) / 1e9:.2f} GB)")
    del params, grads, batch, loss
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train(torch, smi):
    """The training plane on the card: flash forward and backward at
    qwen3's layer shape, one GRPO step at full width, HeddleTrainer sync and
    async at full width, the train CLI, the legacy worker, and training
    through the Mamba mixer (jamba reduced card vs CPU, one full-width period's
    loss and gradients, the CLI on jamba)."""
    log(f"[train] {smi}")
    _train_flash(torch)
    _train_step(torch)
    launches, err = _train_trainer(torch)
    # the two CLI processes run beside (e) and (f)(i), which time nothing;
    # both end before (f)(ii), whose wall and peak are read
    clis = [_start_cli(),
            _start_cli("jamba-v0.1-52b", 1, "--tasks-per-iter", "1", "--group-size", "2")]
    try:
        legacy, legacy_err = _train_legacy(torch)
        _jamba_grads_card_vs_cpu(torch)
        for cli in clis:
            _finish_cli(cli)
    finally:
        for cli in clis:
            _stop(cli[0])
    jamba = _jamba_step(torch)
    return {"launches": launches, "max_abs_err": err, "legacy_launches": legacy,
            "legacy_max_abs_err": legacy_err, "jamba_launches": jamba}


# ---------------------------------------------------------------- phase 13
TP_STEPS = 32
# f32 logits of a sharded worker against its plane's degree-1 worker, x max(1,
# max |reference|): the shards' partial wo and MLP products are summed in
# shard order and the shard's smaller matrix products accumulate in another
# order (TF32 off): ~1e-7 relative at each of 56 sums into the residual
# stream, so ~1e-5 at the logits if every one added the same way
TP_TOL = 1e-4
TP_KERNELS = {True: "paged_decode_attention", False: "decode_attention"}


def _tp_worker(torch, cfg, params, d, paged, mesh=None):
    """A greedy worker of degree d, every shard on cuda:0 unless ``mesh``
    places them."""
    from repro_torch.engine.sampler import SamplerConfig
    from repro_torch.engine.worker import RolloutWorker
    from repro_torch.launch.mesh import WorkerMesh
    if mesh is None and d > 1:
        mesh = WorkerMesh((torch.device("cuda", 0),) * d)
    return RolloutWorker(cfg, params, capacity=2048, page_size=16, max_slots=8,
                         sampler=SamplerConfig(temperature=0.0), seed=SEED, mp=d, mesh=mesh,
                         device="cuda", paged=paged)


def _n_kind(cfg, mixer):
    """Layers of ``cfg`` whose mixer is ``mixer``."""
    return cfg.n_periods * sum(k.partition("+")[0] == mixer for k in cfg.block_pattern)


def _tp_drive(torch, cfg, w, prompts, tag, steps=TP_STEPS):
    """Admit one request a prompt, take one teacher-forced step on the
    admitted contexts (every lane masked, so no ``pos`` advances: a masked
    lane's logits are computed all the same, and its KV write lands where its
    first decode step writes the same token), then decode ``steps`` greedy
    steps.  The kernels' counts are zeroed before the admissions and read
    after them, and zeroed before the decode and read after it: a whole-
    prompt admission launches the scan d x (Mamba layers) times a prompt,
    a decode step the decode kernel d x (attention layers) times.  Returns
    (tokens, the lanes' logits on the host, the launches of both counts,
    ms per decode step, ms per admission)."""
    from repro_torch.models import model as M
    _reset_launches()                                       # main path starts here
    _, admit_ms = sync_ms(torch, lambda: [w.prefill(sid, p) for sid, p in enumerate(prompts)])
    launches = _read_launches(torch)
    last = torch.zeros((w.max_slots, 1), dtype=torch.long, device="cuda")
    slots = [w.store[sid].slot for sid in range(len(prompts))]
    for sid, slot in enumerate(slots):
        last[slot, 0] = w.store[sid].tokens[-1]
    logits, _ = M.decode_step(cfg, w.params, w.pool, last, mesh=w._tp,
                              active=torch.zeros(w.max_slots, dtype=torch.bool, device="cuda"))
    logits = logits[slots].float().cpu()
    if logits.shape != (len(prompts), cfg.vocab) or not bool(logits.isfinite().all()):
        raise AssertionError(f"[tp] {tag}: logits {tuple(logits.shape)}, finite="
                             f"{bool(logits.isfinite().all())}")
    _reset_launches()
    toks, ms = sync_ms(torch, lambda: w.decode(list(range(len(prompts))), steps))
    decode = _read_launches(torch)                          # main path ends
    launches = {k: launches[k] + decode[k] for k in launches}
    name = TP_KERNELS[w._paged]
    want = {name: w.mp * _n_kind(cfg, "attn") * steps,
            "mamba_scan": 0 if w._chunked else w.mp * _n_kind(cfg, "mamba") * len(prompts)}
    got = {"mamba_scan": launches["mamba_scan"], name: decode[name]}
    if got != want:
        raise AssertionError(f"[tp] {tag}: launches {got} (the decode kernel's in the "
                             f"{steps} decode steps), want {want}: d {w.mp} x layers x "
                             f"steps or admissions")
    return toks, logits, launches, ms / steps, admit_ms / len(prompts)


def _tp_against(toks, logits, ref):
    """(max |logit difference|, max |reference logit|, tokens equal) against
    ``ref``'s (tokens, logits); a lane's tokens count up to its first
    difference, since a greedy lane that once differs decodes another
    context from there on."""
    err = float((logits - ref[1]).abs().max())
    same = 0
    for sid, want in ref[0].items():
        for a, b in zip(toks[sid], want):
            if a != b:
                break
            same += 1
    return err, float(ref[1].abs().max()), same


def _tp_bytes(w):
    """GB a shard holds after placement: (params, pool) of each shard."""
    params = w.params if w._tp is not None else [w.params]
    pools = w.pool if w._tp is not None else [w.pool]
    return [(round(_nbytes(p) / 1e9, 3), round(_nbytes(c) / 1e9, 3))
            for p, c in zip(params, pools)]


def _tp_series(torch, cfg, params, prompts, degrees, launches, tag, paged=True, floor=None,
               floor_name="the f32 d1", keep=(), ref=None):
    """One worker a degree, each freed before the next is built (the
    degrees in ``keep`` are returned alive), driven by ``_tp_drive``; each
    sharded one held to the degree-1 worker: in f32 its tokens equal and its
    logits within TP_TOL x max(1, max |logit|); in bf16 logged.  The
    degree-1 worker is logged against ``floor`` (``floor_name``'s tokens
    and logits): the f32 d1 for a bf16 series (bf16's own error), or the
    other plane's d1.  Returns
    ({degree: worker} of ``keep``, the degree-1 (tokens, logits), {degree:
    a summary}).  ``ref``, a degree-1 (tokens, logits) from an earlier
    series, holds a series without degree 1."""
    kept, summary = {}, {}
    for d in degrees:
        w = _tp_worker(torch, cfg, params, d, paged)
        shards = _tp_bytes(w)
        toks, logits, counts, step_ms, admit_ms = _tp_drive(torch, cfg, w, prompts,
                                                           f"{tag} d{d}")
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        msg = (f"[tp] {tag} d{d}: a shard holds {shards[0][0]} GB of params and "
               f"{shards[0][1]} GB of pool ({len(shards)} shards); admission {admit_ms:.1f} "
               f"ms a prompt, decode {step_ms:.2f} ms a step ({len(prompts)} lanes, "
               f"{TP_STEPS} steps); launches {counts}")
        summary[d] = {"params_gb": shards[0][0], "pool_gb": shards[0][1],
                      "step_ms": step_ms, "admit_ms": admit_ms}
        if ref is None:
            ref = (toks, logits)
            if floor is not None:
                err, scale, same = _tp_against(toks, logits, floor)
                summary[d]["err_floor"] = err
                msg += (f"; against {floor_name}: logits max |err| {err:.3e} (max |ref| "
                        f"{scale:.3e}), {same}/{len(prompts) * TP_STEPS} tokens equal before "
                        f"a lane's first difference")
        else:
            err, scale, same = _tp_against(toks, logits, ref)
            scale = max(1.0, scale)
            summary[d]["err_d1"] = err
            msg += (f"; against d1: logits max |err| {err:.3e} (max |ref| {scale:.3e}), "
                    f"{same}/{len(prompts) * TP_STEPS} tokens equal before a lane's first "
                    f"difference")
            if cfg.dtype == "float32" and (err > TP_TOL * scale or toks != ref[0]):
                raise AssertionError(f"{msg}: tol {TP_TOL} x {scale:.3e}, tokens must be "
                                     f"equal")
        log(msg)
        if d in keep:
            kept[d] = w
        del w
        torch.cuda.empty_cache()
    return kept, ref, summary


def _tp_dtype(torch, cfg, params, groups, launches, floor=None):
    """Every worker of one dtype against its plane's degree-1 worker (in
    bf16 the paged workers at degree 1, 2 and 4 are kept for the
    migration).  ``floor``, the f32 paged d1's (tokens, logits), is bf16's
    own error: the bf16 paged d1 is logged against it, and the dense d1
    against the paged d1.  Returns (kept workers, the paged d1's tokens and
    logits)."""
    prompts = [groups[sid // 4] for sid in range(8)]
    keep = (1, 2, 4) if cfg.dtype == "bfloat16" else ()
    kept, paged_d1, _ = _tp_series(torch, cfg, params, prompts, (1, 2, 4), launches,
                                   f"{cfg.dtype} paged", floor=floor, keep=keep)
    _tp_series(torch, cfg, params, prompts, (1, 2), launches, f"{cfg.dtype} dense",
               paged=False, floor=paged_d1, floor_name="the paged d1")
    return kept, paged_d1


def _release(w):
    for sid in list(w.store):
        w.release(sid)


def _package(torch, pkg):
    from repro_torch.models.model import tree_leaves
    return [t.cpu() for t in tree_leaves({"pages": pkg["pages"], "state": pkg["state"]})]


def _hop(torch, pkg, dst, first, name):
    """Land ``pkg`` on ``dst`` and take it out again: the package out must
    be bit-equal to ``first``, the first package's tensors.  Returns it."""
    _release(dst)
    dst.migrate_in(pkg)
    pkg = dst.migrate_out(0)
    got = _package(torch, pkg)
    if len(got) != len(first) or not all(torch.equal(a, b) for a, b in zip(got, first)):
        raise AssertionError(f"[tp] the package out of {name} differs from the first")
    return pkg


def _tp_migrate(torch, kept):
    """One lane d2 -> d1 -> d4 -> d2: every package bit-equal to the first."""
    pkg = kept[2].migrate_out(0)
    first = _package(torch, pkg)
    for d in (1, 4, 2):
        pkg = _hop(torch, pkg, kept[d], first, f"d{d}")
    kept[2].migrate_in(pkg)
    toks = kept[2].decode([0], 4)[0]
    log(f"[tp] a lane of {len(pkg['tokens'])} tokens moved d2 -> d1 -> d4 -> d2: "
        f"{sum(t.numel() for t in first)} values of pages and state bit-equal at every hop; "
        f"it decodes on ({toks})")


def phase_tp(torch, smi):
    import numpy as np
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, tree_map
    cfg = get_config("qwen3_1_7b")
    rng = np.random.default_rng(SEED)
    groups = [rng.integers(0, cfg.vocab, n).tolist() for n in (300, 257)]
    log(f"[tp] {smi}: every shard of every worker on this one card (cuda:0 x d)")
    launches = {}
    f32 = replace(cfg, dtype="float32")
    params = init_params(f32, seed=SEED, device="cuda")
    _, f32_d1 = _tp_dtype(torch, f32, params, groups, launches)
    params = tree_map(lambda t: t.to(torch.bfloat16), params)   # the same weights, rounded
    torch.cuda.empty_cache()
    kept, _ = _tp_dtype(torch, cfg, params, groups, launches, floor=f32_d1)
    _tp_migrate(torch, kept)
    del kept, params
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {"paged_decode_attention": {}, "decode_attention": {}}
    for KV in (4, 2):
        rows["paged_decode_attention"][f"kv{KV}"] = _paged_row(
            torch, gen, f"paged_decode_attention tp-kv{KV}", "bfloat16", 28, 8, KV, 2, 128,
            ps=16, num_pages=128, max_len=2048)
    vl = torch.randint(1, 2049, (8,), generator=gen, device="cuda", dtype=torch.int32)
    rows["decode_attention"]["kv4"] = _dense_row(torch, gen, "decode_attention tp-kv4",
                                                 "bfloat16", 28, 8, 2048, 4, 2, 128, vl)
    return {"launches": launches, "rows": rows}


# ---------------------------------------------------------------- phase 14
TP_JAMBA_PROMPTS = (1024, 700)      # two groups of 4, admitted by whole-prompt forward
TP_WINDOW = 2048                    # qwen3's ring, cut from 8,192; one prompt wraps it
TP_RING_PROMPT = 2500
TP_MOE_LAYERS = 4                   # qwen2-moe cut from 24 layers


def _tp_model(torch, name, dtype, tag="tp-mixers", **cut):
    """``name`` at its published widths with ``cut`` (periods, layers, a
    window) in ``dtype``, weights from the seed on the card."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, param_count
    cfg = replace(get_config(name), dtype=dtype, **cut)
    params, ms = sync_ms(torch, lambda: init_params(cfg, seed=SEED, device="cuda"))
    log(f"[{tag}] {cfg.name} {dtype}, {cut}: {cfg.n_layers} layers "
        f"({' '.join(cfg.block_pattern)}), {param_count(params) / 1e9:.3f} B params, "
        f"{_nbytes(params) / 1e9:.2f} GB (init {ms:.0f} ms)")
    return cfg, params


F32_LEAVES = ("router", "m_Alog", "m_D")   # kept in f32 when the model is rounded to bf16


def _to_bf16(torch, tree):
    """Round every floating leaf of ``tree`` to bf16 in place, leaf by leaf,
    so that the f32 copy of one leaf at most lives beside the bf16 tree (the
    router, A_log and D stay f32, as the model keeps them)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _to_bf16(torch, v)
        elif v.dtype == torch.float32 and k not in F32_LEAVES:
            tree[k] = v.to(torch.bfloat16)
            del v
    torch.cuda.empty_cache()


def _tp_scan_rows(torch, gen):
    """The scan kernel at the shards' channel counts of a jamba Mamba layer
    (di 4,096 at MP 2, 2,048 at MP 4; B 1, S 2,048, N 16), bf16 and f32
    x/B/C: held to its plain version and timed as phase 3's rows, with the
    blocks its grid gets (32 channels a block)."""
    from repro_torch.kernels import mamba_scan as scan_kernel
    from repro_torch.kernels import ref
    B, S, N = 1, 2048, 16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for di in (4096, 2048):
        for name in ("bfloat16", "float32"):
            args = _scan_inputs(torch, gen, B, S, name, di)
            got = scan_kernel.mamba_scan(*args)
            torch.cuda.synchronize()
            want = ref.mamba_scan_ref(*args)
            err = 0.0
            for part, g, w in zip(("y", "h_S"), got, want):
                limit = SCAN_TOL * max(1.0, float(w.abs().max()))
                e = float((g - w).abs().max())
                _check_err(f"mamba_scan tp-di{di} {part}", name, [g], e, limit)
                err = max(err, e)
            bound, bound_by, nbytes, times = _scan_bound(B, S, di, N, args[1].element_size())
            ms = event_ms(torch, lambda i: scan_kernel.mamba_scan(*args), 20)[0]
            plain_ms = event_ms(torch, lambda i: ref.mamba_scan_ref(*args), 2, n_warm=1,
                                hold=False)[0]
            rows.setdefault(f"di{di}", {})[name] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": bound, "bound_by": bound_by}
            plan = scan_kernel._scan_plan(S, di, N, args[1].element_size(),
                                          [t.data_ptr() for t in (*args[:4], got[0])])
            log(f"[kernels] mamba_scan tp-di{di} {name}: B={B} S={S} di={di} N={N}, "
                f"{-(-di // 32) * B} blocks on {sms} SMs; max|err| {err:.3e}; kernel "
                f"{ms:.4f} ms ({bound / ms:.1%} of the bound), plain {plain_ms:.2f} ms; bound "
                f"{bound:.4f} ms ({bound_by}: bytes {nbytes / 1e6:.1f} MB {times['bytes']:.4f} "
                f"ms, exp {times['exp']:.4f} ms); copy widths "
                + ", ".join(f"{k} {plan[k]}" for k in scan_kernel.PLAN_KEYS))
            del args, got, want
    torch.cuda.empty_cache()
    return rows


class _MoeRoutes:
    """While a run lasts, records every ``models.layers.moe`` call's top-k
    expert ids (sorted per token) on the host before it computes as
    before.  A degree-d worker calls it once a shard a layer, so its calls
    alternate shards."""

    def __init__(self, torch, d):
        self.torch, self.d, self.calls = torch, d, []

    def __enter__(self):
        from repro_torch.models import layers
        self.layers, self.moe = layers, layers.moe
        torch, calls = self.torch, self.calls

        def recorded(p, x, cfg, *args, **kw):
            xf = x.reshape(-1, x.shape[-1])
            gates = torch.softmax((xf.to(p["router"].dtype) @ p["router"]).float(), dim=-1)
            calls.append(torch.topk(gates, cfg.top_k, dim=-1).indices.sort(-1).values.cpu())
            return self.moe(p, x, cfg, *args, **kw)

        layers.moe = recorded
        return self

    def __exit__(self, *exc):
        self.layers.moe = self.moe

    def shard(self, r):
        if len(self.calls) % self.d:
            raise AssertionError(f"[tp-mixers] d{self.d}: {len(self.calls)} MoE calls, "
                                 f"not a multiple of {self.d}")
        return self.calls[r::self.d]


def _flips(a, b):
    """(tokens, tokens whose top-k set differs, (token, choice) pairs, pairs
    that differ) over two lists of per-call top-k ids; a pair differs when
    its expert is not among the other side's choices for that token."""
    tokens = diff_tok = pairs = diff_pairs = 0
    for x, y in zip(a, b, strict=True):
        if x.shape != y.shape:
            raise AssertionError(f"[tp-mixers] MoE calls of shapes {tuple(x.shape)}, "
                                 f"{tuple(y.shape)}")
        tokens += x.shape[0]
        pairs += x.numel()
        diff_tok += int((x != y).any(-1).sum())
        diff_pairs += int((~(x[:, :, None] == y[:, None, :]).any(-1)).sum())
    return {"tokens": tokens, "tokens_flipped": diff_tok, "choices": pairs,
            "choices_flipped": diff_pairs}


def _log_flips(cfg, n_prompts, d1, d2, names=("d1", "d2"), tag="tp-mixers"):
    """jamba's bf16 top-k choices of ``d1``'s first shard against ``d2``'s,
    by part of the run (admissions, the teacher-forced step, decode), and
    ``d2``'s first two shards against each other."""
    n_moe = cfg.n_periods * sum(k.endswith("+moe") for k in cfg.block_pattern)
    one, (a, b) = d1.shard(0), (d2.shard(0), d2.shard(1))
    admit = n_moe * n_prompts
    parts = {"admissions": slice(0, admit), "teacher-forced": slice(admit, admit + n_moe),
             "decode": slice(admit + n_moe, None)}
    flips = {k: _flips(one[sl], a[sl]) for k, sl in parts.items()}
    shards = f"{names[1]} shards"
    flips[shards] = _flips(a, b)
    for k, v in flips.items():
        pair = "shard 0 against shard 1" if k == shards else " against ".join(names)
        log(f"[{tag}] jamba bf16 MoE routing, {k}: {v['tokens_flipped']}/{v['tokens']} "
            f"tokens with another top-{cfg.top_k} set, {v['choices_flipped']}/{v['choices']} "
            f"choices differ ({pair})")
    return flips


def phase_tp_mixers(torch, smi):
    """Tensor-parallel workers of the hybrid, MoE and ring configs, every
    shard on this one card: (a) jamba at its published widths, one period
    (bf16 at degree 1, 2, 4 with a lane moved d2 -> d1 -> d4 -> d2; f32 on
    the period's first four layers; the f32 d1 of the whole period as
    bf16's own error), (b) qwen2-moe cut to 4 layers in f32, (c) qwen3 with
    a 2,048-token window in f32, (d) the kernels at the shards' shapes.
    Returns the launches of the three kernels and the rows."""
    from dataclasses import replace

    import numpy as np
    log(f"[tp-mixers] {smi}: every shard of every worker on this one card (cuda:0 x d)")
    launches = {}
    summary = {}
    rng = np.random.default_rng(SEED + 14)
    # (a) jamba, f32 on the first four layers: d2 and d4 held to d1
    cfg, params = _tp_model(torch, "jamba_v0_1_52b", "float32", n_periods=1,
                            block_pattern=("mamba+mlp", "mamba+moe", "mamba+mlp", "attn+moe"))
    groups = [rng.integers(0, cfg.vocab, n).tolist() for n in TP_JAMBA_PROMPTS]
    prompts = [groups[sid // 4] for sid in range(8)]
    _, _, summary["jamba-4-f32"] = _tp_series(torch, cfg, params, prompts, (1, 2, 4),
                                              launches, "jamba 4 layers f32")
    del params
    torch.cuda.empty_cache()
    # (a) jamba, one period: the f32 d1, then the same weights rounded to
    # bf16 at d1, d2 and d4, a lane moved d2 -> d1 -> d4 -> d2 between them
    # (three copies of the weights do not fit: d2 is freed before d4 is built)
    cfg, params = _tp_model(torch, "jamba_v0_1_52b", "float32", n_periods=1)
    _, f32_d1, summary["jamba-f32"] = _tp_series(torch, cfg, params, prompts, (1,), launches,
                                                 "jamba f32")
    _to_bf16(torch, params)
    cfg = replace(cfg, dtype="bfloat16")
    with _MoeRoutes(torch, 1) as routes1:
        kept, d1, summary["jamba-bf16"] = _tp_series(torch, cfg, params, prompts, (1,),
                                                     launches, "jamba bf16", floor=f32_d1,
                                                     keep=(1,))
    with _MoeRoutes(torch, 2) as routes2:
        more = _tp_series(torch, cfg, params, prompts, (2,), launches, "jamba bf16",
                          keep=(2,), ref=d1)
    kept.update(more[0])
    summary["jamba-bf16"].update(more[2])
    summary["jamba-bf16-moe-flips"] = _log_flips(cfg, len(prompts), routes1, routes2)
    del routes1, routes2
    pkg = kept[2].migrate_out(0)
    first = _package(torch, pkg)
    del kept[2]
    torch.cuda.empty_cache()
    pkg = _hop(torch, pkg, kept[1], first, "d1")
    w4, _, more = _tp_series(torch, cfg, params, prompts, (4,), launches, "jamba bf16",
                             keep=(4,), ref=d1)
    summary["jamba-bf16"].update(more)
    pkg = _hop(torch, pkg, w4.pop(4), first, "d4")
    del kept
    w2 = _tp_worker(torch, cfg, params, 2, True)
    pkg = _hop(torch, pkg, w2, first, "d2")
    w2.migrate_in(pkg)
    toks = w2.decode([0], 4)[0]
    log(f"[tp-mixers] jamba bf16: a lane of {len(pkg['tokens'])} tokens moved d2 -> d1 -> d4 "
        f"-> d2: {sum(t.numel() for t in first)} values of pages, Mamba state and pos "
        f"bit-equal at every hop; it decodes on ({toks})")
    del w2, pkg, params
    torch.cuda.empty_cache()
    # (b) qwen2-moe, 4 of 24 layers, f32: 60 experts over 2 and 4 shards
    cfg, params = _tp_model(torch, "qwen2_moe_a2_7b", "float32", n_periods=TP_MOE_LAYERS)
    groups = [rng.integers(0, cfg.vocab, n).tolist() for n in (300, 257)]
    _, _, summary["qwen2-moe-f32"] = _tp_series(
        torch, cfg, params, [groups[sid // 4] for sid in range(8)], (1, 2, 4), launches,
        "qwen2-moe 4 layers f32")
    del params
    torch.cuda.empty_cache()
    # (c) qwen3 with a 2,048-token window, f32: one 2,500-token prompt wraps the ring
    cfg, params = _tp_model(torch, "qwen3_1_7b", "float32", sliding_window=TP_WINDOW)
    _, _, summary["qwen3-ring-f32"] = _tp_series(
        torch, cfg, params, [rng.integers(0, cfg.vocab, TP_RING_PROMPT).tolist()], (1, 2),
        launches, "qwen3 ring f32", paged=False)
    del params
    torch.cuda.empty_cache()
    # (d) the kernels at the shards' shapes
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {"mamba_scan": _tp_scan_rows(torch, gen), "paged_decode_attention": {}}
    for KV in (4, 2):
        rows["paged_decode_attention"][f"jamba-kv{KV}"] = _paged_row(
            torch, gen, f"paged_decode_attention tp-jamba-kv{KV}", "bfloat16", 8, 8, KV, 4, 128,
            ps=16, num_pages=128, max_len=2048)
    log(f"[tp-mixers] summary {json.dumps(summary)}")
    return {"launches": launches, "rows": rows}


# ---------------------------------------------------------------- phase 15
TP_XLSTM_PROMPTS = (16, 12)         # two groups of 4, admitted one step a token
TP_CROSS_STEPS = 32
# bf16 at degree d against the bf16 d1: each stands bf16's own error from the
# f32 d1 (the bf16 d1's distance from it), so two of them at most twice that
TP_BF16_SPREAD = 2.0


def _hold_bf16_spread(name, bf16, degrees):
    """Each bf16 degree in ``degrees`` no farther from the bf16 d1 than
    TP_BF16_SPREAD x the bf16 d1's distance from the f32 d1 (``bf16``: a
    series' {degree: summary}); the ratios are logged."""
    own = bf16[1]["err_floor"]
    for d in degrees:
        ratio = bf16[d]["err_d1"] / own
        log(f"[tp-cross] {name} bf16 d{d}: {bf16[d]['err_d1']:.3e} from the bf16 d1, "
            f"{ratio:.3f} x the bf16 d1's {own:.3e} from the f32 d1 (at most {TP_BF16_SPREAD})")
        if not bf16[d]["err_d1"] <= TP_BF16_SPREAD * own:
            raise AssertionError(f"[tp-cross] {name} bf16 d{d}: logits {bf16[d]['err_d1']:.3e} "
                                 f"from the bf16 d1, more than {TP_BF16_SPREAD} x the bf16 "
                                 f"d1's {own:.3e} from the f32 d1")


def _tp_xlstm(torch, launches, summary):
    """(a) xlstm-350m at full width, paged pure-state workers at degree 1, 2
    and 4: f32, then the same weights rounded to bf16, a lane moved d2 ->
    d1 -> d4 -> d2 in bf16; no kernel of the repo may launch."""
    from dataclasses import replace

    import numpy as np
    from repro_torch.models.model import tree_map
    rng = np.random.default_rng(SEED + 15)
    cfg, params = _tp_model(torch, "xlstm_350m", "float32", tag="tp-cross")
    groups = [rng.integers(0, cfg.vocab, n).tolist() for n in TP_XLSTM_PROMPTS]
    prompts = [groups[sid // 4] for sid in range(8)]
    counts = {}
    _, f32_d1, summary["xlstm-f32"] = _tp_series(torch, cfg, params, prompts, (1, 2, 4),
                                                 counts, "xlstm f32")
    params = tree_map(lambda t: t.to(torch.bfloat16), params)   # the same weights, rounded
    cfg = replace(cfg, dtype="bfloat16")
    torch.cuda.empty_cache()
    kept, _, bf16 = _tp_series(torch, cfg, params, prompts, (1, 2, 4), counts, "xlstm bf16",
                               floor=f32_d1, keep=(1, 2, 4))
    summary["xlstm-bf16"] = bf16
    _hold_bf16_spread("xlstm", bf16, (2, 4))
    for d, w in kept.items():
        lane = _nbytes(w.pool[0]["blocks"] if w._tp is not None else w.pool["blocks"])
        log(f"[tp-cross] xlstm bf16 d{d}: a lane's state {lane / w.max_slots / 1e6:.2f} MB "
            f"a shard, params {_tp_bytes(w)[0][0]} GB a shard")
    _tp_migrate(torch, kept)
    if any(counts.values()):
        raise AssertionError(f"[tp-cross] xlstm launched a repo kernel: {counts}")
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n
    del kept, params
    torch.cuda.empty_cache()


def _tp_cross_run(torch, cfg, params, batch, d, capacity, tag):
    """One model-API run at MP degree d, every shard on the card:
    ``forward_full(mesh=)`` over the batch's embeddings at ``capacity``, then
    TP_CROSS_STEPS greedy decode steps.  The counts are zeroed before the
    admission and read after the decode: the dense kernel's must be d x
    (self- + cross-attention layers) x steps, and no other kernel may
    launch.  A few live cross-attention calls (the last among them) are
    kept and held to the plain version at the shard's shape.  Returns
    (tokens, logits (1 + steps, B, V) on the host: the admission's last
    position, then each step's, walls, launches, the
    largest error of the kept calls).  The tokens are (1 + steps, B): the
    admission's, then each step's."""
    from repro_torch.distributed.sharding import shard_params, tp_split
    from repro_torch.kernels import decode_attention as kernel
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.models import model as M
    mesh = None if d == 1 else WorkerMesh((torch.device("cuda", 0),) * d)
    shards = params if mesh is None else shard_params(params, tp_split(cfg, d), mesh)
    T = cfg.encoder_seq or cfg.image_seq
    n_self, n_cross = _decode_calls(cfg)
    _reset_launches()                                       # the path starts here
    (logits, _, cache), admit_ms = sync_ms(
        torch, lambda: M.forward_full(cfg, shards, batch, capacity=capacity, mesh=mesh))
    out = [logits[:, -1].clone()]
    del logits
    toks = [out[0].argmax(-1)]

    def decode():
        for _ in range(TP_CROSS_STEPS):
            lg, _ = M.decode_step(cfg, shards, cache, toks[-1][:, None], mesh=mesh)
            toks.append(lg.argmax(-1))
            out.append(lg)

    with _Capture(kernel, "decode_attention", max(1, d * n_cross * TP_CROSS_STEPS // 4),
                  keep=lambda a: a[1].shape[1] == T) as cross:
        _, decode_ms = sync_ms(torch, decode)
    launches = _read_launches(torch)                        # the path ends
    _check_launches(f"tp-cross {tag}", launches,
                    {"decode_attention": d * (n_self + n_cross) * TP_CROSS_STEPS})
    logits = torch.stack([o.float() for o in out]).cpu()
    if not bool(logits.isfinite().all()):
        raise AssertionError(f"[tp-cross] {tag}: non-finite logits")
    kv = cross.kept[-1][1].shape[2] if cross.kept else None
    want_kv = cfg.n_kv_heads // d if d > 1 else cfg.n_kv_heads
    if kv != want_kv:
        raise AssertionError(f"[tp-cross] {tag}: kept cross calls at KV {kv}, want {want_kv}")
    err = _hold_kept(torch, f"tp-cross {tag} cross-attention", cross.kept, cross.every)
    times = {"admit_ms": admit_ms, "step_ms": decode_ms / TP_CROSS_STEPS}
    del cache, shards, cross
    torch.cuda.empty_cache()
    return torch.stack(toks).cpu(), logits, times, launches, err


def _tp_cross_against(torch, toks, logits, ref):
    """(max |logit difference| over the steps whose inputs are equal, max
    |reference logit| there, those steps, tokens equal before a lane's first
    difference) against ``ref``'s (tokens, logits)."""
    same_steps = 0
    while same_steps < toks.shape[0] and torch.equal(toks[same_steps], ref[0][same_steps]):
        same_steps += 1
    n = same_steps + 1                   # the admission's logits, then the equal steps'
    err = float((logits[:n] - ref[1][:n]).abs().max())
    lanes = (toks != ref[0]).int().cumsum(0) == 0
    return err, float(ref[1][:n].abs().max()), same_steps, int(lanes.sum())


def _tp_cross_series(torch, cfg, params, batch, degrees, capacity, tag, launches,
                     floor=None):
    """``_tp_cross_run`` at each degree, the sharded runs held to the
    degree-1 run: in f32 every token equal and the logits within TP_TOL x
    max(1, max |logit|), in bf16 logged; the degree-1 run logged against
    ``floor`` (the f32 d1's tokens and logits).  Returns (the d1's tokens and
    logits, {degree: a summary})."""
    ref, summary, errs = None, {}, []
    for d in degrees:
        toks, logits, times, counts, held = _tp_cross_run(torch, cfg, params, batch, d,
                                                          capacity, f"{tag} d{d}")
        errs.append(held)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        summary[d] = dict(times)
        msg = (f"[tp-cross] {tag} d{d}: admission {times['admit_ms']:.1f} ms ({batch['tokens'].shape[0]} "
               f"requests), decode {times['step_ms']:.2f} ms a step ({TP_CROSS_STEPS} steps); "
               f"decode_attention launches {counts['decode_attention']}")
        against = ("the f32 d1", floor) if ref is None else ("d1", ref)
        if against[1] is not None:
            err, scale, steps, same = _tp_cross_against(torch, toks, logits, against[1])
            summary[d]["err_" + ("floor" if ref is None else "d1")] = err
            msg += (f"; against {against[0]}: logits max |err| {err:.3e} over the admission "
                    f"and {steps} equal steps (max |ref| {scale:.3e}), {same}/{toks.numel()} "
                    f"tokens equal before a lane's first difference")
            if ref is not None and cfg.dtype == "float32" and (
                    err > TP_TOL * max(1.0, scale) or not torch.equal(toks, ref[0])):
                raise AssertionError(f"{msg}: tol {TP_TOL} x max(1, {scale:.3e}), tokens "
                                     f"must be equal")
        log(msg)
        if ref is None:
            ref = (toks, logits)
    return ref, summary, max(errs)


def _tp_cross_model(torch, name, dtype, **cut):
    """A phase-11 model at its published widths (``cut`` its depth) in
    ``dtype``, gates open, and its batch: 8 requests of ``ENCODER_PATHS``'s
    prompt length over embeddings drawn from the seed.  Returns (config,
    params, batch, capacity)."""
    cfg, params = _tp_model(torch, name, dtype, tag="tp-cross", **cut)
    _open_gates(params)
    prompt, capacity = {n: (p, c) for n, p, c in ENCODER_PATHS}[name]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return cfg, params, _cross_batch(torch, cfg, ENC_LANES, prompt, gen, "cuda"), capacity


def phase_tp_cross(torch, smi):
    """The xLSTM and cross-attention splits, every shard on this one card:
    (a) xlstm-350m at full width (``_tp_xlstm``); (b) whisper-medium at full
    width through the model API, f32 then bf16 (the same weights rounded) at
    degree 1, 2 and 4; (c) llama-3.2-vision-11b at full width in f32 at
    degree 1, then the same weights rounded to bf16 at degree 1 and 2 (the
    d2 held to twice the bf16 d1's distance from the f32 d1), and its first
    period (4 self- and the one cross-attention layer) in f32 at 1, 2 and
    4.  Returns the launches, the largest error of the kept live
    cross-attention calls, and the peak memory."""
    from dataclasses import replace

    from repro_torch.models.model import tree_map
    log(f"[tp-cross] {smi}: every shard of every worker on this one card (cuda:0 x d)")
    torch.cuda.reset_peak_memory_stats()
    launches, summary, errs = {}, {}, []
    _tp_xlstm(torch, launches, summary)
    # (b) whisper, f32 then bf16
    cfg, params, batch, capacity = _tp_cross_model(torch, "whisper_medium", "float32")
    f32_d1, summary["whisper-f32"], err = _tp_cross_series(
        torch, cfg, params, batch, (1, 2, 4), capacity, "whisper f32", launches)
    errs.append(err)
    params = tree_map(lambda t: t.to(torch.bfloat16), params)
    cfg = replace(cfg, dtype="bfloat16")
    batch = {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in batch.items()}
    torch.cuda.empty_cache()
    _, summary["whisper-bf16"], err = _tp_cross_series(
        torch, cfg, params, batch, (1, 2, 4), capacity, "whisper bf16", launches, floor=f32_d1)
    errs.append(err)
    _hold_bf16_spread("whisper", summary["whisper-bf16"], (2, 4))
    del params, batch
    torch.cuda.empty_cache()
    # (c) the VLM at full width: the f32 d1 alone (its f32 weights and their
    # d2 shards do not fit together), then the same weights rounded to bf16
    # in place at d1 and d2, the d2 held to twice the bf16 d1's distance from
    # the f32 d1; f32 at 1, 2 and 4 on its first period
    cfg, params, batch, capacity = _tp_cross_model(torch, "llama_3_2_vision_11b", "float32")
    f32_d1, summary["vlm-f32"], err = _tp_cross_series(
        torch, cfg, params, batch, (1,), capacity, "vlm f32", launches)
    errs.append(err)
    _to_bf16(torch, params)
    cfg = replace(cfg, dtype="bfloat16")
    batch = {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in batch.items()}
    _, bf16, err = _tp_cross_series(torch, cfg, params, batch, (1, 2), capacity, "vlm bf16",
                                    launches, floor=f32_d1)
    summary["vlm-bf16"] = bf16
    errs.append(err)
    _hold_bf16_spread("vlm", bf16, (2,))
    del params, batch, f32_d1
    torch.cuda.empty_cache()
    cfg, params, batch, capacity = _tp_cross_model(torch, "llama_3_2_vision_11b", "float32",
                                                   n_periods=1)
    _, summary["vlm-f32-period"], err = _tp_cross_series(
        torch, cfg, params, batch, (1, 2, 4), capacity, "vlm f32 first period", launches)
    errs.append(err)
    del params, batch
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[tp-cross] peak allocated {peak:.2f} GiB")
    log(f"[tp-cross] summary {json.dumps(summary)}")
    return {"launches": launches, "max_abs_err": max(errs), "peak_gib": peak}


# ---------------------------------------------------------------- phase 16
# (example, its arguments, keep every n-th paged-kernel call: about 4 a run)
EXAMPLE_RUNS = (("quickstart", ["--prompts", "12"], 3),  # control plane cut from 48 prompts
                ("serve_rollout", [], 12),
                ("train_agentic_grpo", ["--iters", "2"], 376))


def _example(name):
    """``examples/torch_<name>.py`` imported as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                  ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(torch, smi):
    """The port's linter over the port and its examples, then three
    examples in this process on the card (no --device), each one's paged
    kernel launches held to its layers x decode steps and its kept live
    calls to the plain version.  Returns {"launches": {example: launches},
    "max_abs_err": the largest kept call's error}."""
    from repro_torch.analysis.lint import lint_paths
    from repro_torch.kernels import decode_attention as kernel
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    if len(examples) != 4:
        raise AssertionError(f"[examples] want 4 examples/torch_*.py, found {examples}")
    t0 = time.perf_counter()
    violations = lint_paths([str(SRC / "repro_torch"), *map(str, examples)])
    log(f"[examples] heddle-lint over src/repro_torch and {len(examples)} examples: "
        f"{len(violations)} violations ({time.perf_counter() - t0:.2f} s)")
    if violations:
        raise AssertionError("[examples] lint: " + "; ".join(v.render() for v in violations))
    log(f"[examples] {smi}: in process, on the card by default")
    launches, errs = {}, []
    for name, argv, every in EXAMPLE_RUNS:
        mod = _example(name)
        with _Capture(kernel, "paged_decode_attention", every) as capture:
            _reset_launches()                               # the path starts here
            out, ms = sync_ms(torch, lambda: mod.main(argv))
            counts = _read_launches(torch)                  # the path ends
        run = out.get("engine", out)
        if not run["device"].startswith("cuda"):
            raise AssertionError(f"[examples] {name} ran on {run['device']}, not the card")
        _check_launches(f"examples {name}", counts, {
            "paged_decode_attention": run["n_layers"] * run["decode_steps"]})
        launches[name] = counts["paged_decode_attention"]
        log(f"[examples] {name} {' '.join(argv)}: {ms / 1e3:.1f} s, paged_decode_attention "
            f"launches {launches[name]} = {run['n_layers']} layers x {run['decode_steps']} "
            f"decode steps")
        errs.append(_hold_kept(torch, f"examples {name}", capture.kept, every))
    return {"launches": launches, "max_abs_err": max(errs)}


# ---------------------------------------------------------------- phase 17
# phase 17 is cut to fit the script's 1,200 s on four cards, where phases 1-16
# took 1,063 s (on a four-card H100 host, before phases 9, 10, 12 and 15 were
# cut): 4 of phase 13's and 14's 8 requests (2 of each group), 8 of their 32
# greedy steps, and 3 of phase 9's 6 prompts
CARDS_REQUESTS = (0, 0, 1, 1)       # the group of each request
CARDS_STEPS = 8
CARDS_RUNTIME_PROMPTS = 3
CARDS_CAPTURE_EVERY = 1_000         # keep every 1,000th decode-kernel call of the runtime run
CARDS_PROFILE_STEPS = 8             # decode steps profiled for each card's busy share
CARDS_HOPS = 4                      # one lane moved card to card, then through the host
CARDS_RECONF_STEPS = 8              # decode steps before, between and after the reconfigures
CARDS_SPIN_CYCLES = 200_000_000    # ~0.1 s of a card's stream held before a first launch


def _cards_mesh(torch, first, d):
    """A mesh of ``d`` distinct cards from ``cuda:first`` on."""
    from repro_torch.launch.mesh import WorkerMesh
    return WorkerMesh(tuple(torch.device("cuda", first + r) for r in range(d)))


class _PerCard:
    """While a run lasts, counts a kernel wrapper's calls by the card of its
    first input (a call on a CUDA tensor is one launch) and keeps copies of
    the inputs of the first ``keep`` calls on each card other than cuda:0.
    The wrapper is called as before and counts its own launches."""

    def __init__(self, module, name, keep=2):
        self.module, self.name, self.keep = module, name, keep
        self.counts, self.kept = {}, {}

    def __enter__(self):
        self.launch = getattr(self.module, self.name)

        def counted(*args):
            card = args[0].device.index
            self.counts[card] = self.counts.get(card, 0) + 1
            if card and len(self.kept.setdefault(card, [])) < self.keep:
                self.kept[card].append([a.clone() for a in args])
            return self.launch(*args)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.launch)

    def take(self):
        """The counts so far by card, then zeroed."""
        counts, self.counts = self.counts, {}
        return counts


def _per_card(tag, counts, cards, want):
    """Each of ``cards`` launched a kernel exactly ``want`` times, no other card."""
    if counts != {c: want for c in cards}:
        raise AssertionError(f"[cards] {tag}: launches by card {counts}, want {want} on each "
                             f"of {list(cards)}")


def _busy_by_card(torch, fn):
    """(wall ms, {card: device-busy ms}) of ``fn`` under torch.profiler: the
    kernels' and copies' device time on each card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync_all(torch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = sync_ms(torch, fn)
    busy = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            busy[e.device_index()] = busy.get(e.device_index(), 0.0) + e.duration_ns() / 1e6
    return wall, dict(sorted(busy.items()))


# ATen ops that read a count or a verdict back from the card and return no
# CPU tensor; ``is_nonzero`` reaches ``_local_scalar_dense`` itself
HOST_SYNCS = {"aten::nonzero", "aten::equal", "aten::masked_select", "aten::is_nonzero",
              "aten::_unique", "aten::_unique2", "aten::unique_dim",
              "aten::unique_consecutive", "aten::unique_dim_consecutive"}


def _host_copies(torch, *fns):
    """The copies from a card to the host that each of ``fns`` makes, all
    run in turn under one ``TorchDispatchMode``: one list a function, of
    (ATen op, source card), deterministic where a profiler's copy events
    may be lost.  An op with a CUDA input counts when it returns a CPU
    tensor (``aten._to_copy``: ``.cpu()``, ``.to("cpu")``, ``.tolist()``;
    ``aten.copy_`` into a CPU tensor), reads a CUDA scalar
    (``aten._local_scalar_dense``: ``.item()``, ``int()``, ``bool()``), is
    one of ``HOST_SYNCS`` (``nonzero``, ``torch.equal``, ``masked_select``,
    ``unique``, which read a count or a verdict back), or indexes with a
    boolean mask (``aten.index`` / ``index_put_``, which take the mask's
    ``nonzero``).  The mode sees every op that goes through the dispatcher,
    not what a C++ extension copies itself; the port's CUDA kernels
    (ctypes, ``kernels/build.py``) copy nothing to the host, and
    ``RolloutWorker.migrate_out``/``migrate_in`` launch none of them.  The
    mode is popped when the last function returns or raises."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    aten = torch.ops.aten
    masked = {aten.index.Tensor, aten.index_put_.default, aten.index_put.default}

    def cards(tree):
        return [t.device for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"]

    def on_host(tree):
        return any(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in tree_leaves(tree))

    def mask_index(func, args):
        return func in masked and any(isinstance(t, torch.Tensor)
                                      and t.dtype in (torch.bool, torch.uint8)
                                      for t in tree_leaves(args[1]))

    class Copies(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            src = cards((args, kwargs))
            if src and (func is aten._local_scalar_dense.default or on_host(out)
                        or func._schema.name in HOST_SYNCS or mask_index(func, args)):
                copies[-1].append((str(func), str(src[0])))
            return out

    copies = []
    with Copies():
        for fn in fns:
            copies.append([])
            fn()
    return copies


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _on_card(torch, tag, fn, args, card):
    """``fn(*args)`` moved to ``cuda:card`` and called with cuda:0 current,
    that card's first launch of the kernel, after the card's current stream
    was held by a spin kernel and then given a new first input (half the
    old one): a launch on that stream waits for it and reads the new input,
    a launch anywhere else would read the old one.  Its output must lie on
    the card, equal the same call made afterwards on the new input bit for
    bit and differ from the call on the old one.  (torch.profiler, which
    could show the stream directly, lost events on cuda:1-3 in a
    four-card run.)  Returns (the call's output on the old inputs, those
    inputs there)."""
    dev = torch.device("cuda", card)
    there = [a.to(dev) for a in args]
    old = there[0].clone()
    new = old * 0.5
    sync_all(torch)
    with torch.cuda.device(dev):
        torch.cuda._sleep(CARDS_SPIN_CYCLES)
        there[0].copy_(new)
    got = fn(*there)                                   # cuda:0 is current
    sync_all(torch)
    if any(o.device != dev for o in _outputs(got)):
        raise AssertionError(f"[cards] {tag}: output on {[o.device for o in _outputs(got)]}, "
                             f"not {dev}")
    got = [o.cpu() for o in _outputs(got)]
    after = [o.cpu() for o in _outputs(fn(*there))]
    there[0].copy_(old)
    before = [o.cpu() for o in _outputs(fn(*there))]
    if (not all(torch.equal(a, b) for a, b in zip(got, after))
            or all(torch.equal(a, b) for a, b in zip(got, before))):
        raise AssertionError(f"[cards] {tag} on cuda:{card}: the launch did not read the input "
                             f"written on that card's stream after the spin")
    return fn(*there), there


def _cards_kernels(torch, n):
    """Each kernel's first launch on cuda:1 .. cuda:n-1, through its wrapper
    with cuda:0 the current device: ordered on that card's stream
    (``_on_card``), its output bit-equal to the same inputs' launch on
    cuda:0 and held to the plain version on that card.  Shapes: the paged
    and dense kernels at qwen3's MP-2 shard (B 8, KV 4, G 2, lanes of
    2,048), the scan and its backward at jamba's MP-2 shard (B 1, S 2,048,
    di 4,096, N 16), bf16."""
    from repro_torch.kernels import decode_attention as kernel
    from repro_torch.kernels import mamba_scan as scan_kernel
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    q, k, v, pt, vl = _paged_inputs(torch, gen, torch.bfloat16, 1, 8, 4, 2, 128, 16, 128,
                                    8 * 128 + 1, 2048)
    dq, dk, dv = _dense_inputs(torch, gen, torch.bfloat16, 1, 8, 2048, 4, 2, 128)
    scan = _scan_inputs(torch, gen, 1, 2048, "bfloat16", di=4096)
    g_y = torch.randn((1, 2048, 4096), generator=gen, device="cuda")
    g_h = torch.randn((1, 4096, 16), generator=gen, device="cuda")
    cases = {"paged_decode_attention": (kernel.paged_decode_attention,
                                        [q[0], k[0], v[0], pt, vl]),
             "decode_attention": (kernel.decode_attention, [dq[0], dk[0], dv[0], vl]),
             "mamba_scan": (scan_kernel.mamba_scan, list(scan)),
             "mamba_scan_bwd": (scan_kernel.mamba_scan_bwd, [*scan, g_y, g_h])}
    errs = {}
    for name, (fn, args) in cases.items():
        first = [t.cpu() for t in _outputs(fn(*args))]
        for card in range(1, n):
            out, there = _on_card(torch, name, fn, args, card)
            outs = _outputs(out)
            if not all(torch.equal(a.cpu(), b) for a, b in zip(outs, first)):
                raise AssertionError(f"[cards] {name} on cuda:{card} differs from cuda:0")
            if name.endswith("decode_attention"):
                err = _hold_decode(torch, f"[cards] {name} cuda:{card}", there)[0]
            elif name == "mamba_scan":
                want = ref.mamba_scan_ref(*there)
                err = max(float((g - w).abs().max()) for g, w in zip(outs, want))
                limit = SCAN_TOL * max(1.0, float(want[0].abs().max()))
                _check_err(f"[cards] mamba_scan cuda:{card}", "float32", outs, err, limit)
            else:
                # held on the host: the hold's torch.ldexp, on a card that is not the
                # current device, returns garbage (tools/ldexp_cards.py)
                want = ref.mamba_scan_bwd_ref(*(t.float() for t in there[:5]), *there[5:])
                err = _hold_scan_bwd(torch, f"cuda:{card}", [o.cpu() for o in outs],
                                     [w.cpu() for w in want])[0]
            errs[name] = max(errs.get(name, 0.0), err)
        log(f"[cards] {name}: first launch on each of cuda:1 .. cuda:{n - 1} (cuda:0 "
            f"current) ordered on that card's stream, output there, bit-equal to cuda:0's, "
            f"max |err| {errs[name]:.3e} against the plain version there")
    torch.cuda.empty_cache()
    return errs


def _held_scans(torch, tag, calls):
    """Kept live scan calls against the plain version on their card."""
    from repro_torch.kernels import mamba_scan as scan_kernel
    from repro_torch.kernels import ref
    err = 0.0
    for args in calls:
        got, want = scan_kernel.mamba_scan(*args), ref.mamba_scan_ref(*args)
        for part, g, w in zip(("y", "h_S"), got, want):
            e = float((g - w).abs().max())
            _check_err(f"[cards] {tag} {part}", "float32", [g], e,
                       SCAN_TOL * max(1.0, float(w.abs().max())))
            err = max(err, e)
    return err


def _hold_card_calls(torch, tag, decode, scan=None):
    """The kept live calls of a run on cards other than 0 against their
    plain versions; logs and returns the largest errors."""
    errs = {}
    calls = [c for card in sorted(decode.kept) for c in decode.kept[card]]
    if calls:
        errs["paged_decode_attention"] = _held(torch, f"[cards] {tag}", calls)[0]
    if scan is not None:
        scans = [c for card in sorted(scan.kept) for c in scan.kept[card]]
        if scans:
            errs["mamba_scan"] = _held_scans(torch, tag, scans)
    if not calls or (scan is not None and "mamba_scan" not in errs):
        raise AssertionError(f"[cards] {tag}: no live call kept on a card other than 0")
    log(f"[cards] {tag}: live calls kept on cards {sorted(decode.kept)} held to the plain "
        f"version there: max |err| {errs}")
    return errs


def _peaks(torch, n):
    return [round(torch.cuda.max_memory_allocated(i) / 2**30, 2) for i in range(n)]


def _reset_peaks(torch, n):
    for i in range(n):
        torch.cuda.reset_peak_memory_stats(i)


def _cards_qwen3(torch, n, summary):
    """(a) qwen3-1.7b at full width, paged, CARDS_REQUESTS of phase 13's
    prompts, a teacher-forced step and CARDS_STEPS greedy steps: at d 2
    (and 4) every shard on cuda:0, then one shard a card, in f32 and in
    bf16: tokens and logits bit-equal, the paged kernel 28 times a step on
    each card; the step wall at d 1, 2, 4 and each card's busy share.  The bf16
    weights stay for (d), with the d2 worker on cuda:0-1.  Returns (the
    bf16 config, params, the d2 worker on cards, the kernels' launches, the
    largest error of the kept calls)."""
    import numpy as np
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kernel
    from repro_torch.models.model import init_params, tree_leaves, tree_map
    cfg = get_config("qwen3_1_7b")
    rng = np.random.default_rng(SEED)
    groups = [rng.integers(0, cfg.vocab, k).tolist() for k in (300, 257)]
    prompts = [groups[g] for g in CARDS_REQUESTS]
    sids = list(range(len(prompts)))
    degrees = (2, 4) if n >= 4 else (2,)
    params = init_params(replace(cfg, dtype="float32"), seed=SEED, device="cuda")
    launches, errs, kept = 0, {}, None
    n_attn = _n_kind(cfg, "attn")
    for dtype in ("float32", "bfloat16"):
        cfg = replace(cfg, dtype=dtype)
        if dtype == "bfloat16":
            params = tree_map(lambda t: t.to(torch.bfloat16), params)
            torch.cuda.empty_cache()
            w = _tp_worker(torch, cfg, params, 1, True)
            _, _, counts, step_ms, _ = _tp_drive(torch, cfg, w, prompts, "cards qwen3 d1",
                                                 CARDS_STEPS)
            launches += counts["paged_decode_attention"]
            wall, busy = _busy_by_card(torch, lambda: w.decode(sids, CARDS_PROFILE_STEPS))
            summary["qwen3-bf16-d1"] = {"step_ms": step_ms, "profiled_ms": wall,
                                        "busy_ms": busy}
            log(f"[cards] qwen3 bf16 d1 on cuda:0: decode {step_ms:.2f} ms a step; "
                f"{CARDS_PROFILE_STEPS} steps under torch.profiler {wall:.1f} ms, busy "
                + ", ".join(f"cuda:{c} {b:.1f} ms ({b / wall:.1%})" for c, b in busy.items()))
            del w
        for d in degrees:
            one = _tp_worker(torch, cfg, params, d, True)
            toks1, logits1, counts, step1, admit1 = _tp_drive(
                torch, cfg, one, prompts, f"cards qwen3 {dtype} d{d} one card", CARDS_STEPS)
            launches += counts["paged_decode_attention"]
            del one
            torch.cuda.empty_cache()
            mesh = _cards_mesh(torch, 0, d)
            w = _tp_worker(torch, cfg, params, d, True, mesh=mesh)
            if dtype == "float32" and d == degrees[-1]:
                drawn = init_params(cfg, seed=SEED, mesh=mesh)
                same = all(torch.equal(a, b) and a.device == b.device
                           for x, y in zip(drawn, w.params)
                           for a, b in zip(tree_leaves(x), tree_leaves(y)))
                if not same:
                    raise AssertionError(f"[cards] qwen3 f32 d{d}: init_params(mesh=) differs "
                                         f"from the worker's cut of the whole tree")
                log(f"[cards] qwen3 f32 d{d}: init_params(mesh=cuda:0..{d - 1}) bit-equal to "
                    f"the whole tree cut for the mesh, each shard on its card")
                del drawn
            with _PerCard(kernel, "paged_decode_attention") as card:
                toks, logits, counts, step_ms, admit_ms = _tp_drive(
                    torch, cfg, w, prompts, f"cards qwen3 {dtype} d{d} cards", CARDS_STEPS)
            launches += counts["paged_decode_attention"]
            _per_card(f"qwen3 {dtype} d{d}", card.counts, range(d), n_attn * (CARDS_STEPS + 1))
            errs[f"{dtype}-d{d}"] = _hold_card_calls(torch, f"qwen3 {dtype} d{d}", card)
            if toks != toks1 or not torch.equal(logits, logits1):
                diff = float((logits - logits1).abs().max())
                raise AssertionError(f"[cards] qwen3 {dtype} d{d}: tokens equal "
                                     f"{toks == toks1}, logits max |diff| {diff} on distinct "
                                     f"cards against one card")
            row = {"step_ms": step_ms, "one_card_step_ms": step1, "admit_ms": admit_ms,
                   "one_card_admit_ms": admit1}
            msg = (f"[cards] qwen3 {dtype} d{d} on cuda:0..{d - 1}: tokens and logits "
                   f"bit-equal to [cuda:0] x {d}; the paged kernel {n_attn} x "
                   f"{CARDS_STEPS + 1} on each card; decode {step_ms:.2f} ms a step (one "
                   f"card {step1:.2f}), admission {admit_ms:.1f} ms a prompt (one card "
                   f"{admit1:.1f})")
            if dtype == "bfloat16":
                wall, busy = _busy_by_card(torch, lambda: w.decode(sids, CARDS_PROFILE_STEPS))
                row.update(profiled_ms=wall, busy_ms=busy)
                msg += (f"; {CARDS_PROFILE_STEPS} steps under torch.profiler {wall:.1f} ms, "
                        f"busy " + ", ".join(f"cuda:{c} {b:.1f} ms ({b / wall:.1%})"
                                             for c, b in busy.items()))
            summary[f"qwen3-{dtype}-d{d}"] = row
            log(msg)
            if dtype == "bfloat16" and d == 2:
                kept = w
            del w
            torch.cuda.empty_cache()
    return cfg, params, kept, launches, max(max(e.values()) for e in errs.values())


def _rounded_shards(torch, cfg32, mesh):
    """The f32 model's weights rounded to bf16 (``_to_bf16``'s rule), cut
    for ``mesh``: each f32 leaf drawn in ``init_params``' order on the
    mesh's device 0, rounded, cut and moved, one leaf at a time."""
    from repro_torch.distributed.sharding import shard_params, tp_split
    from repro_torch.models import model as M
    dev = mesh.devices[0]
    draws = M._param_draws(cfg32, torch.Generator(device=dev).manual_seed(SEED), dev)

    def rounded(tree):
        return {k: rounded(v) if isinstance(v, dict)
                else v if k in F32_LEAVES else (lambda draw=v: draw().to(torch.bfloat16))
                for k, v in tree.items()}

    return shard_params(rounded(draws), tp_split(cfg32, mesh.degree), mesh)


def _cards_jamba_run(torch, cfg, params, mesh, prompts, tag, routes=None):
    """A paged worker on ``mesh`` driven as phase 14's: the scan 28 times an
    admission and the paged kernel 4 times a step on each card, a few live
    calls on cards other than 0 held; each card's peak memory logged.
    Returns (tokens, logits, launches, errors)."""
    from repro_torch.kernels import decode_attention as kernel
    from repro_torch.kernels import mamba_scan as scan_kernel
    import gc
    d, n = mesh.degree, torch.cuda.device_count()
    gc.collect()                                # the last worker's reference cycles
    torch.cuda.empty_cache()
    held = [round(torch.cuda.memory_allocated(i) / 2**30, 2) for i in range(n)]
    _reset_peaks(torch, n)
    w = _tp_worker(torch, cfg, params, d, True, mesh=mesh)
    state = _nbytes(w.pool[0]) / 1e9
    with _PerCard(kernel, "paged_decode_attention") as paged, \
            _PerCard(scan_kernel, "mamba_scan") as scan:
        if routes is None:
            toks, logits, counts, step_ms, admit_ms = _tp_drive(torch, cfg, w, prompts, tag,
                                                                CARDS_STEPS)
        else:
            with routes:
                toks, logits, counts, step_ms, admit_ms = _tp_drive(torch, cfg, w, prompts,
                                                                    tag, CARDS_STEPS)
    _per_card(f"{tag} scan", scan.counts, range(d), _n_kind(cfg, "mamba") * len(prompts))
    _per_card(f"{tag} paged", paged.counts, range(d), _n_kind(cfg, "attn") * (CARDS_STEPS + 1))
    errs = _hold_card_calls(torch, tag, paged, scan)
    peaks = _peaks(torch, n)
    weights = _nbytes(params[0]) / 1e9
    log(f"[cards] {tag} on cuda:0..{d - 1}: {weights:.2f} GB of weights and {state:.3f} GB of "
        f"pool a card, allocated by card before the worker {held} GiB, peak {peaks} GiB (of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}); the scan "
        f"{_n_kind(cfg, 'mamba')} x {len(prompts)} admissions and the paged kernel "
        f"{_n_kind(cfg, 'attn')} x {CARDS_STEPS + 1} steps on each card; admission "
        f"{admit_ms:.1f} ms a prompt, decode {step_ms:.2f} ms a step")
    del w
    torch.cuda.empty_cache()
    return toks, logits, counts, errs, {"weights_gb": weights, "pool_gb": state,
                                        "peak_gib": peaks, "step_ms": step_ms,
                                        "admit_ms": admit_ms}


def _cards_jamba(torch, n, summary):
    """(b) jamba-v0.1-52b at its full depth (4 periods, nothing cut),
    initialised sharded: f32 at d 4 on cuda:0-3 (the reference), the same
    weights rounded to bf16 in place at d 4, then drawn again, rounded and
    cut at d 2 on cuda:0-1; CARDS_REQUESTS of phase 14's prompts (1,024 and
    700), one teacher-forced step, CARDS_STEPS greedy steps.  The bf16 d2 logits no
    farther from the bf16 d4's than TP_BF16_SPREAD x the bf16 d4's from the
    f32 d4's; the MoE top-2 flips between d4 and d2 counted.  Returns the
    kernels' launches and the largest errors of the kept calls."""
    import numpy as np
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg32 = replace(get_config("jamba_v0_1_52b"), dtype="float32")
    cfg16 = replace(cfg32, dtype="bfloat16")
    rng = np.random.default_rng(SEED + 14)
    groups = [rng.integers(0, cfg32.vocab, k).tolist() for k in TP_JAMBA_PROMPTS]
    prompts = [groups[g] for g in CARDS_REQUESTS]
    launches, errs, runs = {}, [], {}

    def count(counts, err):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        errs.append(err)

    if n >= 4:
        mesh4 = _cards_mesh(torch, 0, 4)
        _reset_peaks(torch, n)
        params, ms = sync_ms(torch, lambda: init_params(cfg32, seed=SEED, mesh=mesh4))
        log(f"[cards] jamba f32 {cfg32.n_layers} layers, init_params(mesh=cuda:0..3) "
            f"{ms / 1e3:.1f} s: {_nbytes(params[0]) / 1e9:.2f} GB a card, "
            f"{sum(_nbytes(p) for p in params) / 1e9:.1f} GB in all; peak allocated by card "
            f"{_peaks(torch, n)} GiB")
        *runs["f32-d4"], info = _cards_jamba_run(torch, cfg32, params, mesh4, prompts,
                                                 "jamba f32 d4")
        count(runs["f32-d4"][2], runs["f32-d4"][3])
        summary["jamba-f32-d4"] = info
        for r in range(len(params)):
            _to_bf16(torch, params[r])                     # the same weights, rounded
        routes4 = _MoeRoutes(torch, 4)
        *runs["bf16-d4"], info = _cards_jamba_run(torch, cfg16, params, mesh4, prompts,
                                                  "jamba bf16 d4", routes4)
        count(runs["bf16-d4"][2], runs["bf16-d4"][3])
        summary["jamba-bf16-d4"] = info
        del params
        torch.cuda.empty_cache()
    else:
        log(f"[cards] jamba d4 not run: {n} cards visible; its f32 weights (206 GB, 51.6 GB "
            f"a card at d 4) need four, so the bf16 d2 is not held")
    mesh2 = _cards_mesh(torch, 0, 2)
    params, ms = sync_ms(torch, lambda: _rounded_shards(torch, cfg32, mesh2))
    log(f"[cards] jamba bf16 d2: the f32 draws rounded and cut for cuda:0..1 in "
        f"{ms / 1e3:.1f} s, {_nbytes(params[0]) / 1e9:.2f} GB a card")
    routes2 = _MoeRoutes(torch, 2)
    *runs["bf16-d2"], info = _cards_jamba_run(torch, cfg16, params, mesh2, prompts,
                                              "jamba bf16 d2", routes2)
    count(runs["bf16-d2"][2], runs["bf16-d2"][3])
    summary["jamba-bf16-d2"] = info
    del params
    torch.cuda.empty_cache()
    if n >= 4:
        own, _, _ = _tp_against(*runs["bf16-d4"][:2], runs["f32-d4"][:2])
        err, scale, same = _tp_against(*runs["bf16-d2"][:2], runs["bf16-d4"][:2])
        summary["jamba-bf16-hold"] = {"d2_from_d4": err, "d4_from_f32": own,
                                      "ratio": err / own}
        summary["jamba-moe-flips"] = _log_flips(cfg16, len(prompts), routes4, routes2,
                                                names=("d4", "d2"), tag="cards")
        log(f"[cards] jamba bf16 d2: logits {err:.3e} from the bf16 d4 (max |ref| "
            f"{scale:.3e}; {same}/{len(prompts) * CARDS_STEPS} tokens equal before a lane's "
            f"first difference), {err / own:.3f} x the bf16 d4's {own:.3e} from the f32 d4 "
            f"(at most {TP_BF16_SPREAD})")
        if not err <= TP_BF16_SPREAD * own:
            raise AssertionError(f"[cards] jamba bf16 d2: {err:.3e} from the bf16 d4, more than "
                                 f"{TP_BF16_SPREAD} x the bf16 d4's {own:.3e} from the f32 d4")
    return launches, max(max(e.values()) for e in errs)


def _cards_migrate(torch, cfg, params, src, n, summary):
    """(d) one lane of the bf16 d2 worker on cuda:0-1 moved card to card to
    a d2 worker on cuda:2-3 (a d1 on the last card where fewer are
    visible) and back, CARDS_HOPS times: every leaf of each package on its
    source's device 0, the package bit-equal after every hop; then the same
    hops through the host, the package copied there before
    ``migrate_in``, as a sharded package was before.  Last, one hop each
    way under one ``_host_copies`` mode: 0 copies to the host card to card,
    and at least one a package leaf through the host (the control)."""
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.models.model import tree_leaves, tree_to
    dst_mesh = (_cards_mesh(torch, 2, 2) if n >= 4
                else WorkerMesh((torch.device("cuda", n - 1),)))
    dst = _tp_worker(torch, cfg, params, dst_mesh.degree, True, mesh=dst_mesh)
    first = None

    def hop(a, b, bounce=False):
        pkg = a.migrate_out(0)
        leaves = list(tree_leaves({"pages": pkg["pages"], "state": pkg["state"]}))
        if any(t.device != a.device for t in leaves):
            raise AssertionError(f"[cards] a package leaf of a worker on {a.device} lies on "
                                 f"{[t.device for t in leaves if t.device != a.device][:1]}")
        if bounce:
            pkg.update(pages=tree_to(pkg["pages"], "cpu"), state=tree_to(pkg["state"], "cpu"))
        b.migrate_in(pkg)
        return leaves

    for name, bounce in (("card to card", False), ("through the host", True)):
        walls = []
        for i in range(CARDS_HOPS):
            a, b = (src, dst) if i % 2 == 0 else (dst, src)
            leaves, ms = sync_ms(torch, lambda: hop(a, b, bounce))
            walls.append(ms)
            got = [t.cpu() for t in leaves]
            first = first or got
            if not all(torch.equal(x, y) for x, y in zip(got, first)):
                raise AssertionError(f"[cards] the package after hop {i} ({name}) differs")
        summary[f"migrate-{name}"] = walls
        log(f"[cards] a lane of {len(src.store[0].tokens)} tokens, "
            f"{sum(t.numel() * t.element_size() for t in first) / 1e6:.1f} MB of pages and "
            f"state, moved {name} between d2 on cuda:0-1 and "
            f"{'-'.join(str(d) for d in dst_mesh.devices)}: "
            f"{', '.join(f'{ms:.1f}' for ms in walls)} ms a move (migrate_out + migrate_in), "
            f"every package bit-equal to the first")
    copies, back = _host_copies(torch, lambda: hop(src, dst),
                                lambda: hop(dst, src, bounce=True))
    summary["host-copies"] = {"card to card": len(copies), "through the host": len(back),
                              "package leaves": len(first)}
    log(f"[cards] copies to the host (TorchDispatchMode) in a move card to card: "
        f"{len(copies)} {copies}; through the host: {len(back)} "
        f"({sorted(set(back))}), the package's leaves {len(first)}")
    if copies or len(back) < len(first):
        raise AssertionError(f"[cards] a card-to-card move copied {copies} to the host, or "
                             f"the host bounce counted {len(back)} copies for "
                             f"{len(first)} package leaves")
    toks = src.decode([0], 4)[0]
    log(f"[cards] the lane decodes on after the moves ({toks})")
    del dst


def _cards_reconfigure(torch, cfg, params, devices):
    """A {2, 1, 1} fleet over ``devices``: four lanes admitted (two on the d2
    worker, one on each d1), decoded, the fleet reconfigured to {4} (every
    lane moved to the d4 worker), decoded, reconfigured back to {2, 1, 1},
    decoded.  Returns (each lane's tokens, the two reconfigures' ms)."""
    import numpy as np
    from repro_torch.engine.fleet import FleetSpec, RolloutFleet
    from repro_torch.engine.sampler import SamplerConfig
    fleet = RolloutFleet(cfg, params, FleetSpec((2, 1, 1)), capacity=RUNTIME_CAPACITY,
                         max_slots=8, sampler=SamplerConfig(temperature=0.8), seed=5,
                         devices=devices)
    rng = np.random.default_rng(SEED + 17)
    home = {0: 0, 1: 0, 2: 1, 3: 2}
    toks = {sid: [] for sid in home}
    for sid, wi in home.items():
        fleet.workers[wi].prefill(sid, rng.integers(0, cfg.vocab, 200).tolist())

    def decode():
        for w in fleet.workers:
            for sid, t in w.decode(list(w.store), CARDS_RECONF_STEPS).items():
                toks[sid] += t

    decode()
    ms = []
    for spec in ((4,), (2, 1, 1)):
        report, t = sync_ms(torch, lambda: fleet.reconfigure(FleetSpec(spec)))
        ms.append(t)
        if report["migrated_residents"] != len(home):
            raise AssertionError(f"[cards] reconfigure to {spec}: {report}")
        decode()
    return toks, ms


def _cards_runtime(torch, n, summary):
    """(c) CARDS_RUNTIME_PROMPTS of phase 9's 6 prompts (groups of 4) on a
    {2, 1, 1} fleet over cuda:0-3, paged: the
    decision trace held to the sim's (which phase 9's one-card run is held
    to), the paged kernel launched on every card, a few live calls on cards
    other than 0 held; then the fleet's reconfigure {2, 1, 1} -> {4} -> {2,
    1, 1} with live lanes on one card and on four, their tokens equal; then
    the serve CLI with --degrees 2,1,1 as a process of its own.  Returns the
    kernel's launches and the largest error of the kept calls."""
    import os
    from repro_torch.engine.fleet import FleetSpec
    from repro_torch.engine.runtime import RuntimeConfig, build_workbench
    from repro_torch.kernels import decode_attention as kernel
    cfg, params = _full_width(torch)
    cards = [torch.device("cuda", i) for i in range(4)]
    batch, predictor = build_workbench(n_prompts=CARDS_RUNTIME_PROMPTS, group_size=4, seed=5)
    with _PerCard(kernel, "paged_decode_attention") as card:
        res, launches, _, kept, stats = _runtime_run(
            torch, "cards {2,1,1}", cfg, params, batch, predictor,
            RuntimeConfig(**RUNTIME_BASE), fleet=FleetSpec((2, 1, 1)), devices=cards,
            every=CARDS_CAPTURE_EVERY)
    if set(card.counts) != set(range(4)) or sum(card.counts.values()) != \
            launches["paged_decode_attention"]:
        raise AssertionError(f"[cards] runtime: launches by card {card.counts}, in all "
                             f"{launches}")
    if [s.get("mesh_devices") for s in stats] != [2, 1, 1]:
        raise AssertionError(f"[cards] runtime: workers' meshes {stats}")
    err = max(_hold_kept(torch, "cards {2,1,1}", kept, CARDS_CAPTURE_EVERY),
              max(_hold_card_calls(torch, "runtime {2,1,1}", card).values()))
    summary["runtime"] = {"wall_s": res.wall_time, "launches_by_card": card.counts}
    log(f"[cards] runtime {{2,1,1}} over cuda:0..3: trace == sim ({len(res.trace)} events), "
        f"paged kernel launches by card {card.counts}, wall {res.wall_time:.2f} s")
    runs = {}
    for name, devices in (("one card", [cards[0]] * 4), ("four cards", cards)):
        runs[name] = _cards_reconfigure(torch, cfg, params, devices)
        log(f"[cards] reconfigure {{2,1,1}} -> {{4}} -> {{2,1,1}} on {name}: "
            f"{', '.join(f'{t:.1f}' for t in runs[name][1])} ms, 4 live lanes moved each time")
    if runs["one card"][0] != runs["four cards"][0]:
        raise AssertionError("[cards] the reconfigured lanes' tokens differ between one card "
                             "and four")
    summary["reconfigure_ms"] = {k: v[1] for k, v in runs.items()}
    log(f"[cards] the 4 lanes' {3 * CARDS_RECONF_STEPS} tokens each, decoded before, between "
        f"and after the moves, equal on one card and on four")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                          "qwen3-1.7b", "--requests", "8", "--steps", "2", "--degrees",
                          "2,1,1"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    out = cli.stdout
    if cli.returncode != 0 or "worker 0 (MP 2 over 2 devices)" not in out \
            or "served 8 trajectories on cuda" not in out:
        raise AssertionError(f"[cards] serve CLI --degrees 2,1,1 exited {cli.returncode}:\n"
                             f"{out[-2000:]}\n{cli.stderr[-2000:]}")
    log(f"[cards] serve CLI --degrees 2,1,1 over the {n} visible cards (a process of its own): "
        f"exit 0 in {time.perf_counter() - t0:.1f} s")
    return launches["paged_decode_attention"], err


def phase_cards(torch):
    """Tensor-parallel workers on distinct cards: needs two or more visible
    cards, and four for jamba's f32 d4, the {2, 1, 1} runtime and d4
    anywhere.  On one card it says so and claims nothing.  Returns None
    there, else the launches and largest errors by kernel."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"[cards] not run: {n} card visible; phase 17 shards workers over distinct cards "
            f"and needs two or more (four for all of it); nothing is claimed for it here")
        return None
    from repro_torch.launch.mesh import WorkerMesh
    cards = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()
    log(f"[cards] {n} cards: " + "; ".join(cards))
    peers = WorkerMesh(tuple(torch.device("cuda", i) for i in range(n))).peer_access()
    log("[cards] peer access: " + ", ".join(f"{a}->{b} {'on' if ok else 'off'}"
                                            for (a, b), ok in peers.items()))
    summary = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[cards] part {name}: {time.perf_counter() - t0:.1f} s")
        return out

    kernel_errs = part("kernels", _cards_kernels, torch, n)
    cfg, params, src, qwen3_launches, qwen3_err = part("(a) qwen3", _cards_qwen3, torch, n,
                                                       summary)
    part("(d) migration", _cards_migrate, torch, cfg, params, src, n, summary)
    del src, params
    torch.cuda.empty_cache()
    jamba_launches, jamba_err = part("(b) jamba", _cards_jamba, torch, n, summary)
    runtime = (part("(c) runtime", _cards_runtime, torch, n, summary) if n >= 4 else None)
    if runtime is None:
        log(f"[cards] the {{2,1,1}} runtime not run: {n} cards visible, it needs four")
    log(f"[cards] summary {json.dumps(summary)}")
    return {"paged_launches": qwen3_launches + jamba_launches.get("paged_decode_attention", 0)
            + (runtime[0] if runtime else 0),
            "scan_launches": jamba_launches.get("mamba_scan", 0),
            "max_abs_err": {"first_launch": kernel_errs, "qwen3": qwen3_err,
                            "jamba": jamba_err, "runtime": runtime and runtime[1]}}


# ---------------------------------------------------------------- phase 18
DRYRUN_LANES = 16          # (a): decode_32k's 128 lanes cut to fit one card (60 GB of KV)
DRYRUN_TP_LANES = 4        # (b): lanes at degree 2 (only the collectives are held)
DRYRUN_PROMPT = 2048       # (c): one jamba admission, phase 7's first prompt
DRYRUN_PEAK_TOL = (0.01, 64 * 2**20)    # reckoned temp within 1% + 64 MiB of the card's


def _storage_bytes(torch, tree):
    """Bytes of the distinct storages under ``tree`` (a view counts once)."""
    from repro_torch.launch.dryrun import _tensors
    seen = {}
    for t in _tensors(tree):
        seen.setdefault(t.untyped_storage()._cdata, t.untyped_storage().nbytes())
    return sum(seen.values())


def _counted_mesh(devices):
    """A ``WorkerMesh`` that counts its reduce and gather calls and their
    wire bytes as the dry run reckons them (2x and 1x the output's bytes)."""
    from repro_torch.launch.mesh import WorkerMesh

    class CountedMesh(WorkerMesh):
        def __init__(self, devs):
            super().__init__(tuple(devs))
            object.__setattr__(self, "calls", {"all-reduce": [0, 0.0], "all-gather": [0, 0.0]})

        def reduce(self, parts):
            call = self.calls["all-reduce"]
            call[0] += 1
            call[1] += 2.0 * parts[0].numel() * parts[0].element_size()
            return super().reduce(parts)

        def gather(self, parts, dim):
            out = super().gather(parts, dim)
            call = self.calls["all-gather"]
            call[0] += 1
            call[1] += 1.0 * out.numel() * out.element_size()
            return out

    return CountedMesh(devices)


def _dryrun_real(torch, step):
    """The step on the card, its products counted by FlopCounterMode, the
    kernels' launches zeroed just before and read just after: (outputs,
    product FLOPs, launches, peak allocated above what was allocated before
    it, the step's ms)."""
    from torch.utils.flop_counter import FlopCounterMode
    sync_all(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _reset_launches()
    counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with counter:
        out = step.fn(*step.args)
    launches = _read_launches(torch)
    ms = (time.perf_counter() - t0) * 1e3
    return out, counter.get_total_flops(), launches, torch.cuda.max_memory_allocated() - base, ms


def _hold_dryrun(tag, rec, real_args, flops, formula, launches, peak, hold_peak=True):
    """The reckoning of ``rec`` against the card's step: argument bytes and
    product FLOPs equal, the kernels' operations their formula, the
    predicted launches the real ones, the reckoned temp within
    DRYRUN_PEAK_TOL of the card's peak above the arguments (logged only
    where ``hold_peak`` is false)."""
    gap = rec["temp_size_in_bytes"] - peak
    limit = DRYRUN_PEAK_TOL[0] * peak + DRYRUN_PEAK_TOL[1]
    log(f"[dryrun] {tag}: arguments reckoned {rec['argument_size_in_bytes']} B, on the card "
        f"{real_args} B; product FLOPs reckoned {rec['product_flops']}, FlopCounterMode "
        f"{flops}; kernel operations {rec['kernel_flops']} (formula {formula}); launches "
        f"reckoned {rec['kernel_launches']}, on the card {launches}; temp reckoned "
        f"{rec['temp_size_in_bytes'] / 2**30:.4f} GiB, the card's peak above its arguments "
        f"{peak / 2**30:.4f} GiB (gap {gap / 2**20:+.1f} MiB, limit {limit / 2**20:.1f} MiB)")
    if rec["argument_size_in_bytes"] != real_args:
        raise AssertionError(f"[dryrun] {tag}: argument bytes {rec['argument_size_in_bytes']} "
                             f"!= {real_args}")
    if rec["product_flops"] != flops or rec["kernel_flops"] != formula:
        raise AssertionError(f"[dryrun] {tag}: FLOPs ({rec['product_flops']}, "
                             f"{rec['kernel_flops']}) != ({flops}, {formula})")
    if rec["kernel_launches"] != {k: n for k, n in launches.items() if n}:
        raise AssertionError(f"[dryrun] {tag}: launches {rec['kernel_launches']} != {launches}")
    if hold_peak and abs(gap) > limit:
        raise AssertionError(f"[dryrun] {tag}: reckoned temp off the card's by "
                             f"{gap / 2**20:.1f} MiB (limit {limit / 2**20:.1f} MiB)")


def _dryrun_decode(torch):
    """(a) qwen3-1.7b's decode_32k at full width on a one-card layout
    (degree 1, DRYRUN_LANES lanes of 32,768 slots): reckoned by run_one,
    then the same step run for real on cuda:0."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import meta
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import ProductionLayout, WorkerMesh
    from repro_torch.models.config import InputShape
    cfg = get_config("qwen3_1_7b")
    shape = InputShape("decode_32k", 32_768, DRYRUN_LANES, "decode")
    t0 = time.perf_counter()
    rec = dryrun.run_one("qwen3-1.7b", "decode_32k", verbose=False, shape=shape,
                         layout=ProductionLayout(1, WorkerMesh((torch.device("meta"),))))
    log(f"[dryrun] (a) reckoned on meta in {time.perf_counter() - t0:.1f} s: "
        f"{json.dumps(rec)}")
    torch.cuda.empty_cache()
    log(f"[dryrun] (a) allocated on cuda:0 before the step's arguments: "
        f"{torch.cuda.memory_allocated(0) / 2**30:.3f} GiB")
    step = specs.build(cfg, shape, ProductionLayout(1, WorkerMesh((torch.device("cuda", 0),))))
    real_args = _storage_bytes(torch, step.args)
    out, flops, launches, peak, ms = _dryrun_real(torch, step)
    logits = out[0]
    if logits.shape != (DRYRUN_LANES, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[dryrun] (a): logits {tuple(logits.shape)} not finite")
    G = cfg.n_heads // cfg.n_kv_heads
    formula = cfg.n_layers * meta.decode_cost(DRYRUN_LANES, cfg.n_kv_heads, G, cfg.hd,
                                              DRYRUN_LANES * shape.seq_len, 2)[0]
    log(f"[dryrun] (a) the step on cuda:0: {ms:.1f} ms (first call), logits finite")
    _hold_dryrun("(a) qwen3-1.7b decode_32k, 16 lanes, degree 1", rec, real_args, flops,
                 formula, launches, peak)
    del step, out, logits
    torch.cuda.empty_cache()
    return launches


def _dryrun_tp(torch):
    """(b) the same decode at degree 2 with both shards on cuda:0: the
    reckoned all-reduces and all-gathers, their wire bytes, each shard's
    argument bytes and the launches against the real step's mesh calls."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import ProductionLayout, WorkerMesh
    from repro_torch.models.config import InputShape
    cfg = get_config("qwen3_1_7b")
    shape = InputShape("decode_32k", 32_768, DRYRUN_TP_LANES, "decode")
    rec, tally = dryrun.reckon(cfg, shape, ProductionLayout(1, WorkerMesh(
        (torch.device("meta"),) * 2)))
    cards = [tally.per_card(r) for r in range(2)]
    mesh = _counted_mesh((torch.device("cuda", 0),) * 2)
    step = specs.build(cfg, shape, ProductionLayout(1, mesh))
    shard_bytes = [_storage_bytes(torch, trees) for trees in step.shards]
    out, flops, launches, _, ms = _dryrun_real(torch, step)
    if not bool(torch.isfinite(out[0]).all()):
        raise AssertionError("[dryrun] (b): logits not finite")
    want = {k: [rec["collective_counts"][k], rec["collective_bytes"][k]] for k in mesh.calls}
    log(f"[dryrun] (b) degree 2 on [cuda:0] * 2 ({ms:.1f} ms): collectives reckoned {want}, "
        f"the mesh's calls {mesh.calls}; shard argument bytes reckoned "
        f"{[c['argument_size_in_bytes'] for c in cards]}, on the card {shard_bytes}; "
        f"product FLOPs reckoned {tally.totals()[0]} in all, FlopCounterMode {flops}; "
        f"launches reckoned {cards[0]['kernel_launches']} a card, on the card {launches}")
    if mesh.calls != want:
        raise AssertionError(f"[dryrun] (b): collectives {mesh.calls} != reckoned {want}")
    if [c["argument_size_in_bytes"] for c in cards] != shard_bytes:
        raise AssertionError(f"[dryrun] (b): shard bytes {shard_bytes} != reckoned")
    if tally.totals()[0] != flops:
        raise AssertionError(f"[dryrun] (b): product FLOPs {flops} != {tally.totals()[0]}")
    if launches["decode_attention"] != 2 * cards[0]["kernel_launches"]["decode_attention"]:
        raise AssertionError(f"[dryrun] (b): launches {launches}")
    del step, out, mesh
    torch.cuda.empty_cache()
    return launches


def _dryrun_jamba(torch):
    """(c) one admission of a DRYRUN_PROMPT-token prompt on phase 7's
    one-period jamba (prefill at degree 1): the predicted scan launches,
    one a Mamba layer, against the real ones, and the FLOPs and bytes."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import meta
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import ProductionLayout, WorkerMesh
    from repro_torch.models.config import InputShape
    cfg = dataclasses.replace(get_config("jamba_v0_1_52b"), n_periods=1)
    shape = InputShape("prefill_2k", DRYRUN_PROMPT, 1, "prefill")
    rec, _ = dryrun.reckon(cfg, shape, ProductionLayout(1, WorkerMesh((torch.device("meta"),))))
    step = specs.build(cfg, shape, ProductionLayout(1, WorkerMesh((torch.device("cuda", 0),))))
    real_args = _storage_bytes(torch, step.args)
    out, flops, launches, peak, ms = _dryrun_real(torch, step)
    if not bool(torch.isfinite(out[0]).all()):
        raise AssertionError("[dryrun] (c): logits not finite")
    n_mamba = cfg.n_periods * sum(k.startswith("mamba") for k in cfg.block_pattern)
    formula = n_mamba * meta.scan_cost(1, DRYRUN_PROMPT, cfg.d_inner, cfg.ssm_state_dim, 2)[0]
    log(f"[dryrun] (c) jamba one period, a {DRYRUN_PROMPT}-token admission on cuda:0 "
        f"({ms:.1f} ms, first call)")
    _hold_dryrun(f"(c) jamba 1 period, prefill {DRYRUN_PROMPT}", rec, real_args, flops,
                 formula, launches, peak, hold_peak=False)
    del step, out
    torch.cuda.empty_cache()
    return launches


def phase_dryrun(torch, smi):
    """The dry run (launch/dryrun.py) held against the card: (a), (b), (c)."""
    t0 = time.perf_counter()
    dense = _dryrun_decode(torch)
    tp = _dryrun_tp(torch)
    jamba = _dryrun_jamba(torch)
    log(f"[dryrun] held on {smi}: (a) {dense['decode_attention']} dense launches as "
        f"reckoned, (b) the collectives as reckoned, (c) {jamba['mamba_scan']} scan launches "
        f"as reckoned; {time.perf_counter() - t0:.1f} s")
    return {"decode_attention": dense["decode_attention"] + tp["decode_attention"],
            "mamba_scan": jamba["mamba_scan"]}


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False      # f32 matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_script = time.perf_counter()

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
        families = timed("families", phase_families, torch, info["smi"])
        encoders = timed("encoders", phase_encoders, torch, info["smi"])
        train = timed("train", phase_train, torch, info["smi"])
        tp = timed("tp", phase_tp, torch, info["smi"])
        tp_mixers = timed("tp-mixers", phase_tp_mixers, torch, info["smi"])
        tp_cross = timed("tp-cross", phase_tp_cross, torch, info["smi"])
        examples = timed("examples", phase_examples, torch, info["smi"])
        cards = timed("cards", phase_cards, torch)
        dryrun = timed("dryrun", phase_dryrun, torch, info["smi"])
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
         "families_launches": families["paged"],
         "families_max_abs_err": families["max_abs_err"]["paged_decode_attention"],
         "train_launches": train["launches"], "train_max_abs_err": train["max_abs_err"],
         "tp_launches": (tp["launches"]["paged_decode_attention"]
                         + tp_mixers["launches"]["paged_decode_attention"]),
         "tp_rows": {**tp["rows"]["paged_decode_attention"],
                     **tp_mixers["rows"]["paged_decode_attention"]},
         "examples_launches": examples["launches"],
         "examples_max_abs_err": examples["max_abs_err"],
         "cards_launches": cards and cards["paged_launches"],
         "cards_max_abs_err": cards and cards["max_abs_err"],
         **rows["paged_decode_attention"]["bfloat16"]},
        {"name": "decode_attention", "route": "cuda",
         "source": f"{csrc}/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:159",
         "launches": dense_launches, "runtime_launches": runtime["dense"],
         "runtime_max_abs_err": runtime["max_abs_err"]["decode_attention"],
         "families_launches": families["dense"],
         "families_max_abs_err": families["max_abs_err"]["decode_attention"],
         "encoders_launches": encoders["launches"],
         "encoders_max_abs_err": encoders["max_abs_err"],
         "legacy_launches": train["legacy_launches"],
         "legacy_max_abs_err": train["legacy_max_abs_err"],
         "tp_launches": (tp["launches"]["decode_attention"]
                         + tp_mixers["launches"]["decode_attention"]
                         + tp_cross["launches"]["decode_attention"]),
         "tp_cross_launches": tp_cross["launches"]["decode_attention"],
         "tp_cross_max_abs_err": tp_cross["max_abs_err"],
         "tp_rows": tp["rows"]["decode_attention"],
         "tp_cross_rows": {label: rows[label] for label, *_ in TP_CROSS_SHAPES},
         "dryrun_launches": dryrun["decode_attention"],
         **rows["decode_attention"]["bfloat16"]},
        {"name": "mamba_scan", "route": "cuda",
         "source": f"{csrc}/mamba_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan.py:55",
         "launches": jamba_launches["mamba_scan"],
         "train_launches": train["jamba_launches"]["mamba_scan"],
         "tp_launches": tp_mixers["launches"]["mamba_scan"],
         "tp_rows": tp_mixers["rows"]["mamba_scan"],
         "cards_launches": cards and cards["scan_launches"],
         "dryrun_launches": dryrun["mamba_scan"],
         **rows["mamba_scan"]["bfloat16"]},
        {"name": "mamba_scan_bwd", "route": "cuda",
         "source": f"{csrc}/mamba_scan_bwd.cu",
         "replaces": "src/repro/models/layers.py:530 (the VJP of _mamba_scan_fused, which "
                     "jax.grad takes through plain JAX; no Pallas backward)",
         "launches": train["jamba_launches"]["mamba_scan_bwd"],
         **rows["mamba_scan_bwd"]["bfloat16"]},
    ]
    log(f"[time] script: {time.perf_counter() - t_script:.1f} s")
    log(f"[device] {info['smi']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
