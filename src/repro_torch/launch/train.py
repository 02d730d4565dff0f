"""Training launcher: agentic GRPO with Heddle-orchestrated rollout, on the port.

Trains ``--arch`` reduced to two periods, with random params from ``--seed``,
on ``--device`` (default: the card; with no CUDA device the launcher exits
with an error unless given ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --iters 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --iters 2

``--dry-run`` trains nothing: it reckons ``--arch`` at full width per card on
the H100 layout (one host of 8 cards, two with ``--multi-pod``) for one
``train_4k`` step, the GRPO loss, its gradients and AdamW, on ``meta``
tensors with nothing allocated and no card needed (``launch/dryrun.py``):
argument, output and temp bytes, FLOPs and bytes accessed a card, each card
a replica at MP degree 1 with its share of the batch:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --dry-run
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--group-size", type=int, default=8)
    ap.add_argument("--tasks-per-iter", type=int, default=4)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--lr", type=float, default=8e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--dry-run", action="store_true",
                    help="reckon the FULL config per card on the H100 layout "
                         "(launch/dryrun.py) instead of training the reduced one")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the dry run's two-host layout, 2x1x8")
    ap.add_argument("--device", default=None,
                    help="torch device of the trainer and its workers (default: "
                         "cuda; 'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.dry_run:
        from repro_torch.launch import dryrun
        return dryrun.main(["--arch", args.arch, "--shape", "train_4k"]
                           + (["--multi-pod"] if args.multi_pod else []))
    if args.multi_pod:
        ap.error("--multi-pod is the dry run's two-host layout; it needs --dry-run")

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.engine.worker import check_servable
    from repro_torch.rl import data as D
    from repro_torch.rl.loop import HeddleTrainer, TrainerConfig

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    cfg = get_config(args.arch).reduced(n_periods=2)
    try:
        check_servable(cfg)
    except NotImplementedError as e:
        ap.error(str(e))
    trainer = HeddleTrainer(cfg, TrainerConfig(
        group_size=args.group_size, n_workers=args.workers, lr=args.lr,
        seed=args.seed), device=device)
    print(f"training {cfg.name} (reduced, {cfg.n_layers}L) on {device} — {args.iters} "
          f"iterations, {args.workers} workers, GRPO group {args.group_size}")
    t0 = time.time()
    for it in range(args.iters):
        tasks = D.sample_tasks(args.tasks_per_iter, seed=args.seed * 10_000 + it)
        records = trainer.rollout(tasks)
        metrics = trainer.update(records)
        print(f"iter {it+1:4d}  reward {metrics['mean_reward']:.3f}  "
              f"loss {metrics['loss']:+.4f}  kl {metrics['approx_kl']:+.4f}  "
              f"({time.time()-t0:5.1f}s)", flush=True)
        if args.checkpoint_dir and (it + 1) % args.checkpoint_every == 0:
            path = f"{args.checkpoint_dir}/step{it+1}"
            ckpt.save(path, trainer.params, step=it + 1)
            print(f"  checkpoint -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
