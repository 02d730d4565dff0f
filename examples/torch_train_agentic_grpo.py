"""End-to-end driver on the PyTorch port: agentic GRPO training with
Heddle-orchestrated rollout.

A real (reduced) llama-family model learns a tool-use task: the agent must call a
calculator tool (emitting TOOL_CALL) and then produce the answer token the tool
returned.  Every training step runs the paper's full cycle:

  rollout  — trajectories generated on real RolloutWorkers under the unified
             orchestrator (prefill, batched decode through the paged decode kernel
             on the card, tool interrupts absorbed via incremental cache extension;
             presorted-DP placement, PPS queues with preemptive execution,
             progressive prediction refresh, tool-interval migration);
  inference — old-policy logprobs (fused chunked cross-entropy);
  training  — GRPO update (group-relative advantages, clipped ratio).

Run:  PYTHONPATH=src python examples/torch_train_agentic_grpo.py [--iters 30]
      PYTHONPATH=src python examples/torch_train_agentic_grpo.py --device cpu --iters 2
(Use --iters 300 for a longer run; reward climbs as the policy discovers the tool.)
"""

import argparse
import time

import repro_torch.rl.data as D
from repro_torch.configs import get_config
from repro_torch.rl.loop import HeddleTrainer, TrainerConfig


def main(argv=None) -> dict:
    """Train; returns each iteration's reward and loss and the rollouts'
    scheduling counts."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--group-size", type=int, default=8)
    ap.add_argument("--tasks-per-iter", type=int, default=4)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced(n_periods=2)
    print(f"model: {cfg.name} (reduced: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab})")
    trainer = HeddleTrainer(cfg, TrainerConfig(
        group_size=args.group_size, n_workers=2, max_steps_per_traj=3,
        gen_tokens_per_step=8, lr=8e-4, seed=0), device=args.device)

    window, losses, migrations, preemptions = [], [], 0, 0
    t0 = time.perf_counter()
    for it in range(args.iters):
        tasks = D.sample_tasks(args.tasks_per_iter, seed=1_000 + it)
        records = trainer.rollout(tasks)
        metrics = trainer.update(records)
        window.append(metrics["mean_reward"])
        losses.append(float(metrics["loss"]))
        ro = trainer.last_rollout
        migrations += ro.migrations
        preemptions += ro.preemptions
        if (it + 1) % 5 == 0 or it == 0:
            avg = sum(window[-10:]) / len(window[-10:])
            tool_rate = sum(1 for r in records
                            if any(t == D.TOOL_CALL for t in r.tokens[r.prompt_len:])) \
                / len(records)
            print(f"iter {it+1:4d}  reward(ma10) {avg:5.3f}  "
                  f"tool-call rate {tool_rate:4.2f}  loss {metrics['loss']:+.4f}  "
                  f"sched[preempt {ro.preemptions} migr {ro.migrations} "
                  f"qdelay {ro.queue_delay_mean:.3f}s]  ({time.perf_counter()-t0:5.1f}s)")
    print("done.")
    return dict(device=str(trainer.device), rewards=window, losses=losses,
                migrations=migrations, preemptions=preemptions,
                decode_steps=sum(w.decode_steps for w in trainer.workers),
                n_layers=cfg.n_layers)


if __name__ == "__main__":
    main()
