"""The worker's own decode clock over the window: ``decode_wall_s`` over
``decode_timed_steps`` of ``RolloutWorker.dispatch_stats()``, in ms a step."""


def read(run):
    steps = run.stats.get("decode_timed_steps", 0)
    return 1e3 * run.stats["decode_wall_s"] / steps if steps else None
