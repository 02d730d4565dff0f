"""The 95th percentile over every token generated in the window of its
per-token time: a decode call that emitted k tokens of a step gives each
(its end - the step's previous stamp) / k, where the step's first stamp is
the moment it became runnable (the batch's start, or the end of the
absorption of the previous tool output).  So queueing behind the scheduler's
slots, preemption, other lanes' admissions and absorptions in between, and
the steps themselves all count."""

from bench.harness import weighted_quantile


def read(run):
    return 1e3 * weighted_quantile(run.tpot, 0.95) if run.tpot else None
