"""Model FLOPs of the window's tokens over the window at the card's bf16
peak: every generated token (with the head), admitted and absorbed token
(without it), each at its own context, MoE at its top-k experts
(``bench/flops.py``)."""

from bench.flops import PEAKS


def read(run):
    if not run.trace or not run.model_flops:
        return None
    return 100.0 * run.model_flops / (run.window_s * PEAKS["bf16_flops_per_s"])
