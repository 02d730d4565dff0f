"""The paged decode kernel's share of its roofline over the window: the sum
of each launch's least time (the bytes the live lanes need, shared pages
once, at the HBM rate: ``flops.paged_decode_bytes``) over the sum of the
launches' device time in the trace."""

from bench.flops import PEAKS
from bench.harness import DECODE_KERNEL


def read(run):
    k = run.device.get("kernels", {}).get(DECODE_KERNEL)
    if not k or not k["launches"]:
        return None
    launches = sum(n for n, _ in run.decode_bytes)
    if launches != k["launches"]:
        raise RuntimeError(f"{k['launches']} paged decode launches in the trace, "
                           f"{launches} counted by the harness")
    bound = sum(n * b for n, b in run.decode_bytes) / PEAKS["hbm_bytes_per_s"]
    return 100.0 * bound / k["seconds"]
