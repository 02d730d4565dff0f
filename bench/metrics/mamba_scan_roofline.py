"""The selective-scan kernel's share of its roofline over the window: each
whole-prompt admission's scans' least time (``flops.scan_bound_s``, one a
Mamba layer) summed, over the launches' device time in the trace."""

from bench.flops import scan_bound_s
from bench.harness import SCAN_KERNEL


def read(run):
    k = run.device.get("kernels", {}).get(SCAN_KERNEL)
    if not k or not k["launches"]:
        return None
    if k["launches"] != run.n_scan_layers * len(run.scan_tokens):
        raise RuntimeError(f"{k['launches']} scan launches in the trace, "
                           f"{run.n_scan_layers * len(run.scan_tokens)} expected")
    bound = run.n_scan_layers * sum(scan_bound_s(run.cfg, 1, s) for s in run.scan_tokens)
    return 100.0 * bound / k["seconds"]
