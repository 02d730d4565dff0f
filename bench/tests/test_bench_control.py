"""The control at a size a test run holds: the fp8 reference in the
program's place comes out not correct where the bf16 program comes out
correct, under the same limits.

On the card the control runs at each cell's own size and limits
(``--control 1``, PERF.md gives its readings); here the widths are cut to
d 512 so that a seed takes seconds on the CPU, and the limits are set for
this width from its own readings (seeds 1 to 3): the qwen3 widest gap read
0.026-0.069 and its control 0.56-0.74; jamba's mean gap 0.0051-0.0169 and
its control 0.087-0.105."""

from __future__ import annotations

import pytest

from bench.tests import _tiny

# the number each cell compares at d 512, and its limit there
LIMITS = {"qwen3_8b.coding": ("served_gap", 0.2),
          "jamba_1period.reasoning": ("mean_gap", 0.04)}


@pytest.mark.parametrize("cell", sorted(LIMITS))
def test_the_control_fails_where_the_program_passes(cell):
    from bench import run
    key, limit = LIMITS[cell]
    for seed in (1, 2, 3):
        spec = _tiny.spec(cell)
        spec["cfg_file"]["model"].update(d_model=512, d_ff=1024, moe_d_ff=256, vocab=4096,
                                         n_heads=8, n_kv_heads=2, head_dim=64)
        spec["limits"][key] = limit
        result, lines = run.run_cell(spec, seed, 6.0, trace=False, device="cpu",
                                     control=True)
        assert result["checks"]["tokens_judged_at_least"]["value"] >= 100, lines
        assert result["program"]["correct"] is True, lines
        assert result["correct"] is False, lines
        assert result["checks"][key]["value"] > limit, lines
