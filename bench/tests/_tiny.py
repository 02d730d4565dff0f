"""A cell of BENCHMARK.json shrunk to run on the CPU in seconds: the same
files, mixes and metrics, with the model's widths, the batch and the
lengths cut.  Test scaffolding only: the benchmark never runs at this size."""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


def spec(cell: str) -> dict:
    import torch
    from bench import run
    # a few threads: several test workers share the host, and the windows
    # are measured in seconds
    torch.set_num_threads(2)
    out = run.cell_spec(json.loads((ROOT / "BENCHMARK.json").read_text()), cell)
    cfg = out["cfg_file"]["model"]
    cfg.update(d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab=512,
               moe_d_ff=64, n_periods=2 if cfg["n_experts"] == 0 else 1)
    out["cfg_file"]["serve"]["num_blocks"] = 2000
    mix = out["mix"]
    # logits at this width are a fifth of the full model's: a fifth of the
    # temperature gives the Gumbel draw the full size's contrast
    mix["sampler"]["temperature"] = 0.2
    mix.update(capacity=1024, n_prompts=2, group_size=4)
    if mix["plan"] == "agentic":
        mix.update(system_prompt_tokens=64, gen_scale=0.02, history_prompts=4)
        mix["tool"]["output_tokens_mean"] = 8
        mix["runtime"].update(chunk_size=32, max_active=4)
    else:
        mix["prompt_tokens"]["uniform"] = [20, 60]
        mix["output_tokens"].update(median=60, max=200)
        mix["runtime"].update(max_active=8)
    # at this width and temperature the bf16 program read widest gaps of at
    # most 0.011 and mean gaps of at most 7e-5 (seeds 1, 2, 3, 11 of each
    # cell); a broken path reads far more
    limits = out["limits"]
    for key, tiny in (("served_gap", 0.05), ("mean_gap", 0.005)):
        if limits.get(key) is not None:
            limits[key] = tiny
    limits.update(min_tokens=10)
    return out
