"""Serving demo on the PyTorch port: batched agentic requests on the real data plane,
with Heddle's mechanisms visible — prefix-cache prefill, batched continuous decode
(the paged decode kernel on the card), a tool interval absorbed without prefix
recompute, preemption persistence and live KV migration between two workers.

Run:  PYTHONPATH=src python examples/torch_serve_rollout.py              # on the card
      PYTHONPATH=src python examples/torch_serve_rollout.py --device cpu
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.engine.sampler import SamplerConfig
from repro_torch.engine.worker import RolloutWorker
from repro_torch.models import model as M


def _clock(device) -> float:
    """The host clock once the card has finished what was enqueued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def main(argv=None, params=None) -> dict:
    """Run the demo; returns its tokens and counts.  ``params`` (the reduced
    qwen3's weights on the device) replaces the ones drawn from seed 0."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("qwen3_1_7b").reduced(n_periods=2)
    if params is None:
        params = M.init_params(cfg, 0, device)
    w0 = RolloutWorker(cfg, params, capacity=128, max_slots=8, worker_id=0,
                       sampler=SamplerConfig(temperature=0.8, top_p=0.9), device=device)
    w1 = RolloutWorker(cfg, params, capacity=128, max_slots=8, worker_id=1,
                       sampler=SamplerConfig(temperature=0.8, top_p=0.9), device=device)
    print(f"2 workers serving {cfg.name} (reduced), "
          f"slot pools of {w0.max_slots} lanes x 128 KV slots")

    # batched request admission (prefill)
    requests = {i: [5 + i, 7, 9, 11 + i] for i in range(6)}
    t0 = _clock(device)
    for rid, prompt in requests.items():
        w0.prefill(rid, prompt)
    print(f"prefilled {len(requests)} requests on w0 in {_clock(device)-t0:.2f}s "
          f"(prefix-cache hits: {w0.prefix_index.hits})")

    # batched continuous decode (per-slot positions differ)
    t0 = _clock(device)
    out = w0.decode(list(requests), 12)
    n = sum(len(v) for v in out.values())
    print(f"decoded {n} tokens across {len(requests)} slots in {_clock(device)-t0:.2f}s")

    # a tool call returns for request 0: absorb output without prefix recompute
    w0.extend(0, [201, 202, 203])
    print(f"request 0: tool output absorbed (context now {len(w0.store[0].tokens)} "
          f"tokens, kv {w0.kv_bytes(0)/2**20:.1f} MiB)")

    # preemption: a mask flip — request 5 leaves the decode batch, its lane stays put
    w0.preempt(5)
    print("request 5 preempted (mask flip, KV lane persisted) — resumes without recompute")

    # opportunistic migration: request 0 moves to w1 during its tool interval
    t0 = _clock(device)
    pkg = w0.migrate_out(0)
    w1.migrate_in(pkg)
    print(f"request 0 migrated w0 -> w1 in {_clock(device)-t0:.3f}s; continuing there:")
    more = w1.decode([0], 6)
    print(f"  w1 decoded {more[0]}")
    resumed = w0.decode([5], 6)
    print(f"  w0 resumed preempted request 5: {resumed[5]}")
    return dict(device=str(device), tokens=out, decoded=n, context=len(w1.store[0].tokens),
                migrated=0 in w1.store and 0 not in w0.store, w1_tokens=more[0],
                resumed=resumed[5], decode_steps=w0.decode_steps + w1.decode_steps,
                n_layers=cfg.n_layers)


if __name__ == "__main__":
    main()
