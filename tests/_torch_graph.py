"""The decode-graph scenario shared by the CPU and card tests of a worker's
graphed decode step (``engine/worker.py::_StepGraph``).

``run`` drives one ``RolloutWorker`` through a script that exercises every
path of the graphed decode: a first call of one step (the capture's own
eager step), calls of 3 and 8 steps, a preempted (masked) lane, a stop token
that ends a call after its first chunk, the preempted lane resumed, the block
pool grown, the lane count doubled, a weight swap and a lane migrated out and
back in.  It returns the tokens of every call, the worker's
``dispatch_stats()`` and the number of captures the script should cause.

``stop_token`` comes from a probe: the same script run first with no stop
token, whose call of 12 steps on lane 3 gives its third token.
"""

from repro_torch.configs import get_config
from repro_torch.engine.worker import RolloutWorker

# the planes the script runs on: qwen3 paged, dense and on a sliding-window
# ring (admission by one forward, absorption a token a step), jamba paged
PLANES = {
    "qwen3-paged": ("qwen3_1_7b", {}),
    "qwen3-dense": ("qwen3_1_7b", dict(paged=False)),
    "qwen3-ring": ("qwen3_1_7b", dict(paged=False, window=16)),
    "jamba-paged": ("jamba_v0_1_52b", {}),
}
KW = dict(capacity=64, max_slots=4, page_size=8, chunk_size=8)
PROMPT = [3 + i for i in range(20)]
STOP_CALL = 3                       # the index of the stop-token call in the output
# not compared between an eager and a graphed worker
UNCOMPARED = {"decode_wall_s", "decode_graph_steps", "decode_graph_captures"}


def plane(name: str):
    """(config, worker keywords) of a plane: reduced widths, two qwen3
    periods or one jamba period; the ring is as wide as its window."""
    arch, kw = PLANES[name]
    kw = dict(kw)
    cfg = get_config(arch).reduced(n_periods=2 if arch.startswith("qwen") else 1)
    window = kw.pop("window", 0)
    if window:
        cfg = cfg.with_sliding_window(window)
        kw["capacity"] = window
    return cfg, kw


def worker(cfg, params, device, graphed: bool, **opts) -> RolloutWorker:
    """A worker of the scenario's shapes; ``graphed=False`` keeps the eager
    loop where the worker would take the graph.  A paged worker starts with
    8 blocks, so that decode coverage grows the block pool."""
    kw = dict(KW, device=device, **opts)
    if opts.get("paged", True):
        kw.setdefault("num_blocks", 8)
    w = RolloutWorker(cfg, params, **kw)
    if not graphed:
        w._graph = None
    return w


def run(w: RolloutWorker, params2, stop_token=None):
    """The script on ``w``: (outputs, dispatch_stats, expected captures).
    A call captures where it is the first, or where a block or lane growth
    or a weight swap came since the call before."""
    out = []
    captures = 0
    last_mark = None
    swaps = 0

    def decode(seq_ids, n, stop=None):
        nonlocal captures, last_mark
        out.append(w.decode(seq_ids, n, stop_token=stop))
        st = w.dispatch_stats()
        mark = (st.get("block_grows", 0), st["pool_grows"], swaps)
        captures += mark != last_mark
        last_mark = mark

    w.prefill(1, PROMPT)
    w.prefill(2, PROMPT)
    w.prefill(3, [7, 11, 13, 5, 2, 9, 40])
    decode([1, 2, 3], 1)
    decode([1, 2, 3], 3)
    w.extend(1, [101, 102, 103])
    w.preempt(2)
    decode([1, 3], 8)                              # lane 2 rides along masked
    decode([3], 12, stop_token)                    # STOP_CALL
    decode([2], 5)                                 # the preempted lane resumes
    for sid in range(4, 8):                        # lane growth: 4 -> 8 slots
        w.prefill(sid, [5 + sid] * (9 + sid))
    decode([1, 4, 5, 6, 7], 4)
    w.params = params2
    swaps += 1
    decode([4, 5], 2)
    w.migrate_in(w.migrate_out(6))
    decode([6, 7], 3)
    return out, w.dispatch_stats(), captures


def probe_stop(cfg, params, params2, device, **opts) -> int:
    """The stop token: lane 3's third token in the stop call, drawn with no
    stop token by an eager worker."""
    out, _, _ = run(worker(cfg, params, device, graphed=False, **opts), params2)
    return out[STOP_CALL][3][2]
