"""The worker's decode graph on the CPU: who takes it, ``pos`` in place, and
the graphed decode's bookkeeping.

A worker on one card replays its decode step as a CUDA graph
(``engine/worker.py::_StepGraph``); the CPU and tensor-parallel workers run
the eager loop.  The card's own test is ``tests/test_torch_gpu.py``.  Here:

  * a CPU worker never captures, and reports both graph counters at 0;
  * ``decode_step`` advances ``pos`` in place, live lanes only, and leaves
    every leaf of the pool the tensor it was (a graph reads and writes the
    same memory at every replay);
  * the graphed decode on a stand-in graph, which holds the pool and params
    tensors as they were at its capture and replays by running the step on
    them: the tokens and counters of ``tests/_torch_graph.py``'s script match
    the eager loop's, so the buffers carry ``last``, ``live`` and the stop
    token from step to step and call to call, and every replacement of a
    tensor the graph reads (block growth, lane growth, a weight swap) makes
    a new capture.
"""

from types import SimpleNamespace

import pytest
import torch

import _torch_graph as G
from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.engine import worker as W
from repro_torch.models import model as M

pytestmark = pytest.mark.usefixtures("one_torch_thread")

def _tree_copy(tree):
    """The same tensors in new dicts: what a graph holds is the tensors."""
    if isinstance(tree, dict):
        return {k: _tree_copy(v) for k, v in tree.items()}
    return tree


def _stand_in_capture(self, cfg, params, pool, sampler):
    """``_StepGraph.capture`` without a card: the step once, then a graph
    whose replay runs the step on the tensors the capture saw."""
    params, pool = _tree_copy(params), _tree_copy(pool)
    self.run(cfg, params, pool, sampler)
    self.graph = SimpleNamespace(replay=lambda: self.run(cfg, params, pool, sampler))
    self.stale = False


@pytest.mark.parametrize("name", list(G.PLANES))
def test_cpu_worker_never_captures(name):
    cfg, plane = G.plane(name)
    params = M.init_params(cfg, seed=0, device="cpu")
    w = G.worker(cfg, params, "cpu", graphed=True, **plane)
    assert w._graph is None
    w.prefill(1, G.PROMPT)
    w.decode([1], 5)
    stats = w.dispatch_stats()
    assert stats["decode_steps"] == 5
    assert stats["decode_graph_steps"] == 0 and stats["decode_graph_captures"] == 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "all-live"])
def test_decode_step_advances_pos_in_place(paged, masked):
    """``pos`` stays the pool's tensor, advanced by one on live lanes only;
    no leaf of the pool is replaced."""
    cfg = get_config("qwen3_1_7b").reduced(n_periods=2)
    params = M.init_params(cfg, seed=0, device="cpu")
    pool = (M.init_paged_pool(cfg, 4, 9, 8, 8, "cpu") if paged
            else M.init_cache(cfg, 4, 64, "cpu"))
    pool["pos"].copy_(torch.tensor([3, 5, 0, 7], dtype=torch.int32))
    leaves = {id(t) for t in M.tree_leaves(pool)}
    pos = pool["pos"]
    active = torch.tensor([True, False, True, False]) if masked else None
    _, out = M.decode_step(cfg, params, pool, torch.tensor([[4], [5], [6], [7]]),
                           active=active)
    assert out is pool and pool["pos"] is pos
    assert {id(t) for t in M.tree_leaves(pool)} == leaves
    want = [4, 5, 1, 7] if masked else [4, 6, 1, 8]
    assert pos.tolist() == want


@pytest.mark.parametrize("name", list(G.PLANES))
def test_graphed_decode_matches_eager_loop_on_a_stand_in_graph(name, monkeypatch):
    cfg, plane = G.plane(name)
    params = M.init_params(cfg, seed=0, device="cpu")
    params2 = M.init_params(cfg, seed=1, device="cpu")
    stop = G.probe_stop(cfg, params, params2, "cpu", **plane)
    eager_out, eager_stats, _ = G.run(G.worker(cfg, params, "cpu", graphed=False, **plane),
                                      params2, stop)
    monkeypatch.setattr(W._StepGraph, "capture", _stand_in_capture)
    w = G.worker(cfg, params, "cpu", graphed=True, **plane)
    w._graph = W._StepGraph(w.device)   # the card's path, on the stand-in graph
    out, stats, captures = G.run(w, params2, stop)
    assert out == eager_out
    assert out[G.STOP_CALL][3][-1] == stop
    assert {k: v for k, v in stats.items() if k not in G.UNCOMPARED} == \
        {k: v for k, v in eager_stats.items() if k not in G.UNCOMPARED}
    assert stats["decode_graph_captures"] == captures >= 3
    assert stats["decode_graph_steps"] + captures == stats["decode_steps"]
    assert stats["pool_grows"] == 1
    if plane.get("paged", True):
        assert stats["block_grows"] >= 1
    # the stop call ran one chunk of the 12 steps asked for
    assert stats["decode_steps"] == 1 + 3 + 8 + W._DECODE_CHUNK + 5 + 4 + 2 + 3


def test_stale_graph_fails_the_stand_in_check(monkeypatch):
    """Without the capture that a weight swap makes, the stand-in graph
    decodes on the old weights: its tokens match the eager loop's up to the
    swap and differ after it, so the check above sees a missed invalidation.
    (On the dense plane the lane growth needs new input buffers, which
    capture anew of themselves.)"""
    cfg, plane = G.plane("qwen3-dense")
    params = M.init_params(cfg, seed=0, device="cpu")
    params2 = M.init_params(cfg, seed=1, device="cpu")
    eager_out, _, _ = G.run(G.worker(cfg, params, "cpu", graphed=False, **plane), params2)
    monkeypatch.setattr(W._StepGraph, "capture", _stand_in_capture)
    monkeypatch.setattr(W.RolloutWorker, "_stale_graph", lambda self: None)
    w = G.worker(cfg, params, "cpu", graphed=True, **plane)
    w._graph = W._StepGraph(w.device)
    out, stats, _ = G.run(w, params2)
    assert stats["decode_graph_captures"] == 2
    swap = 6                                      # the first call after the swap
    assert out[:swap] == eager_out[:swap]
    assert out[swap] != eager_out[swap]
