"""``chip_smoke.py``'s counts on the CPU: the MoE routing of phase 14, the
per-card kernel calls and the host-copy counter of phase 17.

Phase 14 records each ``models.layers.moe`` call's top-k expert ids while
jamba's bf16 workers at degree 1 and 2 run (``_MoeRoutes``) and counts the
choices that differ (``_flips``).  Here the count is pinned on hand-made
choices, and the recorder runs on ``jamba_v0_1_52b.reduced(n_periods=1)``
workers on the CPU: a degree-2 worker's calls alternate shards that route
alike, and the recorder leaves the model's ``moe`` as it found it.
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.engine.sampler import SamplerConfig
from repro_torch.engine.worker import RolloutWorker
from repro_torch.launch.mesh import WorkerMesh
from repro_torch.models import layers
from repro_torch.models.model import init_params

from _torch_hold import load_chip_smoke
from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def cs():
    return load_chip_smoke()


def _t(rows):
    return torch.tensor(rows, dtype=torch.long)


@pytest.mark.parametrize("a, b, want", [
    ([[[0, 1], [2, 3]]], [[[0, 1], [2, 3]]], (2, 0, 4, 0)),
    ([[[0, 1], [2, 3]]], [[[0, 1], [2, 4]]], (2, 1, 4, 1)),      # one choice moved
    ([[[0, 1], [2, 3]]], [[[4, 5], [2, 3]]], (2, 1, 4, 2)),      # a token's whole set
    ([[[0, 1]], [[2, 3]]], [[[0, 2]], [[2, 3]]], (2, 1, 4, 1)),  # over two calls
], ids=["equal", "one-choice", "one-token", "two-calls"])
def test_flips_counts_tokens_and_choices(cs, a, b, want):
    got = cs._flips([_t(x) for x in a], [_t(x) for x in b])
    assert (got["tokens"], got["tokens_flipped"], got["choices"],
            got["choices_flipped"]) == want


def test_flips_refuse_calls_of_other_shapes(cs):
    with pytest.raises(AssertionError, match="shapes"):
        cs._flips([_t([[0, 1]])], [_t([[0, 1], [2, 3]])])


def test_moe_routes_record_each_shard(cs):
    """d1 and d2 jamba workers admit and decode alike; d2 records twice d1's
    calls, its two shards' choices are equal, and ``layers.moe`` is
    restored after each run."""
    cfg = get_config("jamba_v0_1_52b").reduced(n_periods=1)
    params = init_params(cfg, 0, "cpu")
    n_moe = sum(k.endswith("+moe") for k in cfg.block_pattern)
    original = layers.moe
    routes = {}
    for d in (1, 2):
        mesh = None if d == 1 else WorkerMesh((torch.device("cpu"),) * d)
        w = RolloutWorker(cfg, params, capacity=64, page_size=8, max_slots=2, mp=d, mesh=mesh,
                          sampler=SamplerConfig(temperature=0.0), device="cpu")
        with cs._MoeRoutes(torch, d) as routes[d]:
            w.prefill(0, list(range(3, 15)))
            w.decode([0], 3)
        assert layers.moe is original
    assert len(routes[1].calls) == n_moe * (1 + 3)
    assert len(routes[2].calls) == 2 * len(routes[1].calls)
    first = routes[1].shard(0)
    assert first[0].shape == (12, cfg.top_k) and first[-1].shape == (2, cfg.top_k)
    assert cs._flips(routes[2].shard(0), routes[2].shard(1))["choices_flipped"] == 0
    assert cs._flips(first, routes[2].shard(0))["choices"] == (12 + 3 * 2) * n_moe * cfg.top_k


def test_rounded_shards_equal_the_rounded_sharded_init(cs):
    """Phase 17's bf16 d2 jamba: the f32 draws rounded leaf by leaf and cut
    for the mesh are the f32 sharded init rounded in place (``_to_bf16``),
    the router, A_log and D kept in f32."""
    from dataclasses import replace
    from repro_torch.models import model as M
    cfg = replace(get_config("jamba_v0_1_52b").reduced(n_periods=2), dtype="float32")
    mesh = WorkerMesh((torch.device("cpu"),) * 2)
    got = cs._rounded_shards(torch, cfg, mesh)
    want = init_params(cfg, 0, mesh=mesh)
    for shard in want:
        cs._to_bf16(torch, shard)
    assert got.split == want.split
    for g, w in zip(got, want):
        gl, wl = list(M.tree_items(g)), list(M.tree_items(w))
        assert [p for p, _ in gl] == [p for p, _ in wl]
        for (path, a), (_, b) in zip(gl, wl):
            assert a.dtype == b.dtype and torch.equal(a, b), path
            assert (a.dtype == torch.float32) == (path.split("/")[-1] in cs.F32_LEAVES), path


class _OnCard:
    """A stand-in for a tensor on card ``index``."""

    def __init__(self, index):
        self.device = type("Device", (), {"index": index})()

    def clone(self):
        return self


def test_per_card_counts_calls_by_card_and_keeps_other_cards(cs):
    import types
    module = types.SimpleNamespace(kernel=lambda *args: len(args))
    with cs._PerCard(module, "kernel", keep=2) as card:
        for index in (0, 1, 1, 1, 3, 0):
            assert module.kernel(_OnCard(index), _OnCard(index)) == 2
    assert module.kernel(_OnCard(0)) == 1                   # restored
    assert card.counts == {0: 2, 1: 3, 3: 1}
    assert {c: len(k) for c, k in card.kept.items()} == {1: 2, 3: 1}
    assert card.take() == {0: 2, 1: 3, 3: 1} and card.counts == {}
    cs._per_card("x", {0: 4, 1: 4}, range(2), 4)
    with pytest.raises(AssertionError, match="by card"):
        cs._per_card("x", {0: 4, 1: 3}, range(2), 4)


def test_flips_at_d4_against_d2(cs):
    """Phase 17 counts jamba's flips between its bf16 d4 and d2 workers:
    both record a whole top-k set per token at each MoE layer, and d2's
    two shards route alike."""
    cfg = get_config("jamba_v0_1_52b").reduced(n_periods=1)
    params = init_params(cfg, 0, "cpu")
    routes = {}
    for d in (4, 2):
        mesh = WorkerMesh((torch.device("cpu"),) * d)
        w = RolloutWorker(cfg, params, capacity=64, page_size=8, max_slots=2, mp=d, mesh=mesh,
                          sampler=SamplerConfig(temperature=0.0), device="cpu")
        with cs._MoeRoutes(torch, d) as routes[d]:
            w.prefill(0, list(range(3, 15)))
            w.decode([0], 3)
    # one admission; the first decode step stands where phase 17's teacher-forced step does
    flips = cs._log_flips(cfg, 1, routes[4], routes[2], names=("d4", "d2"), tag="cards")
    assert set(flips) == {"admissions", "teacher-forced", "decode", "d2 shards"}
    assert flips["d2 shards"]["choices_flipped"] == 0
    n_moe = sum(k.endswith("+moe") for k in cfg.block_pattern)
    assert sum(f["tokens"] for k, f in flips.items() if k != "d2 shards") == (12 + 3 * 2) * n_moe


def _dispatch_modes():
    return torch._C._len_torch_dispatch_stack()


def test_host_copies_count_nothing_on_the_cpu(cs):
    """Phase 17(d)'s counter: a function that copies, reads scalars, masks
    and compares on the CPU only counts nothing; each function gets its own list and runs
    under the mode, which is gone after the last one returns."""
    x = torch.arange(6.0)
    inside = []

    def work():
        inside.append(_dispatch_modes())
        y = x.cpu().clone().add_(1)
        torch.zeros(3).copy_(y[:3])
        y[y > 4] = 0.0
        return (y.sum().item(), y.tolist(), int(y[0]), bool(y[1]), y[y > 1], y.nonzero(),
                torch.equal(y, x), torch.unique(y))

    assert cs._host_copies(torch, work, work) == [[], []]
    assert inside == [1, 1] and _dispatch_modes() == 0


def test_host_copies_pop_the_mode_when_a_function_raises(cs):
    def boom():
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        cs._host_copies(torch, lambda: None, boom)
    assert _dispatch_modes() == 0
