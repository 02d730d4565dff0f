"""The yardstick's arithmetic against hand counts, and the traffic's sizes."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from bench.tests import _tiny
from bench import flops, harness, traffic

QWEN = json.loads((_tiny.ROOT / "bench/configs/qwen3_8b.json").read_text())["model"]
JAMBA = json.loads((_tiny.ROOT / "bench/configs/jamba_1period.json").read_text())["model"]


def test_qwen3_token_flops_by_hand():
    d, f, v = 4096, 12288, 151936
    proj = 2 * d * (32 + 16) * 128 + 2 * 32 * 128 * d          # q, k, v, o
    mlp = 3 * 2 * d * f
    ctx = 1000
    want = 36 * (proj + mlp + 4 * 32 * 128 * ctx) + 2 * d * v
    assert flops.token_flops(QWEN, ctx, head=True) == want
    # 2 x the 8.19 B params less the embedding table a token, at a short context
    assert flops.token_flops(QWEN, 1, head=True) == pytest.approx(
        2 * (8.19e9 - v * d), rel=0.01)


def test_jamba_moe_at_top_k():
    d, f, E = 4096, 14336, 16
    assert flops.moe_flops(JAMBA) == 2 * d * E + 2 * 3 * 2 * d * f
    mamba = 2 * 2 * d * 8192 + 2 * 4 * 8192 + 2 * 8192 * (256 + 32) + 2 * 256 * 8192 \
        + 10 * 8192 * 16 + 2 * 8192 * d
    assert flops.mamba_flops(JAMBA) == mamba


def test_span_flops_sums_each_position():
    want = sum(flops.token_flops(QWEN, p + 1, head=False) for p in range(100, 140))
    assert flops.span_flops(QWEN, 100, 140) == pytest.approx(want, rel=1e-12)


def test_paged_bytes_by_hand():
    # 10 distinct pages of 16 tokens, K and V, 8 kv heads of 128 in bf16; 3 lanes' q, out
    want = 2 * 10 * 16 * 8 * 128 * 2 + 2 * 3 * 32 * 128 * 2
    assert flops.paged_decode_bytes(QWEN, 10, 3, 16) == want


def test_shared_pages_count_once():
    """Two lanes sharing 4 prefix pages, each with its own tail: per step
    the distinct pages, the new tail page counted when a lane crosses it."""
    class W:
        page_size = 16
        lane_pages = {0: [1, 2, 3, 4, 5, 6], 1: [1, 2, 3, 4, 7, 8]}

    h = harness.Harness.__new__(harness.Harness)
    h.worker, h.cfg = W(), QWEN
    h.run_rec = harness.Run(QWEN, True)
    h.lanes = {10: harness.Lane(10, None, slot=0), 11: harness.Lane(11, None, slot=1)}
    # lane 10 feeds positions 70..73 (valid 71..74: 5 pages), lane 11 positions 78..79
    h._decode_counts([(10, 70, 4), (11, 78, 2)])
    got = [b for _, b in h.run_rec.decode_bytes]
    # step 0: lane 10 pages {1..5}, lane 11 valid 79 tokens -> {1,2,3,4,7}: 6 distinct
    # step 1: lane 11 valid 80 -> 5 pages, same; lane 10 valid 72 -> 5 pages: 6 distinct
    # step 2, 3: lane 10 alone, 5 pages
    want = [flops.paged_decode_bytes(QWEN, n, live, 16)
            for n, live in ((6, 2), (6, 2), (5, 1), (5, 1))]
    assert got == want
    assert all(n == 36 for n, _ in h.run_rec.decode_bytes)


def test_scan_bound_by_hand():
    S = 2048
    nbytes = S * 8192 * (4 + 2 + 4) + 2 * S * 16 * 2 + 8192 * 16 * 4 + 8192 * 16 * 4
    exps = S * 8192 * 16
    want = max(nbytes / 3.35e12, exps / 4.18176e12, 6 * exps / 67e12)
    assert flops.scan_bound_s(JAMBA, 1, S) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(0.0642e-3, rel=0.01)      # chip_smoke.py's 0.0642 ms


def test_weighted_quantile():
    samples = [(1.0, 90), (5.0, 5), (9.0, 5)]
    assert harness.weighted_quantile(samples, 0.95) == 5.0
    assert harness.weighted_quantile([(2.0, 1)], 0.95) == 2.0
    assert harness.weighted_quantile(samples, 0.5) == 1.0


@pytest.mark.parametrize("mix", ["coding", "reasoning"])
def test_every_seed_gets_the_same_sizes(mix):
    m = traffic.load_mix(mix)
    a, b = traffic.make_batch(m, 1, 0, 1000), traffic.make_batch(m, 2**31 + 5, 0, 1000)
    sizes = lambda reqs: [(len(r.prompt), tuple(r.plan.gen), tuple(r.plan.tool_out))
                          for r in reqs]
    assert sizes(a) == sizes(b)
    assert [r.prompt for r in a] != [r.prompt for r in b]
    for reqs in (a, b):
        for r in reqs:
            assert len(r.prompt) + sum(r.plan.gen) + sum(r.plan.tool_out) <= m["capacity"]
            assert [len(t) for t in r.tool_ids] == r.plan.tool_out
        groups = {}
        for r in reqs:
            groups.setdefault(r.group, set()).add(tuple(r.prompt))
        assert all(len(p) == 1 for p in groups.values())     # a group shares its prompt


def test_coding_shares_the_system_prompt():
    m = traffic.load_mix("coding")
    reqs = traffic.make_batch(m, 9, 0, 1000)
    heads = {tuple(r.prompt[:m["system_prompt_tokens"]]) for r in reqs}
    assert len(heads) == 1 and len(reqs) == 64


def test_reasoning_lengths():
    m = traffic.load_mix("reasoning")
    reqs = traffic.make_batch(m, 9, 0, 1000)
    gen = np.array([r.plan.gen[0] for r in reqs])
    assert len(reqs) == 128 and all(len(r.plan.gen) == 1 for r in reqs)
    lengths = [len(r.prompt) for r in reqs]
    assert 256 <= min(lengths) and max(lengths) <= 2048
    assert gen.max() <= 8192 and 1400 < np.median(gen) < 2800


def test_the_gumbel_noise_is_the_samplers():
    """The reference's Threefry noise is bit-equal to the port's sampler's."""
    from repro_torch.engine import prng
    from bench.reference import gumbel
    seed, ids, pos = 3_000_000_019, torch.tensor([5, 70000]), torch.tensor([17, 4096])
    got = gumbel.step_noise(seed, 0, ids, pos, 1000)
    lane = prng.fold_in(prng.prng_key(seed).expand(2, 2), ids)
    want = torch.stack([prng.gumbel(prng.fold_in(lane[i], pos[i]), 1000) for i in range(2)])
    assert torch.equal(got, want)
    math.isfinite(float(got.max()))
