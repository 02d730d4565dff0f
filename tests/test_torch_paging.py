"""The port's copy of PagePool, run through the cases of tests/test_paging.py
side by side with the JAX package's, plus the port's conservation check."""

import pytest

from repro.analysis.sanitize import check_block_conservation as jax_check
from repro.engine import paging as jax_paging
from repro_torch.engine import paging
from repro_torch.engine.paging import PagePool, PagePoolExhausted, check_block_conservation


def _scratch_reserved_and_lowest_first(mod):
    p = mod.PagePool(8)
    out = [p.alloc(3)]                             # block 0 never handed out
    p.free([2])
    out.append(p.alloc(2))                         # min-heap: lowest id first
    return out


def _share_and_free_refcounts(mod):
    p = mod.PagePool(8)
    blocks = p.alloc(2)
    p.share(blocks)
    out = [p.refcount(blocks[0]), p.shared_refs, p.free(blocks), p.free(blocks)]
    return out + [p.resident_blocks, p.free_blocks]


def _exhaustion_and_grow(mod):
    p = mod.PagePool(4)
    p.alloc(3)
    with pytest.raises(mod.PagePoolExhausted):
        p.alloc(1)
    p.grow(6)
    out = p.alloc(2)
    with pytest.raises(ValueError):
        p.grow(2)                                  # cannot shrink
    return out


def _conservation_stats(mod):
    p = mod.PagePool(16)
    a = p.alloc(4)
    p.share(a[:2])
    p.free(a[3:])
    return p.stats()


@pytest.mark.parametrize("case,want", [
    (_scratch_reserved_and_lowest_first, [[1, 2, 3], [2, 4]]),
    (_share_and_free_refcounts, [2, 2, [], [1, 2], 0, 7]),
    (_exhaustion_and_grow, [4, 5]),
    (_conservation_stats, None),
])
def test_pagepool_cases_match_jax(case, want):
    got = case(paging)
    assert got == case(jax_paging)
    if want is not None:
        assert got == want


def test_pagepool_misuse_raises():
    p = PagePool(4)
    with pytest.raises(ValueError):
        p.free([1])                                # never allocated
    with pytest.raises(ValueError):
        p.share([2])
    with pytest.raises(ValueError):
        PagePool(1)                                # scratch needs a companion
    assert issubclass(PagePoolExhausted, RuntimeError)


def test_conservation_check_agrees_with_sanitizer():
    p = PagePool(16)
    a = p.alloc(4)
    p.share(a[:2])
    p.free(a[3:])
    stats = {"blocks_" + k: v for k, v in p.stats().items()}
    assert check_block_conservation(stats) == [] == jax_check({0: stats})
    leak = dict(stats, blocks_freed_total=stats["blocks_freed_total"] - 1)
    assert any("leak" in v for v in check_block_conservation(leak))
    assert jax_check({0: leak})
    broken = dict(stats, blocks_free=stats["blocks_free"] - 1)
    assert any("partition" in v for v in check_block_conservation(broken))
    assert check_block_conservation({"decode_steps": 1}) == []
