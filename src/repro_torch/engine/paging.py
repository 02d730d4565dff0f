"""Host-side block allocator for the paged KV pool (a copy of ``repro/engine/paging.py``).

The paged data plane splits every attention KV leaf into fixed-size **blocks**
of ``page_size`` token slots; a per-lane **page table** row maps logical page
index -> physical block id.  This module owns the host bookkeeping: which
blocks are free, who holds references to each block (prefix sharing is a
refcount bump, not a copy), and the occupancy telemetry the control plane and
the trace sanitizer consume.

Invariants:

* **Block 0 is reserved scratch.**  Unmapped page-table entries point at 0, so
  a masked/free lane's self-healing KV write lands in scratch instead of a
  resident block.  The allocator never hands block 0 out.
* **Determinism** — the free list is a min-heap, so allocation order is a pure
  function of the alloc/free history (lowest block id first), independent of
  dict/set iteration order.
* **Conservation** — every refcount increment is counted in ``allocated_total``
  and every decrement in ``freed_total``; at any instant
  ``allocated_total - freed_total == resident_blocks + shared_refs`` (live
  references = distinct blocks in use + extra shared references).
  ``check_block_conservation`` checks it from ``dispatch_stats``.
"""

from __future__ import annotations

import heapq


class PagePoolExhausted(RuntimeError):
    """No free blocks left (the caller grows the device pool, then retries)."""


class PagePool:
    """Refcounted block allocator over ``num_blocks`` device blocks.

    Blocks ``1 .. num_blocks-1`` are allocatable; block 0 is scratch.  A block
    with refcount 1 is **resident** (one owner); each additional reference is a
    **shared** ref (prefix sharing).  Freeing decrements; the block returns to
    the free heap only when its refcount reaches zero.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("PagePool needs >= 2 blocks (block 0 is scratch)")
        self.num_blocks = num_blocks
        self._free = list(range(1, num_blocks))        # already heap-ordered
        self._refs: dict[int, int] = {}                # block id -> refcount
        self.allocated_total = 0                       # cumulative ref increments
        self.freed_total = 0                           # cumulative ref decrements
        self.used_high_watermark = 0

    # ------------------------------------------------------------ queries
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def resident_blocks(self) -> int:
        """Distinct blocks holding at least one reference."""
        return len(self._refs)

    @property
    def shared_refs(self) -> int:
        """References beyond the first on each block (prefix-shared pages)."""
        return sum(self._refs.values()) - len(self._refs)

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    # ------------------------------------------------------------ alloc / share / free
    def alloc(self, n: int) -> list[int]:
        """Take ``n`` fresh blocks (refcount 1 each), lowest ids first."""
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} blocks, {len(self._free)} free of {self.num_blocks}")
        out = [heapq.heappop(self._free) for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        self.allocated_total += n
        self.used_high_watermark = max(self.used_high_watermark, len(self._refs))
        return out

    def share(self, blocks: list[int]) -> None:
        """Add one reference to each block (prefix sharing: no data moves)."""
        for b in blocks:
            if b not in self._refs:
                raise ValueError(f"share of unallocated block {b}")
            self._refs[b] += 1
        self.allocated_total += len(blocks)

    def free(self, blocks: list[int]) -> list[int]:
        """Drop one reference per block; returns the blocks that became free."""
        released = []
        for b in blocks:
            refs = self._refs.get(b, 0)
            if refs <= 0:
                raise ValueError(f"free of unallocated block {b}")
            if refs == 1:
                del self._refs[b]
                heapq.heappush(self._free, b)
                released.append(b)
            else:
                self._refs[b] = refs - 1
        self.freed_total += len(blocks)
        return released

    def grow(self, new_num_blocks: int) -> None:
        """Append blocks ``num_blocks .. new_num_blocks-1`` to the free heap
        (the caller has already grown the device-side pool to match)."""
        if new_num_blocks < self.num_blocks:
            raise ValueError("PagePool cannot shrink")
        for b in range(self.num_blocks, new_num_blocks):
            heapq.heappush(self._free, b)
        self.num_blocks = new_num_blocks

    # ------------------------------------------------------------ telemetry
    def stats(self) -> dict:
        """Occupancy counters (``dispatch_stats`` merges these under
        ``blocks_*`` keys; :func:`check_block_conservation` reads them)."""
        return {
            "total": self.num_blocks - 1,              # scratch excluded
            "free": self.free_blocks,
            "resident": self.resident_blocks,
            "shared": self.shared_refs,
            "allocated_total": self.allocated_total,
            "freed_total": self.freed_total,
            "used_high_watermark": self.used_high_watermark,
        }


def check_block_conservation(stats: dict) -> list[str]:
    """Block-conservation violations in one worker's ``dispatch_stats`` (empty if clean).

    Live references (allocated - freed) must equal resident blocks plus shared
    references, and resident + free must partition the allocatable blocks.
    """
    if "blocks_total" not in stats:
        return []
    out = []
    live = stats["blocks_allocated_total"] - stats["blocks_freed_total"]
    held = stats["blocks_resident"] + stats["blocks_shared"]
    if live != held:
        out.append(f"block leak: {live} live references != {held} held "
                   f"(resident {stats['blocks_resident']} + shared {stats['blocks_shared']})")
    if stats["blocks_resident"] + stats["blocks_free"] != stats["blocks_total"]:
        out.append(f"block partition broken: resident {stats['blocks_resident']} + "
                   f"free {stats['blocks_free']} != total {stats['blocks_total']}")
    return out
