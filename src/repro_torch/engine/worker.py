"""Rollout worker: the port's data plane (counterpart of ``repro/engine/worker.py``).

The worker owns one KV pool, of one of two layouts:

  * **paged** (``model.init_paged_pool``): physical blocks of ``page_size``
    token slots shared by every lane, a page table per lane, and a host-side
    ``PagePool`` that allocates, shares and frees blocks.  The radix cache
    shares a matched prefix's full pages by refcount and copies the boundary
    page; the decode kernel reads through the page table.
  * **dense** (``model.init_cache``): a slot pool of ``max_slots`` lanes of
    ``capacity`` slots each, a ring with a sliding window.  The radix cache
    copies a matched prefix lane to lane; a full pool doubles.  The dense
    decode kernel reads each lane directly.

Recurrent state (Mamba, mLSTM, sLSTM) is dense per lane on both layouts,
and a lane starts from a fresh state at every admission.

  * admission: chunked prefill of the suffix the radix cache cannot reuse,
    or one full-sequence forward where chunked prefill does not apply (MoE);
  * decode: a masked step loop over the whole pool; every step of every
    attention layer calls a decode attention kernel.  A worker on one card
    replays the step as one CUDA graph (``_StepGraph``);
  * preemption: a mask flip -- the lane stays resident, nothing moves;
  * migration: the lane's KV and recurrent state move device to device,
    between layouts too, and between MP degrees (below);
  * tool absorption: chunked prefill at the lane's current offset, or one
    masked decode step per token.

Sampling is per lane: a sequence's key is ``fold_in(PRNGKey(seed + worker_id),
seq_id)``, and each decode step draws with ``fold_in(key, pos)``
(``engine.prng`` reproduces ``jax.random`` bit for bit), so a lane's random
stream is independent of co-resident lanes and stable across preemption and
migration (the key travels in the migration package).  Its logits are too,
except under MoE: lanes of one step share each expert's capacity.

A worker of MP degree ``d`` built on a mesh of ``d`` shards
(``launch.mesh.WorkerMesh``) holds one params tree and one pool per shard,
cut by ``distributed.sharding.tp_split``: 1/d of the attention heads, of
``d_ff``, of the vocabulary, of Mamba's ``d_inner``, of the xLSTM's heads,
of the MoE experts and of the shared / dense-residual width, and 1/d of the
kv heads of every K/V block, of the channels of every Mamba state and of
the heads of every xLSTM state, on each shard's device.  The page table and
``pos`` are replicated on every shard; the ``PagePool`` bookkeeping is the
worker's one copy.  A sharded worker admits by chunks or, where chunked
prefill does not apply (MoE, a ring), by one full forward on its mesh.  A
migration package holds the full layout on the source's device 0 (the
shards gathered there card to card), whatever the source's degree, and
``migrate_in`` cuts it for the destination's mesh, each piece copied
straight to its card; a checkpoint package is the same copied to the host.
The shards of a mesh may share one device or lie on distinct cards.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (ShardedParams, gather_cache, shard_cache,
                                              shard_config, shard_params, tp_split)
from repro_torch.engine import prng
from repro_torch.engine.paging import PagePool, PagePoolExhausted
from repro_torch.engine.sampler import SamplerConfig, sample_slots
from repro_torch.engine.tracing import Tracer, traced
from repro_torch.kernels import decode_attention, mamba_scan
from repro_torch.launch.mesh import WorkerMesh
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------- radix cache
# (a copy of repro/engine/worker.py's PrefixCacheIndex: pure Python)

class _TrieNode:
    __slots__ = ("children", "refs", "last_used")

    def __init__(self):
        self.children: dict[int, _TrieNode] = {}
        self.refs: dict[int, int] = {}       # lane slot -> epoch at insert
        self.last_used = 0


class PrefixCacheIndex:
    """Radix cache over token prefixes: accounting trie + (lane, span) KV refs.

    Accounting: every ``match_len``/``match_lane`` counts a lookup and classifies it
    as a **full** hit (the whole query matched) or a **partial** hit (a nonzero
    proper prefix matched) — ``hits`` aggregates both, so controller affinity stats
    can consume the honest split.  Node count is bounded by ``max_nodes``: inserts
    past the cap first prune the least-recently-used subtrees (a parent is always at
    least as recent as its children, so pruning by timestamp cutoff removes whole
    cold subtrees) and then truncate, keeping memory bounded even in pure
    accounting mode.

    KV ownership: ``insert(tokens, slot=...)`` tags every node on the path with a
    ``(slot, epoch)`` ref, claiming that lane ``slot`` holds valid KV for this
    prefix at positions ``[0, depth)``.  ``invalidate(slot)`` bumps the slot's epoch
    (lane overwritten / evicted); stale refs are dropped lazily during matching.
    ``match_lane`` returns the deepest live ref, which the engine implants with an
    on-device lane-slice copy so only the unmatched suffix is prefilled.

    ``tracer`` times the walks (``radix.match``, ``radix.insert``,
    ``radix.prune``) and counts ``radix.nodes`` (its largest node count),
    ``radix.prunes``, ``radix.pruned_nodes`` and ``radix.tokens_walked``
    (tokens handed to inserts and lookups).
    """

    def __init__(self, max_nodes: int = 65_536, tracer: Tracer | None = None):
        self.root = _TrieNode()
        self.max_nodes = max_nodes
        self.tracer = tracer if tracer is not None else Tracer()
        self.node_count = 0                  # root excluded
        self._clock = 0
        self._epochs: dict[int, int] = {}
        self.lookups = 0
        self.full_hits = 0
        self.partial_hits = 0
        self.hit_tokens = 0

    @property
    def hits(self) -> int:
        return self.full_hits + self.partial_hits

    def invalidate(self, slot: int) -> None:
        """Mark lane ``slot``'s KV refs stale (lane reassigned or evicted)."""
        self._epochs[slot] = self._epochs.get(slot, 0) + 1

    # ------------------------------------------------------------ insert / match
    @traced("radix.insert")
    def insert(self, tokens: list[int], slot: int | None = None) -> None:
        self.tracer.add("radix.tokens_walked", len(tokens))
        self._clock += 1
        now = self._clock
        epoch = self._epochs.setdefault(slot, 0) if slot is not None else 0
        node = self.root
        node.last_used = now
        for t in tokens:
            child = node.children.get(int(t))
            if child is None:
                if self.node_count >= self.max_nodes:
                    self._prune()
                if self.node_count >= self.max_nodes:
                    break                    # cap still binding: truncate the insert
                child = _TrieNode()
                node.children[int(t)] = child
                self.node_count += 1
            child.last_used = now
            if slot is not None:
                child.refs[slot] = epoch
            node = child
        self.tracer.gauge("radix.nodes", self.node_count)

    @traced("radix.match")
    def _walk(self, tokens: list[int]) -> tuple[int, int, int | None]:
        """Walk + account one lookup; returns (trie depth, reuse depth, lane)."""
        self.tracer.add("radix.tokens_walked", len(tokens))
        self._clock += 1
        now = self._clock
        node = self.root
        n = 0
        reuse_n, reuse_slot = 0, None
        for t in tokens:
            node = node.children.get(int(t))
            if node is None:
                break
            node.last_used = now
            n += 1
            if node.refs:
                stale = [s for s, e in node.refs.items()
                         if self._epochs.get(s, 0) != e]
                for s in stale:
                    del node.refs[s]
                if node.refs:
                    reuse_n, reuse_slot = n, next(iter(node.refs))
        self.lookups += 1
        if n and n == len(tokens):
            self.full_hits += 1
        elif n:
            self.partial_hits += 1
        self.hit_tokens += n
        return n, reuse_n, reuse_slot

    def match_len(self, tokens: list[int]) -> int:
        return self._walk(tokens)[0]

    def match_lane(self, tokens: list[int]) -> tuple[int, int | None]:
        """Deepest prefix of ``tokens`` backed by a live lane: (length, slot)."""
        _, reuse_n, reuse_slot = self._walk(tokens)
        return reuse_n, reuse_slot

    # ------------------------------------------------------------ LRU pruning
    def _subtree_size(self, node: _TrieNode) -> int:
        count, stack = 0, [node]
        while stack:
            n = stack.pop()
            count += 1
            stack.extend(n.children.values())
        return count

    @traced("radix.prune")
    def _prune(self) -> None:
        """Evict least-recently-used subtrees down to ~3/4 of the node cap."""
        self.tracer.add("radix.prunes")
        target = max(1, self.max_nodes * 3 // 4)
        stamps: list[int] = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            for c in node.children.values():
                stamps.append(c.last_used)
                stack.append(c)
        excess = len(stamps) - target
        if excess <= 0:
            return
        # never evict the in-flight insert path (stamped with the current clock)
        cutoff = min(sorted(stamps)[excess - 1], self._clock - 1)
        removed = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            doomed = [t for t, c in node.children.items() if c.last_used <= cutoff]
            for t in doomed:
                removed += self._subtree_size(node.children.pop(t))
            stack.extend(node.children.values())
        self.node_count -= removed
        self.tracer.add("radix.pruned_nodes", removed)


# ---------------------------------------------------------------- decode loop

def _step(cfg: ModelConfig, params, pool, last: torch.Tensor, live: torch.Tensor,
          keys: torch.Tensor, stop, sampler: SamplerConfig, mesh=None):
    """One masked step over the whole pool, with no host sync.

    last: (B,) int32 last context token per lane; live: (B,) bool active mask;
    keys: (B, 2) per-sequence base keys; stop: the stop token (an int or a
    0-d tensor) or None.  Lane ``b`` draws its token with ``fold_in(keys[b],
    pos[b])``.  Returns (pool, last, live, tokens (B,) int32), the tokens -1
    on lanes that were inactive (or had already stopped).  With a ``mesh``,
    ``params`` and ``pool`` are lists of its shards and the sampling runs on
    its device 0.
    """
    step_keys = prng.fold_in(keys, (pool if mesh is None else pool[0])["pos"])
    logits, pool = M.decode_step(cfg, params, pool, last[:, None], active=live, mesh=mesh)
    toks = sample_slots(step_keys, logits, sampler, active=live)
    last = torch.where(live, toks, last)
    if stop is not None:
        live = live & (toks != stop)
    return pool, last, live, toks


def _decode_loop(cfg: ModelConfig, params, pool, last: torch.Tensor,
                 live: torch.Tensor, keys: torch.Tensor, n_tokens: int,
                 stop_token: int | None, sampler: SamplerConfig, mesh=None):
    """``n_tokens`` eager ``_step``s, with no host sync inside.  Returns (pool,
    last, live, emitted (T, B) int32)."""
    emitted = []
    for _ in range(n_tokens):
        pool, last, live, toks = _step(cfg, params, pool, last, live, keys, stop_token,
                                       sampler, mesh)
        emitted.append(toks)
    return pool, last, live, torch.stack(emitted)


NO_STOP = -2         # the stop buffer's value for no stop token: no lane draws it
# the kernel wrappers' launch counts, which a graph's replays add to
_LAUNCHES = (decode_attention.launches, mamba_scan.launches)


class _StepGraph:
    """One ``_step`` of a worker's whole pool as a CUDA graph, on buffers of
    its own: it reads ``last``, ``live``, ``keys`` and ``stop`` (the stop
    token, or ``NO_STOP``), the pool and the params in place, and writes the
    step's ``last``, ``live`` and tokens (``toks``) back.

    ``capture`` runs the step once eagerly on the graph's own stream, which
    warms that stream (the kernels' counters, cuBLAS's workspace), then
    captures the same step; it changes nothing but that one step.  The graph
    holds the addresses of every tensor it reads: where the worker replaces
    one it marks the graph ``stale`` and the next decode drops it and
    captures anew.  ``count`` adds, for each replay, the wrapper launches
    that the capture counted (a capture launches nothing)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = self.graph = None
        self.stale = True
        self.launches: list[tuple[dict, str, int]] = []
        self.last = self.live = self.keys = self.stop = self.toks = None

    def load(self, last: np.ndarray, live: np.ndarray, keys: np.ndarray,
             stop_token: int | None) -> None:
        """The call's inputs into the buffers (made anew, stale, for another B)."""
        if self.last is None or self.last.shape[0] != last.shape[0]:
            B, dev = last.shape[0], self.device
            self.last = torch.zeros(B, dtype=torch.int32, device=dev)
            self.live = torch.zeros(B, dtype=torch.bool, device=dev)
            self.keys = torch.zeros((B, 2), dtype=torch.int64, device=dev)
            self.stop = torch.zeros((), dtype=torch.int32, device=dev)
            self.toks = torch.zeros(B, dtype=torch.int32, device=dev)
            self.stale = True
        self.last.copy_(torch.from_numpy(last))
        self.live.copy_(torch.from_numpy(live))
        self.keys.copy_(torch.from_numpy(keys))
        self.stop.fill_(NO_STOP if stop_token is None else stop_token)

    def run(self, cfg: ModelConfig, params, pool, sampler: SamplerConfig) -> None:
        """One step on the buffers (what the graph holds)."""
        _, last, live, toks = _step(cfg, params, pool, self.last, self.live, self.keys,
                                    self.stop, sampler)
        self.last.copy_(last)
        self.live.copy_(live)
        self.toks.copy_(toks)

    def capture(self, cfg: ModelConfig, params, pool, sampler: SamplerConfig) -> None:
        """``run`` once eagerly, then captured; both on the graph's stream."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        self.graph = None                # the stale graph's memory goes back first
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream), torch.no_grad():
            self.run(cfg, params, pool, sampler)
            before = [dict(counts) for counts in _LAUNCHES]
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.run(cfg, params, pool, sampler)
            finally:
                graph.capture_end()
        current.wait_stream(self.stream)
        self.launches = [(counts, name, n - was[name]) for counts, was in zip(_LAUNCHES, before)
                         for name, n in counts.items() if n != was[name]]
        self.count(-1)                   # the capture's calls launched nothing
        self.graph, self.stale = graph, False

    def count(self, replays: int) -> None:
        for counts, name, n in self.launches:
            counts[name] += replays * n


# host-side chunk size for stop-token decodes: one host sync per CHUNK steps
# buys the early exit once every requested lane has stopped
_DECODE_CHUNK = 8


# ---------------------------------------------------------------- worker

def _nbytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size() for t in M.tree_leaves(cache))


@dataclass
class Sequence:
    seq_id: int
    tokens: list[int]                    # full context (prompt + generated + tool)
    slot: int                            # lane index in the worker's pool
    key: np.ndarray                      # (2,) uint32 per-sequence sampling key
    generated: int = 0
    preempted: bool = False
    finished: bool = False


def check_servable(cfg: ModelConfig) -> None:
    """Raise unless the rollout worker can serve ``cfg``: every layer kind
    is ported, and admission needs token prompts alone.  Audio and VLM
    configs also need frame or patch embeddings at admission, and the
    reference worker has no admission path for cross-attention either; they
    run through ``models.model.forward_full`` and ``decode_step``."""
    M.check_ported(cfg)
    if cfg.arch_type in M.CROSS_ARCHS:
        raise NotImplementedError(
            f"{cfg.name}: the rollout worker admits token prompts only, and {cfg.arch_type} "
            "configs need encoder or image embeddings; the reference worker has no "
            "admission path for cross-attention (use models.model.forward_full and "
            "decode_step)")


class RolloutWorker:
    """One rollout worker holding model params and a KV pool, paged or dense.

    The data plane of ``repro.engine.worker.RolloutWorker``, with the same
    host-side bookkeeping (lanes, block ids, radix cache, retired lanes,
    counters), so both make the same decisions for the same calls.

    ``paged`` (default on) takes effect where ``model.supports_paged_kv``
    allows it; otherwise (``paged=False``, or a sliding window) the worker
    runs the dense plane.  ``use_chunked`` (default on) takes effect where
    ``model.supports_chunked_prefill`` allows it; otherwise admission is one
    full-sequence forward (``model.forward_full``), tool tokens are absorbed
    one masked decode step each, and the radix cache reuses nothing.

    ``device=None`` means the card and raises where there is none; pass
    ``device="cpu"`` to run on the CPU (the kernels' plain versions then
    run).  ``params`` is moved to ``device`` (a no-op for tensors already
    there, so workers on one card share one copy).

    ``mesh`` (``launch.mesh.WorkerMesh``) places the worker: its device 0
    takes the place of ``device``, and a mesh of degree ``mp`` > 1 shards
    the worker, whatever its config: the groups whose widths divide by
    ``mp`` are cut (``distributed.sharding.tp_split``), the rest replicated.
    ``params`` takes the full tree, which a meshed worker cuts, or weights
    already cut for the mesh (``distributed.sharding.ShardedParams``, e.g.
    ``init_params(cfg, seed, mesh=mesh)``, which never holds the whole tree
    on one card), which it checks and keeps.

    ``tracer`` (``engine.tracing.Tracer``; a fleet passes its own, a worker
    built alone makes one that is off) times each call into the worker
    (``worker.admit``, ``worker.absorb``, ``worker.decode``,
    ``worker.release``, ``worker.migrate_out``, ``worker.migrate_in``,
    ``worker.checkpoint``), the forwards of admission and absorption
    (``admit.forward``, ``absorb.forward``, and absorption's device span
    ``absorb``), and the decode call's host phases: ``decode.prep`` (the
    lanes' last tokens, masks and keys, page coverage, the copies to the
    device), ``decode.enqueue`` (the host issuing a pass of the step loop),
    ``decode.wait`` (the host blocked on the device: the stop check and the
    copy of the emitted tokens) and ``decode.emit`` (the tokens handed to
    the lanes), and counts the decode graph's ``decode.graph_replays`` and
    ``decode.graph_captures``; the radix index writes to it too.
    """

    def __init__(self, cfg: ModelConfig, params, capacity: int = 256,
                 max_slots: int = 8, worker_id: int = 0,
                 sampler: SamplerConfig = SamplerConfig(), seed: int = 0,
                 chunk_size: int = 32, prefix_reuse: bool = True,
                 use_chunked: bool | None = None,
                 retired_kv_bytes: int | None = None,
                 prefix_index_nodes: int = 65_536, mp: int = 1,
                 paged: bool | None = None, page_size: int = 16,
                 num_blocks: int | None = None, device=None, mesh=None,
                 tracer: Tracer | None = None):
        check_servable(cfg)
        self.tracer = tracer if tracer is not None else Tracer()
        self.mp = max(int(mp), 1)
        self.mesh = mesh
        if mesh is not None and mesh.degree not in (1, self.mp):
            raise ValueError(f"a worker of MP degree {self.mp} was given a mesh of "
                             f"{mesh.degree} devices")
        # the mesh the model functions compute on: only a sharded worker has one
        self._tp = mesh if mesh is not None and mesh.degree > 1 else None
        self.device = mesh.devices[0] if mesh is not None else resolve_device(device)
        self.split = tp_split(cfg, mesh.degree if mesh is not None else 1)
        # the config each shard computes with (its heads and widths)
        self.shard_cfg = shard_config(cfg, self.split) if self._tp is not None else cfg
        self.cfg = cfg
        self.capacity = capacity
        self.max_slots = max_slots
        self.worker_id = worker_id
        self.sampler = sampler
        self.base_key = prng.prng_key(seed + worker_id)
        # a worker on one card replays its decode step as a CUDA graph
        # (captured at its first decode); on the CPU or a mesh of several
        # shards it runs the step eagerly
        self._graph = (_StepGraph(self.device) if self._tp is None and self.device.type == "cuda"
                       else None)
        self.params = params
        # byte prices, from shapes alone (meta tensors allocate nothing): a
        # lane's dense state (pos and recurrent state), a dense lane (state +
        # K/V at full capacity) and, paged, one block across every paged layer
        self._state_bytes = _nbytes(M.init_cache(cfg, 1, 0, "meta"))
        self._lane_bytes = _nbytes(M.init_cache(cfg, 1, capacity, "meta"))
        itemsize = torch.empty((), dtype=M.torch_dtype(cfg)).element_size()
        n_attn = sum(1 for k in cfg.block_pattern if M._paged_kind(k))
        kv_per_token = 2 * cfg.n_periods * n_attn * cfg.n_kv_heads * cfg.hd * itemsize
        self.lane_pages: dict[int, list[int]] = {}   # slot -> ordered blocks (paged)
        self._paged = (paged if paged is not None else True) and M.supports_paged_kv(cfg)
        if self._paged:
            ps = max(int(page_size), 1)
            while capacity % ps:                   # page size must tile the lane
                ps //= 2
            self.page_size = ps
            self.num_pages = capacity // ps
            # default block budget: the dense pool's footprint (+ scratch)
            self.num_blocks = (num_blocks if num_blocks is not None
                               else max_slots * self.num_pages + 1)
            self.pages = PagePool(self.num_blocks)
            self.block_grows = 0
            self._page_bytes = kv_per_token * ps
            self.pool = self._placed(lambda c, dev: M.init_paged_pool(
                c, max_slots, self.num_blocks, ps, self.num_pages, dev))
        else:
            self.pool = self._placed(lambda c, dev: M.init_cache(c, max_slots, capacity, dev))
        self.store: dict[int, Sequence] = {}       # resident sequences (incl. preempted)
        self.chunk_size = chunk_size
        self._chunked = ((use_chunked if use_chunked is not None else True)
                         and M.supports_chunked_prefill(cfg))
        self._reuse = prefix_reuse and self._chunked and M.supports_prefix_reuse(cfg)
        budget = (retired_kv_bytes if retired_kv_bytes is not None
                  else self._lane_bytes * max_slots)
        self._max_retired = budget // self._lane_bytes if self._lane_bytes else 0
        self.retired: OrderedDict[int, int] = OrderedDict()   # slot -> token count
        self.prefix_index = PrefixCacheIndex(max_nodes=prefix_index_nodes,
                                             tracer=self.tracer)
        self.decode_steps = 0
        self.pool_grows = 0
        self.reused_tokens = 0                     # admission tokens implanted, not computed
        self.prefilled_tokens = 0                  # admission tokens actually computed
        self.absorbed_tokens = 0                   # tool tokens teacher-forced (extend)
        self.prefill_dispatches = 0                # chunk launches
        # measured decode timing: every call is timed (eager PyTorch compiles
        # nothing), up to the host copy of the emitted tokens
        self.decode_wall_s = 0.0
        self.decode_timed_steps = 0
        self.decode_timed_lane_steps = 0
        self.decode_calls = 0
        self.decode_graph_steps = 0                # steps run by replaying the graph
        self.decode_graph_captures = 0

    # ------------------------------------------------------------ placement
    @property
    def params(self):
        """The weights: the full tree, or one tree per shard on a mesh."""
        return self._params

    @params.setter
    def params(self, params) -> None:
        """Adopt weights (construction, weight sync): the full tree is moved
        to the device or cut for the mesh; weights already cut for this
        worker (``ShardedParams``, e.g. from ``init_params(mesh=)``) are
        checked and kept as they are.  New weights make the decode graph
        stale."""
        self._stale_graph()
        if isinstance(params, ShardedParams):
            self._check_shards(params)
            self._params = params if self._tp is not None else params[0]
        else:
            self._params = (shard_params(params, self.split, self._tp) if self._tp is not None
                            else M.tree_to(params, self.device))

    def _stale_graph(self) -> None:
        """A tensor the decode graph reads is replaced: capture at the next decode."""
        if self._graph is not None:
            self._graph.stale = True

    def _check_shards(self, shards: ShardedParams) -> None:
        """Refuse weights cut for another degree or split, or whose shards
        lie elsewhere or differ in names or shapes from this worker's cut of
        its config."""
        devices = self._tp.devices if self._tp is not None else (self.device,)
        if len(shards) != len(devices) or shards.split != self.split:
            raise ValueError(f"params cut into {len(shards)} shards by {shards.split}; this "
                             f"worker computes on {len(devices)} by {self.split}")
        meta = torch.device("meta")
        want = M.init_params(self.cfg, device=meta, mesh=WorkerMesh((meta,) * len(devices)))
        for r, (shard, like, dev) in enumerate(zip(shards, want, devices)):
            got = dict(M.tree_items(shard))
            need = dict(M.tree_items(like))
            if got.keys() != need.keys():
                raise ValueError(f"params shard {r}: leaves {sorted(got.keys() ^ need.keys())} "
                                 f"differ from {self.cfg.name}'s")
            for path, t in got.items():
                if t.shape != need[path].shape:
                    raise ValueError(f"params shard {r}: {path} has shape {tuple(t.shape)}, "
                                     f"want {tuple(need[path].shape)}")
                if not (t.device == dev or (dev.index is None and t.device.type == dev.type)):
                    raise ValueError(f"params shard {r}: {path} is on {t.device}, the "
                                     f"shard's device is {dev}")

    def _placed(self, make):
        """``make(config, device)`` for the unsharded worker, or one per shard
        with the shard config (a pool, a lane) on each shard's device."""
        if self._tp is None:
            return make(self.cfg, self.device)
        return [make(self.shard_cfg, dev) for dev in self._tp.devices]

    def _shards(self, x) -> list:
        """A pool or lane as a list of the worker's shards of it."""
        return x if self._tp is not None else [x]

    def _each(self, fn, *args) -> None:
        """``fn(pool, *args)`` on every shard's pool."""
        for pool in self._shards(self.pool):
            fn(pool, *args)

    def _cut(self, tree):
        """A full lane, lane state, pool or page stack (on any device) as
        this worker's shards of it: itself unsharded."""
        return shard_cache(tree, self.split, self._tp) if self._tp is not None else tree

    def _joined(self, parts: list):
        """The full layout of a lane, lane state or page stack given per
        shard, on the worker's device 0: the shards' pieces are copied there
        card to card, never through the host."""
        if self._tp is None:
            return parts[0]
        return gather_cache(parts, self.split, self.device)

    # ------------------------------------------------------------ slot bookkeeping
    def _reclaim(self, slot: int) -> None:
        """A lane about to be overwritten: drop its radix refs and free its
        pages (shared blocks survive via their sharers' refcounts)."""
        self.prefix_index.invalidate(slot)
        self._free_lane_pages(slot)

    def _alloc_slot(self) -> int:
        """Lowest free lane, else the LRU retired lane, else lane growth (doubling)."""
        used = {s.slot for s in self.store.values()}
        for slot in range(self.max_slots):
            if slot not in used and slot not in self.retired:
                self._reclaim(slot)
                return slot
        if self.retired:
            slot, _ = self.retired.popitem(last=False)
            self._reclaim(slot)
            return slot
        slot = self.max_slots
        if self._paged:
            # lane growth only: page-table rows and pos double, block pools stay
            self._each(lambda pool: M.grow_paged_lanes(self.shard_cfg, pool, self.max_slots))
        else:
            fresh = self._placed(lambda c, dev: M.init_cache(c, self.max_slots,
                                                             self.capacity, dev))
            pools = [M.concat_pools(a, b) for a, b in zip(self._shards(self.pool),
                                                          self._shards(fresh))]
            self.pool = pools if self._tp is not None else pools[0]
        self.max_slots *= 2
        self.pool_grows += 1
        self._stale_graph()
        self.prefix_index.invalidate(slot)
        return slot

    def _retire_slot(self, slot: int, n_tokens: int) -> None:
        """Hand a released lane to the radix cache (LRU, byte-budgeted); a paged
        lane's tail pages past ceil(n_tokens / page_size) are freed now."""
        if not (self._reuse and self._max_retired > 0 and n_tokens > 0):
            self._reclaim(slot)
            return
        self._trim_lane_pages(slot, n_tokens)
        self.retired[slot] = n_tokens
        self.retired.move_to_end(slot)
        while len(self.retired) > self._max_retired:
            old, _ = self.retired.popitem(last=False)
            self._reclaim(old)

    # ------------------------------------------------------------ page bookkeeping
    # (the dense plane maps no pages: lane_pages stays empty and these no-op)
    def _row_of(self, blocks: list[int]) -> np.ndarray:
        """Fixed-shape (num_pages,) row; unmapped tail -> scratch block 0."""
        row = np.zeros((self.num_pages,), np.int32)
        row[:len(blocks)] = blocks
        return row

    def _sync_row(self, slot: int) -> None:
        """Mirror ``lane_pages[slot]`` into the device page table."""
        self._each(M.paged_set_row, slot, self._row_of(self.lane_pages.get(slot, [])))

    def _free_lane_pages(self, slot: int) -> None:
        """Release every page a lane holds and point its row at scratch."""
        blocks = self.lane_pages.pop(slot, None)
        if blocks:
            self.pages.free(blocks)
            self._sync_row(slot)

    def _trim_lane_pages(self, slot: int, n_tokens: int) -> None:
        """Free pages past ceil(n_tokens / page_size) (retire headroom trim)."""
        blocks = self.lane_pages.get(slot, [])
        if not blocks:
            return
        keep = -(-n_tokens // self.page_size)
        if len(blocks) > keep:
            self.pages.free(blocks[keep:])
            self.lane_pages[slot] = blocks[:keep]
            self._sync_row(slot)

    def _alloc_blocks(self, n: int) -> list[int]:
        """Allocate ``n`` blocks, evicting retired lanes under pressure and
        doubling the device block pool only once nothing is left to reclaim."""
        while True:
            try:
                return self.pages.alloc(n)
            except PagePoolExhausted:
                if self.retired:
                    old, _ = self.retired.popitem(last=False)
                    self._reclaim(old)
                    continue
                self._grow_blocks(n)

    def _grow_blocks(self, min_extra: int) -> None:
        extra = max(min_extra, self.num_blocks)     # doubling growth
        self._each(M.grow_paged_blocks, extra)
        self._stale_graph()
        self.pages.grow(self.num_blocks + extra)
        self.num_blocks += extra
        self.block_grows += 1

    def _ensure_coverage(self, slot: int, total_tokens: int) -> None:
        """Map enough pages on lane ``slot`` for ``total_tokens`` positions
        (capped at lane capacity -- past it, writes go to scratch)."""
        need = min(-(-total_tokens // self.page_size), self.num_pages)
        have = self.lane_pages.get(slot, [])
        if len(have) >= need:
            return
        self.lane_pages[slot] = have + self._alloc_blocks(need - len(have))
        self._sync_row(slot)

    # ------------------------------------------------------------ lifecycle
    @traced("worker.admit")
    def prefill(self, seq_id: int, tokens: list[int]) -> None:
        """Admit a sequence: reuse the radix-matched prefix (shared pages, or a
        lane-prefix copy on the dense plane), then chunk-prefill the suffix;
        without chunked prefill, one full-sequence forward."""
        reuse_n, src = 0, None
        if self._reuse:
            reuse_n, src = self.prefix_index.match_lane(tokens)
        else:
            self.prefix_index.match_len(tokens)
        slot = self._alloc_slot()
        if self._paged:
            self._prefill_paged(slot, tokens, reuse_n, src)
        elif not self._chunked:
            with self.tracer.span("admit.forward"):
                self._write_lane(self._forward_lane(tokens, self.capacity), slot)
            self.prefilled_tokens += len(tokens)
        else:
            self._prefill_dense(slot, tokens, reuse_n, src)
        key = prng.fold_in(self.base_key, seq_id).numpy().astype(np.uint32)
        self.store[seq_id] = Sequence(seq_id, list(tokens), slot, key)
        self.prefix_index.insert(tokens, slot=slot)

    def _forward_lane(self, tokens: list[int], capacity: int):
        """A batch-1 dense lane of ``capacity`` slots from one full forward
        (one per shard on a mesh)."""
        arr = torch.as_tensor([tokens], dtype=torch.int64, device=self.device)
        _, _, lane = M.forward_full(self.cfg, self.params, {"tokens": arr},
                                    capacity=capacity, mesh=self._tp)
        return lane

    def _prefill_dense(self, slot: int, tokens: list[int], reuse_n: int,
                       src: int | None) -> None:
        """Copy the matched prefix of lane ``src`` into a fresh lane on the
        device, chunk-prefill the suffix into it, and write it into ``slot``.
        (``src`` may be the lane ``slot`` reclaimed: its old contents are read
        before the write.)"""
        lane = self._placed(lambda c, dev: M.init_cache(c, 1, self.capacity, dev))
        if src is not None and reuse_n > 0:
            if src in self.retired:
                self.retired.move_to_end(src)             # LRU touch
            for pool, ln in zip(self._shards(self.pool), self._shards(lane)):
                M.copy_prefix(pool, src, ln, reuse_n)
            self.reused_tokens += reuse_n
        with self.tracer.span("admit.forward"):
            for buf, n in self._chunks(tokens, reuse_n):
                M.prefill_chunk(self.cfg, self.params, lane, buf, n, mesh=self._tp)
        self._write_lane(lane, slot)
        self.prefilled_tokens += len(tokens) - reuse_n

    def _prefill_paged(self, slot: int, tokens: list[int], reuse_n: int,
                       src: int | None) -> None:
        """Share the matched prefix's full pages by refcount (no KV copy),
        copy its boundary partial page device to device, then chunk-prefill
        the suffix straight into freshly mapped pages (or, without chunked
        prefill, scatter one full forward's lane into them).  Before the
        chunks run, the lane's recurrent state row is made fresh, as a dense
        admission's lane is (the JAX package's paged admission keeps the
        previous occupant's state); a full forward writes the whole row."""
        S, ps = len(tokens), self.page_size
        blocks: list[int] = []
        boundary: tuple[int, int] | None = None
        reuse_eff = 0
        if src is not None and reuse_n > 0:
            if src in self.retired:
                self.retired.move_to_end(src)             # LRU touch
            src_blocks = self.lane_pages.get(src, [])
            reuse_eff = min(reuse_n, len(src_blocks) * ps)
            n_full = reuse_eff // ps
            if n_full:
                blocks = list(src_blocks[:n_full])
                self.pages.share(blocks)
            if reuse_eff % ps:
                [b] = self._alloc_blocks(1)
                boundary = (b, src_blocks[n_full])
                blocks.append(b)
            self.reused_tokens += reuse_eff
        need = min(-(-S // ps), self.num_pages)
        if need > len(blocks):
            blocks = blocks + self._alloc_blocks(need - len(blocks))
        self.lane_pages[slot] = blocks
        self._each(M.paged_set_lane, slot, self._row_of(blocks), reuse_eff)
        if boundary is not None:
            self._each(M.paged_copy_block, boundary[0], boundary[1])
        if not self._chunked:
            with self.tracer.span("admit.forward"):
                lanes = self._shards(self._forward_lane(tokens, S))
                for pool, ln in zip(self._shards(self.pool), lanes):
                    M.paged_write_lane(pool, ln, slot, self._row_of(blocks), S)
            self.prefilled_tokens += S
            return
        self._each(lambda pool: M.paged_fresh_state(self.shard_cfg, pool, slot))
        with self.tracer.span("admit.forward"):
            for buf, n in self._chunks(tokens, reuse_eff):
                M.prefill_chunk_paged(self.cfg, self.params, self.pool, slot, buf, n,
                                      mesh=self._tp)
        self.prefilled_tokens += S - reuse_eff

    def _chunks(self, tokens: list[int], start: int):
        """``tokens[start:]`` as fixed-shape (1, chunk_size) buffers on the
        device, each with its count of valid tokens; counts the dispatches."""
        C = self.chunk_size
        for off in range(start, len(tokens), C):
            step = min(C, len(tokens) - off)
            buf = np.zeros((1, C), np.int64)
            buf[0, :step] = tokens[off:off + step]
            self.prefill_dispatches += 1
            yield torch.from_numpy(buf).to(self.device), step

    @traced("worker.absorb", device="absorb")
    def extend(self, seq_id: int, tool_tokens: list[int]) -> None:
        """Absorb tool output: chunked prefill into the lane at its current
        offset (one masked decode step per token without chunked prefill)."""
        if not self._chunked:
            self.extend_per_token(seq_id, tool_tokens)
            return
        tr = self.tracer
        seq = self.store[seq_id]
        ext = list(seq.tokens) + [int(t) for t in tool_tokens]
        if self._paged:
            self._ensure_coverage(seq.slot, len(ext))
            with tr.span("absorb.forward"):
                for buf, n in self._chunks(ext, len(seq.tokens)):
                    M.prefill_chunk_paged(self.cfg, self.params, self.pool, seq.slot,
                                          buf, n, mesh=self._tp)
        else:
            lane = self._gather_lane(seq.slot)
            with tr.span("absorb.forward"):
                for buf, n in self._chunks(ext, len(seq.tokens)):
                    M.prefill_chunk(self.cfg, self.params, lane, buf, n, mesh=self._tp)
            self._write_lane(lane, seq.slot)
        self.absorbed_tokens += len(tool_tokens)
        seq.tokens = ext
        self.prefix_index.insert(seq.tokens, slot=seq.slot)

    def extend_per_token(self, seq_id: int, tool_tokens: list[int]) -> None:
        """Tool absorption one masked full-pool decode step per token (the path
        of configs without chunked prefill)."""
        seq = self.store[seq_id]
        if self._paged:
            self._ensure_coverage(seq.slot, len(seq.tokens) + len(tool_tokens))
        B = self.max_slots
        active = torch.arange(B, device=self.device) == seq.slot
        toks = torch.as_tensor([int(t) for t in tool_tokens], dtype=torch.int64,
                               device=self.device)
        with self.tracer.span("absorb.forward"):
            for i in range(len(tool_tokens)):
                M.decode_step(self.cfg, self.params, self.pool, toks[i].expand(B, 1),
                              active=active, mesh=self._tp)
        self.absorbed_tokens += len(tool_tokens)
        seq.tokens.extend(int(t) for t in tool_tokens)
        self.prefix_index.insert(seq.tokens, slot=seq.slot)

    @traced("worker.decode")
    def decode(self, seq_ids: list[int], n_tokens: int, stop_token: int | None = None
               ) -> dict[int, list[int]]:
        """Batched decode of the requested resident sequences for ``n_tokens`` steps.

        One step loop over the whole pool; lanes not requested (free,
        preempted, idle) ride along masked out at frozen ``pos``.  Requesting a
        preempted sequence resumes it.  A finished sequence is never resumed
        and yields an empty stream.  With a stop token the host checks once per
        ``_DECODE_CHUNK`` steps whether every requested lane has stopped.
        """
        tr = self.tracer
        requested = [sid for sid in seq_ids if not self.store[sid].finished]
        if not requested:
            return {sid: [] for sid in seq_ids}
        B = self.max_slots
        with tr.span("decode.prep"):
            last = np.zeros((B,), np.int32)
            live = np.zeros((B,), bool)
            keys = np.zeros((B, 2), np.int64)
            for seq in self.store.values():
                last[seq.slot] = seq.tokens[-1]
                keys[seq.slot] = seq.key
            for sid in requested:
                seq = self.store[sid]
                seq.preempted = False
                live[seq.slot] = True
                if self._paged:
                    # map decode headroom up front: the loop writes positions
                    # [len(tokens), len(tokens) + n_tokens) with no host check inside
                    self._ensure_coverage(seq.slot, len(seq.tokens) + n_tokens)
            if self._graph is not None:
                self._graph.load(last, live, keys, stop_token)
                live_t = self._graph.live
            else:
                last_t = torch.from_numpy(last).to(self.device)
                live_t = torch.from_numpy(live).to(self.device)
                keys_t = torch.from_numpy(keys).to(self.device)
        chunk = n_tokens if stop_token is None else _DECODE_CHUNK
        parts = []
        remaining = n_tokens
        ran = 0
        lane_steps = 0
        t0 = time.perf_counter()
        while remaining > 0:
            step = min(chunk, remaining)
            with tr.span("decode.enqueue"):
                if self._graph is not None:
                    em = self._replay(step)
                else:
                    self.pool, last_t, live_t, em = _decode_loop(
                        self.cfg, self.params, self.pool, last_t, live_t, keys_t,
                        step, stop_token, self.sampler, self._tp)
            parts.append(em)           # device-resident: copied to the host after the loop
            remaining -= step
            ran += step
            self.decode_steps += step
            if stop_token is None:                          # nothing stops early
                lane_steps += step * len(requested)
            else:
                with tr.span("decode.wait"):
                    n_live = int(live_t.sum())  # heddle: noqa HDL003 -- deliberate early-exit sync, one per chunk
                lane_steps += step * n_live
                if remaining > 0 and n_live == 0:
                    break
        with tr.span("decode.wait"):
            emitted = (torch.cat(parts).cpu().numpy() if parts
                       else np.zeros((0, B), np.int32))       # n_tokens == 0 edge
        self.decode_wall_s += time.perf_counter() - t0
        self.decode_timed_steps += ran
        self.decode_timed_lane_steps += lane_steps
        self.decode_calls += 1
        out: dict[int, list[int]] = {sid: [] for sid in seq_ids}
        with tr.span("decode.emit"):
            for sid in requested:
                seq = self.store[sid]
                toks = [int(t) for t in emitted[:, seq.slot] if t >= 0]
                out[sid] = toks
                seq.tokens.extend(toks)
                seq.generated += len(toks)
                if stop_token is not None and toks and toks[-1] == stop_token:
                    seq.finished = True
        for sid in requested:
            seq = self.store[sid]
            self.prefix_index.insert(seq.tokens, slot=seq.slot)
        return out

    def _replay(self, n: int) -> torch.Tensor:
        """``n`` steps of the decode graph, captured first where it is stale
        (the capture's eager step is then the first of the ``n``); returns
        their tokens, (n, B) int32."""
        g = self._graph
        em = torch.empty((n, self.max_slots), dtype=torch.int32, device=self.device)
        done = 0
        if g.stale:
            g.capture(self.cfg, self.params, self.pool, self.sampler)
            em[0].copy_(g.toks)
            done = 1
            self.decode_graph_captures += 1
            self.tracer.add("decode.graph_captures")
        for i in range(done, n):
            g.graph.replay()
            em[i].copy_(g.toks)
        g.count(n - done)
        self.decode_graph_steps += n - done
        self.tracer.add("decode.graph_replays", n - done)
        return em

    # ------------------------------------------------------------ control ops
    def preempt(self, seq_id: int) -> None:
        """Evict from the running batch but keep the KV: a mask flip."""
        self.store[seq_id].preempted = True

    @traced("worker.release")
    def release(self, seq_id: int) -> None:
        """Finish a sequence; its lane retires into the radix cache's LRU set."""
        seq = self.store.pop(seq_id, None)
        if seq is not None:
            self._retire_slot(seq.slot, len(seq.tokens))

    def _package_meta(self, seq: Sequence, preempted: bool, finished: bool) -> dict:
        return {
            "seq_id": seq.seq_id,
            "tokens": list(seq.tokens),
            "generated": seq.generated,
            "key": np.asarray(seq.key),
            "preempted": preempted,
            "finished": finished,
        }

    def _gather_lane(self, slot: int):
        """A copy of lane ``slot`` as a batch-1 dense lane (one per shard)."""
        lanes = [M.gather_slots(pool, [slot]) for pool in self._shards(self.pool)]
        return lanes if self._tp is not None else lanes[0]

    def _write_lane(self, lane, slot: int) -> None:
        """Write a batch-1 dense lane (one per shard) into lane ``slot``."""
        for pool, ln in zip(self._shards(self.pool), self._shards(lane)):
            M.write_slot(pool, ln, slot)

    def _lane_payload(self, seq: Sequence) -> dict:
        """One lane's KV and state in the full layout, with its byte price: the
        resident pages and dense state (paged) or the whole lane (dense), on
        the worker's device 0 (a sharded worker's shards gathered there)."""
        if not self._paged:
            return {"cache": self._joined([M.gather_slots(p, [seq.slot])
                                           for p in self._shards(self.pool)]),
                    "logical_bytes": self._lane_bytes}
        keep = -(-len(seq.tokens) // self.page_size)
        blocks = self.lane_pages.get(seq.slot, [])[:keep]
        pools = self._shards(self.pool)
        return {"pages": self._joined([M.paged_gather_pages(p, blocks) for p in pools]),
                "state": self._joined([M.paged_gather_state(p, seq.slot) for p in pools]),
                "page_size": self.page_size, "capacity": self.capacity,
                "logical_bytes": len(blocks) * self._page_bytes + self._state_bytes}

    @traced("worker.migrate_out")
    def migrate_out(self, seq_id: int) -> dict:
        """Package one lane's context and KV for transfer.

        The KV stays on the devices, in the full layout on the worker's
        device 0 (a sharded worker's shards gathered there card to card);
        ``migrate_in`` copies its pieces straight to the destination's
        devices, so a move never bounces through the host.  ``logical_bytes``
        prices the resident pages + dense state, or the whole dense lane.
        The local copy retires into the radix cache."""
        seq = self.store.pop(seq_id)
        pkg = self._package_meta(seq, seq.preempted, seq.finished)
        pkg.update(self._lane_payload(seq))
        self._retire_slot(seq.slot, len(seq.tokens))
        return pkg

    @traced("worker.checkpoint")
    def checkpoint_out(self, seq_id: int) -> dict:
        """Host copy of one lane WITHOUT evicting it (tool-boundary checkpoint).

        Same package format as :meth:`migrate_out`, copied to host memory so it
        outlives this worker's device; lifecycle flags are snapshotted clean."""
        seq = self.store[seq_id]
        pkg = self._package_meta(seq, False, False)
        pkg.update(self._lane_payload(seq))
        for name in ("cache", "pages", "state"):
            if name in pkg:
                pkg[name] = M.tree_to(pkg[name], "cpu")  # heddle: noqa HDL005 -- checkpoint copy must outlive the source device
        return pkg

    def _ingest_pages(self, package: dict, slot: int) -> None:
        """Land a paged package: allocate blocks, scatter the page stacks."""
        pages, state = package["pages"], package["state"]
        n = next(M.tree_leaves(pages)).shape[1] if pages else 0
        blocks = self._alloc_blocks(n) if n else []
        self.lane_pages[slot] = blocks
        for pool, pg, st in zip(self._shards(self.pool), self._shards(self._cut(pages)),
                                self._shards(self._cut(state))):
            M.paged_scatter_pages(pool, pg, blocks)
            M.paged_write_state(pool, st, slot, self._row_of(blocks))

    @traced("worker.migrate_in")
    def migrate_in(self, package: dict) -> None:
        """Implant a migrated lane into a free slot (capacities must match).

        Four layouts meet here: a paged package on a paged worker with the same
        page size and capacity scatters its pages; a paged package on any
        other worker is flattened back to a dense lane (``pages_to_lane``); a
        dense lane lands on a paged worker through ``paged_write_lane`` and on
        a dense worker through ``write_slot``.  The package's full KV and
        state are cut for this worker's mesh, so a lane moves between any two MP
        degrees."""
        slot = self._alloc_slot()
        if "pages" in package:
            if (self._paged and package.get("page_size") == self.page_size
                    and package.get("capacity") == self.capacity):
                self._ingest_pages(package, slot)
                self._register_seq(package, slot)
                return
            lane = M.pages_to_lane(package["pages"], package["state"], self.capacity)
        else:
            lane = package["cache"]
        lane = self._cut(lane)
        if self._paged:
            need = min(-(-len(package["tokens"]) // self.page_size), self.num_pages)
            blocks = self._alloc_blocks(need)
            self.lane_pages[slot] = blocks
            for pool, ln in zip(self._shards(self.pool), self._shards(lane)):
                M.paged_write_lane(pool, ln, slot, self._row_of(blocks),
                                   len(package["tokens"]))
        else:
            for pool, ln in zip(self._shards(self.pool), self._shards(lane)):
                for dst, src in M._lane_leaves(pool, ln):
                    if (dst.shape[0],) + dst.shape[2:] != (src.shape[0],) + src.shape[2:]:
                        raise ValueError(
                            f"migrate_in: lane shape {tuple(src.shape)} does not fit pool "
                            f"lane {tuple(dst.shape)}: source and destination workers must "
                            "share capacity and architecture")
            self._write_lane(lane, slot)
        self._register_seq(package, slot)

    def _register_seq(self, package: dict, slot: int) -> None:
        key = package.get("key")
        if key is None:                                     # foreign package: re-key
            key = prng.fold_in(self.base_key, package["seq_id"]).numpy()
        seq = Sequence(package["seq_id"], list(package["tokens"]), slot,
                       np.asarray(key, np.uint32), generated=package["generated"],
                       preempted=package.get("preempted", False),
                       finished=package.get("finished", False))
        self.store[package["seq_id"]] = seq
        self.prefix_index.insert(seq.tokens, slot=slot)

    # ------------------------------------------------------------ accounting
    def kv_bytes(self, seq_id: int) -> int:
        """One lane's footprint: resident pages + dense state (paged), or the
        fixed lane size (dense)."""
        if seq_id not in self.store:
            raise KeyError(seq_id)
        if not self._paged:
            return self._lane_bytes
        slot = self.store[seq_id].slot
        return len(self.lane_pages.get(slot, [])) * self._page_bytes + self._state_bytes

    def reset_cache(self) -> None:
        """Drop every resident and retired lane and all radix refs (weight sync)."""
        for slot in list(self.lane_pages):
            self._free_lane_pages(slot)
        self.store.clear()
        self.retired.clear()
        self.prefix_index = PrefixCacheIndex(max_nodes=self.prefix_index.max_nodes,
                                             tracer=self.tracer)

    def dispatch_stats(self) -> dict:
        """Admission, reuse, block-pool (paged) and decode counters (same keys
        as the JAX worker's), and a meshed worker's device count
        (``mesh_devices``)."""
        idx = self.prefix_index
        stats = {}
        if self._paged:
            stats = {"blocks_" + k: v for k, v in self.pages.stats().items()}
            stats["page_size"] = self.page_size
            stats["block_grows"] = self.block_grows
        return {
            **stats,
            "reused_tokens": self.reused_tokens,
            "prefilled_tokens": self.prefilled_tokens,
            "absorbed_tokens": self.absorbed_tokens,
            "prefill_dispatches": self.prefill_dispatches,
            "full_hits": idx.full_hits,
            "partial_hits": idx.partial_hits,
            "lookups": idx.lookups,
            "hit_tokens": idx.hit_tokens,
            "retired_lanes": len(self.retired),
            "decode_steps": self.decode_steps,
            "pool_grows": self.pool_grows,
            "mp": self.mp,
            **({} if self.mesh is None else {"mesh_devices": self.mesh.degree}),
            "decode_wall_s": self.decode_wall_s,
            "decode_timed_steps": self.decode_timed_steps,
            "decode_timed_lane_steps": self.decode_timed_lane_steps,
            "decode_calls": self.decode_calls,
            "decode_graph_steps": self.decode_graph_steps,
            "decode_graph_captures": self.decode_graph_captures,
        }
