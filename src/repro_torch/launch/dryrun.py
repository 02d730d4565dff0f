"""Dry run on the H100 layout (counterpart of ``repro/launch/dryrun.py``).

Reckons every (architecture x input shape) per card on the production layout
(``launch/mesh.py::make_production_mesh``: one host of 8 cards, ``1x8``, or
two, ``2x1x8``), at full width, with nothing allocated: the step of
``launch/specs.py`` runs on ``meta`` tensors under a tally that counts, for
each card of one replica,

* argument, output and temp bytes: the step's arguments, its outputs and the
  peak of the bytes alive during the step less the arguments, tracked by
  storage (views share their base's) and freed when the last tensor on a
  storage dies;
* FLOPs: the matrix products' 2 m n k (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, as ``torch.utils.flop_counter`` counts them, and the
  matrix-vector ``mv``, ``addmv``, which it does not: qwen2-moe's shared
  expert gate), plus the hand-written kernels' operations from their shape
  functions (``kernels/meta.py``), with one predicted launch each;
* bytes accessed: every op's inputs and outputs, a view none, an indexed
  read or write only the rows it moves, a kernel's from its formula;
* the collectives: each ``WorkerMesh.reduce`` as an all-reduce and each
  ``WorkerMesh.gather`` as an all-gather, their wire bytes the reference's
  multipliers of the output's bytes (a ring: 2x and 1x).  The broadcast of
  the step's inputs to the shards is a copy of the tokens and embeddings,
  not counted.

On a mesh every shard runs on ``meta``: an op belongs to the card of the
shard whose tensors it reads (an op reading only replicated weights or
nothing counts a d-th on every card, as each card runs it once), and each
collective's outputs are fresh tensors on each card.  The record is shard
0's (which also holds the step's inputs and the gathered logits), with the
largest shard's beside it where that is another.

No JAX, no XLA, no card: it runs on the CPU anywhere.  The reference
records ``lower_s`` and ``compile_s``; this one records ``trace_s``, the
time to build the arguments and run the step on ``meta``.  ``--out`` has no
default: the JAX roofline reader reads ``dryrun_16x16.json`` at the repo's
root, which this module never writes.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
        [--out FILE]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
import traceback
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.configs import ARCHITECTURES, combos, get_config
from repro_torch.kernels import meta as kernel_meta
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import ProductionLayout, WorkerMesh, make_production_mesh
from repro_torch.models.config import INPUT_SHAPES, LONG_CONTEXT_WINDOW, InputShape

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# bytes on the wire per output byte (ring algorithms, many participants)
WIRE_MULT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
             "all-to-all": 1.0, "collective-permute": 1.0}

_aten = torch.ops.aten
_PRODUCTS = {_aten.mm: (0, 1), _aten.addmm: (1, 2), _aten.bmm: (0, 1),
             _aten.baddbmm: (1, 2), _aten.mv: (0, 1), _aten.addmv: (1, 2)}   # -> (a, b)
_ALIASES = {_aten._unsafe_view, _aten.lift_fresh}        # share storage, not is_view
_INDEX_READS = {_aten.index, _aten.index_select, _aten.gather, _aten.embedding}
_INDEX_WRITES = {_aten.index_put_, _aten.index_put, _aten._index_put_impl_, _aten.index_add_,
                 _aten.index_add, _aten.scatter_add_, _aten.scatter_add, _aten.scatter_,
                 _aten.scatter, _aten.index_copy_, _aten.index_copy}
REPLICATED = -1                                          # an owner: every card holds one


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat(tree, out: list) -> list:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _flat(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _flat(x, out)
    return out


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of nested tuples, lists and dicts, in order."""
    return _flat(tree, [])


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def product_flops(func, args) -> int:
    """2 m n k (times the batch) of a matrix product op (n 1 for a
    matrix-vector product), else 0."""
    pos = _PRODUCTS.get(func.overloadpacket)
    if pos is None:
        return 0
    a, b = args[pos[0]], args[pos[1]]
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2 * batch * a.shape[-2] * a.shape[-1] * (b.shape[-1] if b.dim() > 1 else 1)


def op_bytes(func, ins: list, outs: list) -> int:
    """Bytes an op reads and writes, from its input and output tensors:
    each once; 0 for a view; an indexed read moves its output's rows, an
    indexed write its values' rows (the rest of the target is not touched);
    a copy does not read its target."""
    packet = func.overloadpacket
    if func.is_view or packet in _ALIASES:
        return 0
    out = sum(_nbytes(t) for t in outs)
    if packet in _INDEX_READS:
        return 2 * out + sum(_nbytes(t) for t in ins[1:])
    if packet in _INDEX_WRITES:
        return sum(_nbytes(t) for t in ins[1:]) + _nbytes(ins[-1])
    if packet is _aten.copy_:
        return 2 * _nbytes(ins[1])
    return sum(_nbytes(t) for t in ins) + out


@dataclass
class Card:
    """One card's sums.  All but ``live`` (bytes) are scaled by the degree d:
    an op that belongs to no card adds its amount once to the common sums,
    a d-th of it a card, and a card's own ops add d times theirs, so that
    every sum stays an integer."""

    products: int = 0
    kernels: int = 0
    bytes: int = 0
    live: int = 0
    peak: int = 0
    args: int = 0
    outputs: int = 0
    launches: dict = field(default_factory=dict)

    def counts(self) -> tuple:
        return self.products, self.kernels, self.bytes, dict(self.launches)

    def add(self, delta: tuple) -> None:
        self.products += delta[0]
        self.kernels += delta[1]
        self.bytes += delta[2]
        for k, v in delta[3].items():
            self.launches[k] = self.launches.get(k, 0) + v


def _minus(after: tuple, before: tuple) -> tuple:
    launches = {k: v - before[3].get(k, 0) for k, v in after[3].items()}
    return (after[0] - before[0], after[1] - before[1], after[2] - before[2],
            {k: v for k, v in launches.items() if v})


@dataclass
class _Recorded:
    """A memoized call: the counts it added to its card and to the common
    sums, the rise of its card's live bytes at its peak, and its outputs:
    the tree's spec, each leaf (a tensor's storage index, shape, strides,
    offset, dtype and whether it is the call's card's) and each storage's
    bytes and device."""

    card: tuple
    common: tuple
    peak_rise: int
    spec: Any
    leaves: list
    storages: list


_UNMEMOIZED = object()


def _op_key(obj):
    """An op's or a call's argument as a key: a tensor's shape, strides,
    dtype and device, containers element by element, anything else itself
    (a TypeError where it is not hashable)."""
    if isinstance(obj, torch.Tensor):
        return (obj.shape, obj.stride(), obj.dtype, obj.device)
    if isinstance(obj, (tuple, list)):
        return tuple(map(_op_key, obj))
    if isinstance(obj, dict):
        return tuple((k, _op_key(v)) for k, v in obj.items())
    hash(obj)
    return obj


def _op_spec(func, args, out):
    """How to make ``func``'s outputs again without running it: "self" for
    an in-place op that returned its target; ("one" | "tuple" | "list",
    [(shape, strides, dtype, device)]) for a functional op whose outputs
    are meta tensors, each on a fresh storage of its own that it fills from
    offset 0; else _UNMEMOIZED."""
    schema = func._schema
    if schema.is_mutable:
        writes = [a for a in schema.arguments if a.alias_info is not None
                  and a.alias_info.is_write]
        return "self" if (len(writes) == 1 and writes[0] is schema.arguments[0]
                          and out is args[0]) else _UNMEMOIZED
    if func.is_view or func.overloadpacket in _ALIASES:
        return _UNMEMOIZED
    kind = "one" if isinstance(out, torch.Tensor) else type(out).__name__
    outs = [out] if kind == "one" else out
    if kind not in ("one", "tuple", "list") or not all(
            isinstance(t, torch.Tensor) and t.device.type == "meta" for t in outs):
        return _UNMEMOIZED
    ins = {_key(t) for t in _tensors(args)}
    keys = [_key(t) for t in outs]
    for t, key in zip(outs, keys):
        extent = (sum((n - 1) * st for n, st in zip(t.shape, t.stride())) + 1
                  if t.numel() else 0)
        if (key in ins or keys.count(key) > 1 or t.storage_offset()
                or t.untyped_storage().nbytes() != extent * t.element_size()):
            return _UNMEMOIZED
    return kind, [(t.shape, t.stride(), t.dtype, t.device) for t in outs]


class Tally(TorchDispatchMode):
    """Counts one step run on ``meta`` tensors, card by card (see the module
    docstring).  Open it with ``with tally.running(args_by_shard):``."""

    def __init__(self, degree: int = 1):
        super().__init__()
        self.d = degree
        self.cards = [Card() for _ in range(degree)]
        self.common = Card()                  # amounts that belong to no one card
        self.repl_live = 0                    # replicated bytes alive (on every card)
        self._live: dict[int, tuple[int, Any]] = {}   # storage -> (bytes, owner)
        self._paused = False
        self._args: set[int] = set()
        self._memo: dict = {}
        self._op_memo: dict = {}
        self._watches: list = []              # [owner, start level, top level] of open calls
        self.memo_hits = 0
        self.collectives = {c: 0 for c in COLLECTIVES}
        self.wire = {c: 0.0 for c in COLLECTIVES}

    # ---------------------------------------------------------------- memory
    def _owner(self, tensors) -> Any:
        """The card of the first shard-owned tensor of ``tensors``, else None."""
        for t in tensors:
            entry = self._live.get(_key(t))
            if entry is not None and entry[1] is not None and entry[1] != REPLICATED:
                return entry[1]
        return None

    def _level(self, owner) -> int:
        """Bytes alive on card ``owner`` (card 0's common part for None), scaled."""
        live = self.cards[owner].live * self.d if owner is not None else 0
        return live + self.repl_live * self.d + self.common.live

    def _rise(self, owner, rise: int = 0) -> None:
        """Peaks after a rise of the bytes alive: on ``owner``'s card (every
        card for None or REPLICATED), ``rise`` above what is alive now."""
        every = owner is None or owner == REPLICATED
        for r in (range(self.d) if every else (owner,)):
            card = self.cards[r]
            card.peak = max(card.peak, self._level(r) + rise)
        for w in self._watches:
            w[2] = max(w[2], self._level(w[0]) + rise)

    def _register(self, t: torch.Tensor, owner) -> None:
        """Count ``t``'s storage alive on ``owner`` (a card, REPLICATED or
        None) from now until its last tensor dies (nothing if counted)."""
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._live:
            return
        n = storage.nbytes()
        self._live[key] = (n, owner)
        weakref.finalize(storage, self._free, key)
        if owner is None:
            self.common.live += n
        elif owner == REPLICATED:
            self.repl_live += n
        else:
            self.cards[owner].live += n
        self._rise(owner)

    def _free(self, key: int) -> None:
        n, owner = self._live.pop(key)
        if owner is None:
            self.common.live -= n
        elif owner == REPLICATED:
            self.repl_live -= n
        else:
            self.cards[owner].live -= n

    def _card(self, owner) -> Card:
        return self.common if owner is None else self.cards[owner]

    # ---------------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        out = self._run(func, args, kwargs)
        ins = _flat(kwargs, _flat(args, []))
        outs = _tensors(out)
        owner = self._owner(ins)
        card = self._card(owner)
        scale = 1 if owner is None else self.d
        card.products += scale * product_flops(func, args)
        card.bytes += scale * op_bytes(func, ins, outs)
        for t in outs:
            self._register(t, owner)
        return out

    def _run(self, func, args, kwargs):
        """``func`` on ``meta`` tensors.  Many meta kernels are Python
        (``torch._refs``) and take ~100-400 us a call, so the outputs'
        shapes are kept by the op and its inputs' shapes, strides, dtypes,
        devices and other arguments: a functional op's outputs (each on a
        fresh storage of its own) are made empty again, and an in-place
        op returns its target, without running the kernel.  Views, aliases
        and ops whose results depend on more run every time."""
        try:
            key = (func, _op_key(args), _op_key(kwargs))
        except TypeError:
            return func(*args, **kwargs)
        spec = self._op_memo.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            self._op_memo[key] = _op_spec(func, args, out)
            return out
        if spec is _UNMEMOIZED:
            return func(*args, **kwargs)
        if spec == "self":
            return args[0]
        made = [torch.empty_strided(shape, stride, dtype=dtype, device=device)
                for shape, stride, dtype, device in spec[1]]
        return made if spec[0] == "list" else made[0] if spec[0] == "one" else tuple(made)

    def kernel(self, name: str, flops: int, nbytes: int, like: torch.Tensor) -> None:
        """A kernel's shape function: its operations, bytes and one launch on
        the card of ``like``, its first input."""
        owner = self._owner([like])
        card = self._card(owner)
        scale = 1 if owner is None else self.d
        card.kernels += scale * flops
        card.bytes += scale * nbytes
        card.launches[name] = card.launches.get(name, 0) + scale

    # ---------------------------------------------------------------- memoized calls
    def call(self, fn, args: tuple, kwargs: dict):
        """``fn(*args, **kwargs)``, counted.  A layer function's call whose
        arguments' shapes, dtypes and other values repeat an earlier call's
        (the periods of a stack, the shards of a mesh) is not run again: on
        ``meta`` its ops depend on nothing else, so the first call's counts
        are added again, its peak rise applied, and outputs of its shapes
        made.  Calls that differentiate, or whose outputs alias their
        inputs, always run."""
        ins = _tensors((args, kwargs))
        if self._paused or (torch.is_grad_enabled() and any(t.requires_grad for t in ins)):
            return fn(*args, **kwargs)
        owner = self._owner(ins)
        try:
            key = (fn, owner is None, _op_key(args), _op_key(kwargs))
        except TypeError:
            return fn(*args, **kwargs)
        rec = self._memo.get(key)
        if rec is _UNMEMOIZED:
            return fn(*args, **kwargs)
        if rec is None:
            out, rec = self._record(fn, args, kwargs, ins, owner)
            self._memo[key] = rec
            return out
        self.memo_hits += 1
        return self._replay(rec, owner)

    def _record(self, fn, args, kwargs, ins, owner):
        card, common = self._card(owner), self.common
        before = card.counts(), common.counts()
        watch = [owner, self._level(owner), self._level(owner)]
        self._watches.append(watch)
        try:
            out = fn(*args, **kwargs)
        finally:
            self._watches.remove(watch)
        leaves, spec = tree_flatten(out)
        in_keys = {_key(t) for t in ins}
        tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
        if any(_key(t) in in_keys for t in tensors):
            return out, _UNMEMOIZED
        index: dict[int, int] = {}
        storages, kept = [], []
        for leaf in leaves:
            if not isinstance(leaf, torch.Tensor):
                kept.append(("value", leaf))
                continue
            key = _key(leaf)
            if key not in index:
                index[key] = len(storages)
                storages.append((leaf.untyped_storage().nbytes(), leaf.device))
            mine = owner is not None and self._live.get(key, (0, None))[1] == owner
            kept.append((index[key], tuple(leaf.shape), leaf.stride(), leaf.storage_offset(),
                         leaf.dtype, mine))
        rise = watch[2] - watch[1]
        rec = _Recorded(_minus(card.counts(), before[0]) if owner is not None else
                        (0, 0, 0, {}), _minus(common.counts(), before[1]), rise, spec,
                        kept, storages)
        return out, rec

    def _replay(self, rec: _Recorded, owner):
        if owner is not None:
            self.cards[owner].add(rec.card)
        self.common.add(rec.common)
        self._rise(owner, rec.peak_rise)
        with self._pause():
            bases = [torch.empty(n, dtype=torch.uint8, device=dev) for n, dev in rec.storages]
            leaves = [leaf[1] if leaf[0] == "value" else
                      bases[leaf[0]].view(leaf[4]).as_strided(leaf[1], leaf[2], leaf[3])
                      for leaf in rec.leaves]
        for leaf, spec_leaf in zip(leaves, rec.leaves):
            if spec_leaf[0] != "value":
                self._register(leaf, owner if spec_leaf[5] else None)
        return tree_unflatten(leaves, rec.spec)

    # ---------------------------------------------------------------- collectives
    @contextmanager
    def _pause(self):
        self._paused, was = True, self._paused
        try:
            yield
        finally:
            self._paused = was

    def _fresh(self, like: torch.Tensor, owner, shape=None) -> torch.Tensor:
        with self._pause():
            t = like.new_empty(like.shape if shape is None else shape)
        self._register(t, owner)
        return t

    def broadcast(self, mesh: WorkerMesh, x: torch.Tensor) -> list[torch.Tensor]:
        """Shard 0 keeps ``x``; every other shard gets a copy of its own."""
        return [x] + [self._fresh(x, r) for r in range(1, mesh.degree)]

    def reduce(self, mesh: WorkerMesh, parts) -> list[torch.Tensor]:
        """One all-reduce: every shard gets the sum, a fresh tensor of its own."""
        self.collectives["all-reduce"] += 1
        self.wire["all-reduce"] += WIRE_MULT["all-reduce"] * _nbytes(parts[0])
        return [self._fresh(parts[0], r) for r in range(mesh.degree)]

    def gather(self, mesh: WorkerMesh, parts, dim: int) -> torch.Tensor:
        """One all-gather into a fresh tensor on device 0."""
        shape = list(parts[0].shape)
        shape[dim] = sum(p.shape[dim] for p in parts)
        out = self._fresh(parts[0], 0, tuple(shape))
        self.collectives["all-gather"] += 1
        self.wire["all-gather"] += WIRE_MULT["all-gather"] * _nbytes(out)
        return out

    # ---------------------------------------------------------------- a run
    @contextmanager
    def running(self, shards: list):
        """Count what runs inside, ``shards[r]`` being the argument trees
        card ``r`` holds (a storage listed for more than one card is
        replicated), the layer functions of ``MEMOIZED`` through ``call``."""
        holders: dict[int, set] = {}
        firsts: dict[int, torch.Tensor] = {}
        for r, trees in enumerate(shards):
            for t in _tensors(trees):
                holders.setdefault(_key(t), set()).add(r)
                firsts.setdefault(_key(t), t)
        for key, rs in holders.items():
            t = firsts[key]
            self._register(t, REPLICATED if len(rs) > 1 else next(iter(rs)))
            n = t.untyped_storage().nbytes()
            for r in rs:
                self.cards[r].args += n * self.d
        self._args = set(holders)
        kernel_meta.open_tally(self)
        try:
            with self, _memoized(self):
                yield self
        finally:
            kernel_meta.close_tally(self)

    def count_outputs(self, outputs) -> None:
        """The step's outputs that are not its arguments, on their cards."""
        seen = set(self._args)
        for t in _tensors(outputs):
            key = _key(t)
            if key in seen:
                continue
            seen.add(key)
            n, owner = self._live.get(key, (t.untyped_storage().nbytes(), None))
            if owner == REPLICATED:
                for card in self.cards:
                    card.outputs += n * self.d
            else:
                self._card(owner).outputs += n * (1 if owner is None else self.d)

    def totals(self) -> tuple[int, int]:
        """(product FLOPs, kernel operations) of all the cards together."""
        d, common = self.d, self.common
        return (sum(c.products for c in self.cards) // d + common.products,
                sum(c.kernels for c in self.cards) // d + common.kernels)

    def per_card(self, r: int) -> dict:
        """Card ``r``'s record fields, the common amounts' d-th added."""
        card, common, d = self.cards[r], self.common, self.d
        args = card.args // d
        launches = {k: (card.launches.get(k, 0) + common.launches.get(k, 0)) / d
                    for k in {*card.launches, *common.launches}}
        return {"argument_size_in_bytes": args,
                "output_size_in_bytes": round((card.outputs + common.outputs) / d),
                "temp_size_in_bytes": round(card.peak / d) - args,
                "hlo_flops": float(round((card.products + card.kernels + common.products
                                          + common.kernels) / d)),
                "hlo_bytes": float(round((card.bytes + common.bytes) / d)),
                "product_flops": round((card.products + common.products) / d),
                "kernel_flops": round((card.kernels + common.kernels) / d),
                "kernel_launches": {k: round(v) for k, v in sorted(launches.items())}}


# The layer functions whose calls the tally memoizes (``Tally.call``): those
# the model repeats at one shape a period and a shard, with no collective
# inside.  (module, attribute); the model looks each up there at call time.
MEMOIZED = (("layers", "flash_attention"), ("layers", "attention_full"),
            ("layers", "block_norm"), ("layers", "mlp"), ("layers", "moe"),
            ("layers", "mamba_full_in"), ("layers", "mamba_full_out"), ("layers", "mlstm_in"),
            ("layers", "mlstm_full_out"), ("layers", "slstm_full"), ("model", "_kv_from_full"),
            ("model", "_cross_kv"), ("model", "_logits"))


@contextmanager
def _memoized(tally: Tally):
    """``MEMOIZED``'s functions routed through ``tally.call`` inside, put
    back after."""
    from repro_torch.models import layers, model
    modules = {"layers": layers, "model": model}
    saved = [(modules[m], name, getattr(modules[m], name)) for m, name in MEMOIZED]
    for module, name, fn in saved:
        setattr(module, name, functools.wraps(fn)(
            lambda *a, _fn=fn, **kw: tally.call(_fn, a, kw)))
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


class TalliedMesh(WorkerMesh):
    """A worker mesh whose collectives go to a ``Tally`` while it counts."""

    def __init__(self, devices, tally: Tally):
        super().__init__(tuple(devices))
        object.__setattr__(self, "tally", tally)

    def broadcast(self, x):
        return self.tally.broadcast(self, x)

    def reduce(self, parts):
        return self.tally.reduce(self, parts)

    def gather(self, parts, dim):
        return self.tally.gather(self, parts, dim)


def config_for(arch: str, shape_name: str):
    """(config, skip reason): the combination's config, with the long-context
    window where ``combos`` applies one; None and the reason for a skip."""
    name = arch.replace("-", "_").replace(".", "_")
    for a, s, c in combos(include_skipped=True):
        if a == name and s == shape_name:
            if c is None:
                return None, "encoder-decoder: bounded decoder context"
            return c, None
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.is_subquadratic():
        cfg = cfg.with_sliding_window(LONG_CONTEXT_WINDOW)
    return cfg, None


def reckon(cfg, shape: InputShape, layout: ProductionLayout) -> tuple[dict, Tally]:
    """Build ``shape``'s step for ``cfg`` on ``layout`` over ``meta`` and run
    it under a tally.  Returns (shard 0's fields, and the largest shard's
    where that is another, the tally)."""
    tally = Tally(layout.degree if shape.mode != "train" else 1)
    if shape.mode != "train" and layout.degree > 1:
        layout = ProductionLayout(layout.replicas, TalliedMesh(layout.mesh.devices, tally))
    step = SP.build(cfg, shape, layout)
    with tally.running(step.shards):
        outputs = step.fn(*step.args)
        tally.count_outputs(outputs)
    del outputs
    cards = [tally.per_card(r) for r in range(tally.d)]
    rec = {"degree": step.degree, "replicas": step.replicas, "batch": step.batch,
           "capacity": step.capacity, **cards[0],
           "collective_counts": dict(tally.collectives),
           "collective_bytes": dict(tally.wire),
           "collective_total_bytes": float(sum(tally.wire.values()))}
    r = max(range(len(cards)), key=lambda i: (cards[i]["argument_size_in_bytes"]
                                              + cards[i]["temp_size_in_bytes"]))
    if r:
        rec["largest_shard"] = {"shard": r, **cards[r]}
    return rec, tally


def run_one(arch: str, shape_name: str, multi_pod: bool = False, verbose: bool = True,
            layout: ProductionLayout | None = None, shape: InputShape | None = None
            ) -> dict:
    """Reckon one combination on the production layout (or ``layout``, and
    ``shape`` in place of the named one's, to hold a cut of it on a card);
    returns its record, under the reference's keys where it has them."""
    cfg, skip = config_for(arch, shape_name)
    if cfg is None:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "reason": skip}
    shape = shape or INPUT_SHAPES[shape_name]
    layout = layout or make_production_mesh(multi_pod=multi_pod)
    chips = layout.chips
    t0 = time.time()
    fields, _ = reckon(cfg, shape, layout)
    rec = {"arch": arch, "shape": shape_name, "mode": shape.mode, "mesh": layout.name,
           "chips": chips, **fields, "trace_s": round(time.time() - t0, 1), "status": "ok"}
    if verbose:
        print(f"[{rec['mesh']}] {arch:22s} {shape_name:12s} trace={rec['trace_s']:6.1f}s "
              f"flops={rec['hlo_flops']:.3e} coll={rec['collective_total_bytes']:.3e}B",
              flush=True)
        print(f"    memory: args={rec['argument_size_in_bytes'] / 2**30:.2f}GiB "
              f"out={rec['output_size_in_bytes'] / 2**30:.2f}GiB "
              f"temp={rec['temp_size_in_bytes'] / 2**30:.2f}GiB (per device)", flush=True)
    return rec


CARD_BYTES = 80 * 2**30                  # an H100's 80 GB, the layout's premise


def _figure(x: float) -> str:
    return f"{x:,.0f}" if x >= 100 else f"{x:.3g}"


def table(records: list[dict], mesh: str = "1x8") -> str:
    """A markdown table of ``mesh``'s records, an architecture a row and a
    shape a column: per card, GiB of arguments + temp (** where they pass
    one card's 80 GiB), TFLOPs, and GB of collectives on the wire."""
    rows: dict[str, dict[str, str]] = {}
    for r in records:
        if r["mesh"] != mesh:
            continue
        cell = "skipped"
        if r["status"] == "ok":
            peak = r["argument_size_in_bytes"] + r["temp_size_in_bytes"]
            cell = (f"{r['argument_size_in_bytes'] / 2**30:.1f} + "
                    f"{r['temp_size_in_bytes'] / 2**30:.1f}{' **' if peak > CARD_BYTES else ''}"
                    f"; {_figure(r['hlo_flops'] / 1e12)}; "
                    f"{_figure(r['collective_total_bytes'] / 1e9)}")
        elif r["status"] == "failed":
            cell = "failed"
        rows.setdefault(r["arch"], {})[r["shape"]] = cell
    lines = ["| architecture | " + " | ".join(INPUT_SHAPES) + " |",
             "|---|" + "---|" * len(INPUT_SHAPES)]
    lines += [f"| {arch} | " + " | ".join(cells.get(s, "") for s in INPUT_SHAPES) + " |"
              for arch, cells in rows.items()]
    return "\n".join(lines)


def _summary(records: list[dict]) -> str:
    n = {s: sum(1 for r in records if r["status"] == s) for s in ("ok", "skipped", "failed")}
    return (f"{n['ok']} ok, {n['skipped']} skipped, {n['failed']} failed / "
            f"{len(records)} total")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, choices=[*INPUT_SHAPES, None],
                    help="input shape (default: all)")
    ap.add_argument("--all", action="store_true", help="run every combination")
    ap.add_argument("--multi-pod", action="store_true",
                    help="two hosts, 2x1x8 (default one, 1x8)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="write the JSON records to this file")
    ap.add_argument("--table", action="store_true",
                    help="print a markdown table of each layout's records at the end")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHITECTURES)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    records, failed = [], []
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                try:
                    rec = run_one(arch, shape, multi_pod=mp)
                except Exception as e:
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "status": "failed",
                           "mesh": "2x1x8" if mp else "1x8", "error": str(e)[:2000]}
                    failed.append((arch, shape, mp))
                rec.setdefault("mesh", "2x1x8" if mp else "1x8")
                records.append(rec)
                if rec["status"] == "skipped":
                    print(f"SKIP {arch} {shape}: {rec['reason']}")
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(records, f, indent=1)
    print()
    for name in dict.fromkeys(r["mesh"] for r in records):
        print(f"dry-run [{name}]: {_summary([r for r in records if r['mesh'] == name])}")
    print(f"dry-run: {_summary(records)}")
    if args.table:
        for name in dict.fromkeys(r["mesh"] for r in records):
            print(f"\n[{name}] GiB of arguments + temp (** past 80 GiB); TFLOPs; GB of "
                  f"collectives, a card\n{table(records, name)}")
    if failed:
        print("FAILED:", failed)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
