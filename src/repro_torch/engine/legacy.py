"""Legacy per-sequence-cache rollout worker (counterpart of ``repro/engine/legacy.py``).

The pre-slot-pool data plane, kept as the oracle the slot-pool worker is held
to: each sequence owns a dense cache of batch 1; every batched ``decode()``
call concatenates the caches into a step batch and slices them back after,
O(B * capacity) device copies a call.  Admission is one full-sequence
forward (``model.forward_full(capacity=...)``); a tool output is absorbed
one ``decode_step`` a token.  Its decode runs the dense decode kernel on
CUDA tensors, as every dense cache does.

Sampling uses the slot-pool worker's key discipline: a sequence's key is
``fold_in(PRNGKey(seed + worker_id), seq_id)`` and each step folds in the
context length, so the two workers draw identical tokens at temperature > 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engine import prng
from repro_torch.engine.sampler import SamplerConfig, sample_slots
from repro_torch.engine.worker import PrefixCacheIndex
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def _slice_cache(cache: dict, i: int) -> dict:
    """Batch entry ``i`` of a cache as a cache of batch 1 (copies: a view
    would keep the whole step batch alive)."""
    return {"pos": cache["pos"][i:i + 1].clone(),
            "blocks": M.tree_map(lambda x: x[:, i:i + 1].clone(), cache["blocks"])}


def _concat_caches(caches: list[dict]) -> dict:
    """Caches of batch 1 -> one cache of batch ``len(caches)`` (batch is axis
    1 of the block leaves, axis 0 of ``pos``)."""
    return {"pos": torch.cat([c["pos"] for c in caches]),
            "blocks": M.tree_map(lambda *xs: torch.cat(xs, dim=1),
                                 *[c["blocks"] for c in caches])}


@dataclass
class Sequence:
    seq_id: int
    tokens: list[int]                    # full context (prompt + generated + tool)
    key: np.ndarray                      # (2,) per-sequence sampling key (uint32 in int64)
    generated: int = 0
    cache: Optional[dict] = None         # single-sequence cache (batch dim 1)
    finished: bool = False


class LegacyRolloutWorker:
    """One rollout worker holding model params and a per-sequence cache store.

    ``device=None`` means the card and raises where there is none; pass
    ``device="cpu"`` for the CPU.  ``params`` is moved to ``device`` (a no-op
    for tensors already there).
    """

    def __init__(self, cfg: ModelConfig, params, capacity: int = 256,
                 worker_id: int = 0, sampler: SamplerConfig = SamplerConfig(),
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = M.tree_to(params, self.device)
        self.capacity = capacity
        self.worker_id = worker_id
        self.sampler = sampler
        self.base_key = prng.prng_key(seed + worker_id)
        self.store: dict[int, Sequence] = {}       # resident sequences (incl. preempted)
        self.prefix_index = PrefixCacheIndex()
        self.decode_steps = 0

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.tensor([list(tokens)], dtype=torch.int32, device=self.device)

    def _seq_key(self, seq_id: int) -> np.ndarray:
        return prng.fold_in(self.base_key, seq_id).numpy()

    # ------------------------------------------------------------ lifecycle
    @torch.no_grad()
    def prefill(self, seq_id: int, tokens: list[int]) -> None:
        """Admit a sequence: full-sequence forward builds its KV/state cache."""
        self.prefix_index.match_len(tokens)
        _, _, cache = M.forward_full(self.cfg, self.params, {"tokens": self._tokens(tokens)},
                                     capacity=self.capacity)
        self.store[seq_id] = Sequence(seq_id, list(tokens), self._seq_key(seq_id), cache=cache)
        self.prefix_index.insert(tokens)

    @torch.no_grad()
    def extend(self, seq_id: int, tool_tokens: list[int]) -> None:
        """Absorb tool output into an existing cache (no prefix recompute):
        one decode step a token, teacher-forced."""
        seq = self.store[seq_id]
        if seq.cache is None:
            raise RuntimeError(f"extend() on sequence {seq_id} without a resident cache")
        toks = self._tokens(tool_tokens)
        for j in range(toks.shape[1]):
            M.decode_step(self.cfg, self.params, seq.cache, toks[:, j:j + 1])
        seq.tokens.extend(int(t) for t in tool_tokens)

    @torch.no_grad()
    def decode(self, seq_ids: list[int], n_tokens: int, stop_token: int | None = None
               ) -> dict[int, list[int]]:
        """Batched decode of resident sequences for up to ``n_tokens`` steps."""
        seqs = [self.store[s] for s in seq_ids]
        cache = _concat_caches([s.cache for s in seqs])
        last = torch.tensor([[s.tokens[-1]] for s in seqs], dtype=torch.int32,
                            device=self.device)
        keys = torch.from_numpy(np.stack([s.key for s in seqs])).to(self.device)
        out: dict[int, list[int]] = {s: [] for s in seq_ids}
        live = np.ones(len(seqs), bool)
        for _ in range(n_tokens):
            ctx = torch.tensor([len(s.tokens) for s in seqs], dtype=torch.int64,
                               device=self.device)
            logits, cache = M.decode_step(self.cfg, self.params, cache, last)
            toks = sample_slots(prng.fold_in(keys, ctx), logits, self.sampler)
            self.decode_steps += 1
            # the per-token host sync IS the legacy baseline: the slot-pool
            # worker's fused loop exists to remove it
            toks_np = toks.cpu().numpy()  # heddle: noqa HDL003 -- pre-fusion baseline, measured as such
            for i, s in enumerate(seqs):
                if not live[i]:
                    continue
                t = int(toks_np[i])
                out[s.seq_id].append(t)
                s.tokens.append(t)
                s.generated += 1
                if stop_token is not None and t == stop_token:
                    live[i] = False
            last = toks[:, None]
            if not live.any():
                break
        for i, s in enumerate(seqs):           # split the step batch back
            s.cache = _slice_cache(cache, i)
            self.prefix_index.insert(s.tokens)
        return out

    # ------------------------------------------------------------ control ops
    def preempt(self, seq_id: int) -> None:
        """Evict from the running batch but persist the KV cache (Alg. 1 line 7)."""
        if seq_id not in self.store:
            raise KeyError(seq_id)

    def release(self, seq_id: int) -> None:
        self.store.pop(seq_id, None)

    def migrate_out(self, seq_id: int) -> dict:
        """Package a sequence's context + cache for transfer (§5.3 KV
        migration): the cache bounces through host memory."""
        seq = self.store.pop(seq_id)
        return {"seq_id": seq.seq_id, "tokens": list(seq.tokens), "generated": seq.generated,
                "key": np.asarray(seq.key),
                "cache": M.tree_map(lambda t: t.cpu(), seq.cache)}  # heddle: noqa HDL005 -- legacy per-sequence engine predates the paged pool; host bounce is its only transport

    def migrate_in(self, package: dict) -> None:
        cache = M.tree_map(lambda t: t.to(self.device, copy=True), package["cache"])
        key = package.get("key")
        if key is None:
            key = self._seq_key(package["seq_id"])
        seq = Sequence(package["seq_id"], list(package["tokens"]), np.asarray(key),
                       generated=package["generated"], cache=cache)
        self.store[package["seq_id"]] = seq
        self.prefix_index.insert(seq.tokens)

    def kv_bytes(self, seq_id: int) -> int:
        cache = self.store[seq_id].cache
        return sum(t.numel() * t.element_size() for t in M.tree_leaves(cache))
