"""The step and its arguments for every (architecture x input shape)
(counterpart of ``repro/launch/specs.py``).

This is the contract between the model zoo and the dry run
(``launch/dryrun.py``): for each mode, train, prefill or decode, ``build``
returns the port's step function and its arguments, made on the layout's
device: ``meta`` tensors in the dry run (nothing allocated), a card's when
the dry run's reckoning is held against a real step.  The reference returns
``ShapeDtypeStruct`` specs and shardings for GSPMD; the port's arguments are
already cut, one tree per shard, since its tensor-parallel paths take lists
of shards.

* train: the GRPO loss and its gradients (``rl/grpo.py``, remat on), then
  the functional AdamW, moments in bf16 for a bf16 config as in the
  reference.  The port's trainer runs on one card, so the step runs at MP
  degree 1, every card a replica with its share of the batch; no gradient
  reduction is reckoned, since the port performs none.
* prefill: ``forward_full`` with a cache of ``decode_capacity`` slots,
  returning the last position's logits and the cache.
* decode: one ``decode_step`` over a dense cache whose every slot is valid
  (``start_pos = seq_len - 1``), with the encoder's or the image's cross K/V
  for the audio and VLM configs.

Prefill and decode run at the layout's MP degree, through
``init_params(mesh=)``, ``shard_cache`` and the model's ``mesh=`` paths.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.distributed.sharding import shard_cache, tp_split
from repro_torch.launch.mesh import ProductionLayout
from repro_torch.models import model as M
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.rl.grpo import GRPOConfig, make_train_step
from repro_torch.rl.optimizer import AdamW

SEED = 0


@dataclass
class Step:
    """One step to run: ``fn(*args)``.  ``shards[r]`` lists the argument
    trees that shard ``r`` holds on its card (leaves shared between shards
    are replicated: each card holds its own)."""

    fn: Callable
    args: tuple
    degree: int               # the MP degree the step runs at
    replicas: int             # the layout's replicas of it
    batch: int                # a replica's batch
    capacity: int | None      # cache slots (prefill and decode)
    shards: list


def make_optimizer(cfg: ModelConfig) -> AdamW:
    """The reference's production optimizer: bf16 moments for a bf16 config."""
    return AdamW(lr=1e-4, moment_dtype="bfloat16" if cfg.dtype == "bfloat16"
                 else "float32")


def decode_capacity(cfg: ModelConfig, shape: InputShape) -> int:
    """Cache slots of a lane: the window with one, else the shape's context."""
    if cfg.sliding_window:
        return min(shape.seq_len, cfg.sliding_window)
    return shape.seq_len


def cross_len(cfg: ModelConfig) -> int | None:
    """Frames (audio) or patches (VLM) the cross-attention attends to."""
    return {"audio": cfg.encoder_seq, "vlm": cfg.image_seq}.get(cfg.arch_type)


def batch_tensors(cfg: ModelConfig, B: int, S: int, mode: str, device) -> dict:
    """The data batch of one step (the reference's ``batch_specs``), zeros:
    a train or prefill batch's tokens (and a train batch's loss mask,
    advantages and old log-probs), and the frame or patch embeddings in the
    model's dtype."""
    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    batch: dict[str, Any] = {}
    if mode in ("train", "prefill"):
        batch["tokens"] = zeros((B, S), torch.int32)
    if mode == "train":
        batch["loss_mask"] = zeros((B, S), torch.float32)
        batch["advantages"] = zeros((B,), torch.float32)
        batch["old_logprobs"] = zeros((B, S), torch.float32)
    T = cross_len(cfg)
    if T is not None:
        name = "encoder_embeds" if cfg.arch_type == "audio" else "image_embeds"
        batch[name] = zeros((B, T, cfg.d_model), M.torch_dtype(cfg))
    return batch


def build(cfg: ModelConfig, shape: InputShape, layout: ProductionLayout) -> Step:
    """The step of ``shape.mode`` for ``cfg`` on ``layout``, its arguments
    made on the layout's device (``layout.mesh.devices[0]``): weights drawn
    from ``SEED`` (on ``meta`` nothing is drawn), token and embedding inputs
    zeros, caches and optimizer state as their own ``init`` makes them."""
    mode = shape.mode
    dev = layout.mesh.devices[0]
    if mode == "train":
        B = layout.batch(shape.global_batch, layout.chips)
        params = M.init_params(cfg, SEED, device=dev)
        opt = make_optimizer(cfg)
        args = (params, opt.init(params), batch_tensors(cfg, B, shape.seq_len, mode, dev))
        return Step(make_train_step(cfg, GRPOConfig(), opt), args, 1, layout.chips, B, None,
                    [list(args)])

    degree = layout.degree
    mesh = layout.mesh if degree > 1 else None
    B = layout.batch(shape.global_batch, layout.replicas)
    capacity = decode_capacity(cfg, shape)
    params = M.init_params(cfg, SEED, mesh=mesh) if mesh else M.init_params(cfg, SEED, dev)
    shard_params = params if mesh else [params]
    if mode == "prefill":
        batch = batch_tensors(cfg, B, shape.seq_len, mode, dev)

        def prefill_step(params, batch):
            logits, _, cache = M.forward_full(cfg, params, batch, capacity=capacity, mesh=mesh)
            return logits[:, -1], cache

        return Step(prefill_step, (params, batch), degree, layout.replicas, B, capacity,
                    [[p] + ([batch] if r == 0 else []) for r, p in enumerate(shard_params)])

    cache = M.init_cache(cfg, B, capacity, dev, start_pos=shape.seq_len - 1,
                         enc_len=cross_len(cfg))
    if mesh:
        cache = shard_cache(cache, tp_split(cfg, degree), mesh)
    caches = cache if mesh else [cache]
    tokens = torch.zeros((B, 1), dtype=torch.int32, device=dev)

    def serve_step(params, cache, tokens):
        return M.decode_step(cfg, params, cache, tokens, mesh=mesh)

    return Step(serve_step, (params, cache, tokens), degree, layout.replicas, B, capacity,
                [[p, c] + ([tokens] if r == 0 else [])
                 for r, (p, c) in enumerate(zip(shard_params, caches))])
