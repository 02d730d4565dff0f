"""GRPO (Group Relative Policy Optimization), the training phase's algorithm
(counterpart of ``repro/rl/grpo.py``).

The rollout phase produces groups of trajectories per prompt; GRPO
normalizes rewards within each group into advantages and optimizes the
clipped policy-ratio objective.  ``make_train_step`` takes the place of
``jax.value_and_grad``: it differentiates with ``torch.autograd.grad`` with
respect to detached leaf aliases of the params, so the caller's tensors never
get ``requires_grad``, and applies the functional AdamW.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.rl.optimizer import AdamW, AdamWState

F32 = torch.float32


def group_advantages(rewards: torch.Tensor, group_size: int) -> torch.Tensor:
    """GRPO advantage: per-group reward z-score (population std, as
    ``jnp.std``).  rewards: (B,) with B % group == 0."""
    g = rewards.reshape(-1, group_size).to(F32)
    mean = g.mean(dim=1, keepdim=True)
    std = g.std(dim=1, keepdim=True, correction=0)
    return ((g - mean) / (std + 1e-6)).reshape(-1)


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Log-prob of tokens[t+1] under logits[t] (next-token).  Shapes (B,S,V),
    (B,S); the last position is zero."""
    lse = torch.logsumexp(logits.to(F32), dim=-1)                    # (B, S)
    tgt = tokens[:, 1:].long()
    tgt_logit = torch.gather(logits[:, :-1], -1, tgt[..., None])[..., 0]
    lp = tgt_logit.to(F32) - lse[:, :-1]
    return F.pad(lp, (0, 1))


def _chunk_logprobs(xc: torch.Tensor, head: torch.Tensor, tg: torch.Tensor) -> torch.Tensor:
    logits = xc @ head                                               # (B, chunk, V)
    lse = torch.logsumexp(logits.to(F32), dim=-1)
    tl = torch.gather(logits, -1, tg[..., None])[..., 0]
    return tl.to(F32) - lse


def chunked_token_logprobs(cfg: ModelConfig, params, hidden: torch.Tensor,
                           tokens: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Fused linear + cross-entropy over sequence chunks: the (B, chunk, V)
    logits tile is the only logits tensor that exists, in the forward and
    (each chunk checkpointed, so run again) in the backward."""
    head = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    nc = -(-S // chunk)
    pad = nc * chunk - S
    targets = F.pad(tokens[:, 1:].long(), (0, 1 + pad))              # predict t+1 from t
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
    parts = []
    for c in range(nc):
        cols = slice(c * chunk, (c + 1) * chunk)
        parts.append(torch.utils.checkpoint.checkpoint(
            _chunk_logprobs, hidden[:, cols], head, targets[:, cols], use_reentrant=False))
    lp = torch.cat(parts, dim=1)[:, :S]
    return F.pad(lp[:, :-1], (0, 1))                                 # last position: no target


def policy_logprobs(cfg: ModelConfig, params, batch, remat: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(per-token logprobs, MoE aux loss) without forming the full logits."""
    hidden, aux = M.forward_full(cfg, params, batch, remat=remat, return_hidden=True)
    return chunked_token_logprobs(cfg, params, hidden, batch["tokens"]), aux


@dataclass(frozen=True)
class GRPOConfig:
    clip_eps: float = 0.2
    kl_coef: float = 0.0                 # optional KL to reference (0 = DAPO-style off)
    aux_coef: float = 0.01               # MoE load-balance loss weight
    group_size: int = 16                 # samples per prompt (paper: 16)


def grpo_loss(cfg: ModelConfig, gcfg: GRPOConfig, params, batch
              ) -> tuple[torch.Tensor, dict]:
    """batch: tokens (B,S) int, loss_mask (B,S) f32 (1 on response tokens),
    advantages (B,) f32, old_logprobs (B,S) f32 (behavior policy), plus
    modality extras."""
    logp, aux = policy_logprobs(cfg, params, batch, remat=True)
    old = batch["old_logprobs"]
    ratio = torch.exp(logp - old)
    adv = batch["advantages"][:, None].to(F32)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - gcfg.clip_eps, 1 + gcfg.clip_eps) * adv
    mask = batch["loss_mask"].to(F32)
    per_tok = -torch.minimum(unclipped, clipped) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    pg_loss = per_tok.sum() / denom
    kl = ((logp - old) * mask).sum() / denom
    loss = pg_loss + gcfg.aux_coef * aux + gcfg.kl_coef * kl
    return loss, {"pg_loss": pg_loss, "aux_loss": aux, "approx_kl": kl}


def value_and_grad(loss_fn, params):
    """(loss, aux, grads) of ``loss_fn(params) -> (loss, aux)``: the loss
    differentiated with respect to detached aliases of every leaf (the
    caller's tensors are not touched); leaves the loss does not reach get
    zeros, as ``jax.grad`` gives them."""
    leaves = M.tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = list(M.tree_leaves(leaves))
    with torch.enable_grad():
        loss, aux = loss_fn(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): g if g is not None else torch.zeros_like(p)
             for p, g in zip(flat, grads)}
    aux = M.tree_map(lambda t: t.detach(), aux)
    return loss.detach(), aux, M.tree_map(lambda p: by_id[id(p)], leaves)


def make_train_step(cfg: ModelConfig, gcfg: GRPOConfig | None = None,
                    opt: AdamW | None = None):
    """(params, opt_state, batch) -> (params', opt_state', metrics); the
    inputs are left as they were."""
    gcfg = gcfg or GRPOConfig()
    opt = opt or AdamW()

    def train_step(params, opt_state: AdamWState, batch):
        loss, metrics, grads = value_and_grad(
            lambda p: grpo_loss(cfg, gcfg, p, batch), params)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def make_lm_train_step(cfg: ModelConfig, opt: AdamW | None = None):
    """Plain next-token LM step: the masked mean negative log-likelihood plus
    0.01 x the MoE aux loss, then the functional AdamW."""
    opt = opt or AdamW()

    def loss_fn(params, batch):
        logp, aux = policy_logprobs(cfg, params, batch)
        mask = batch.get("loss_mask")
        mask = torch.ones_like(logp) if mask is None else mask.to(F32)
        loss = -(logp * mask).sum() / torch.clamp(mask.sum(), min=1.0) + 0.01 * aux
        return loss, {}

    def train_step(params, opt_state, batch):
        loss, _, grads = value_and_grad(lambda p: loss_fn(p, batch), params)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss}

    return train_step
