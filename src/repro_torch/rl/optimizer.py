"""AdamW as plain functions on nested dicts of tensors (counterpart of
``repro/rl/optimizer.py``).

``update`` is functional: it returns new tensors and leaves its inputs as
they were.  Rollout workers and staged weight syncs hold the trainer's
tensors by reference, so an update in place would switch resident lanes to
the new policy mid-trajectory.  The arithmetic is the JAX package's, and not
``torch.optim.AdamW``'s: a global-norm clip over every leaf in f32, moments
kept in ``moment_dtype`` (f32 by default) whatever the parameter's dtype,
weight decay added to the update (``u + wd * p``), and the new parameter
computed in f32, then cast to the parameter's dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.models import model as M

F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


class AdamWState(NamedTuple):
    step: torch.Tensor        # () int32
    mu: Any
    nu: Any


@dataclass(frozen=True)
class AdamW:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    moment_dtype: str = "float32"

    def init(self, params) -> AdamWState:
        mdt = _DTYPES[self.moment_dtype]
        device = next(M.tree_leaves(params)).device

        def zeros():
            return M.tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params)
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device), zeros(), zeros())

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """(new params, new state); ``grads``, ``state`` and ``params`` are
        left untouched.  One leaf at a time, so that no f32 copy of the
        whole gradient tree exists at once."""
        scale = None
        if self.grad_clip:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for g in M.tree_leaves(grads)))
            scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        step = state.step + 1
        b1, b2, mdt = self.b1, self.b2, _DTYPES[self.moment_dtype]
        stepf = step.to(F32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=F32, device=stepf.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=F32, device=stepf.device), stepf)

        def leaf(p, g, m, v):
            g = g.to(F32) if scale is None else g.to(F32) * scale
            m = (b1 * m.to(F32) + (1 - b1) * g).to(mdt)
            v = (b2 * v.to(F32) + (1 - b2) * torch.square(g)).to(mdt)
            u = (m.to(F32) / bc1) / (torch.sqrt(v.to(F32) / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.to(F32)
            return (p.to(F32) - self.lr * u).to(p.dtype), m, v

        out = M.tree_map(leaf, params, grads, state.mu, state.nu)
        new_params, mu, nu = (M.tree_map(lambda t, i=i: t[i], out) for i in range(3))
        return new_params, AdamWState(step, mu, nu)
