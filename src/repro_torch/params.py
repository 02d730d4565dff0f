"""Carry a JAX parameter pytree across to the port.

``from_jax`` takes the pytree of ``repro.models.model.init_params`` as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the same nested dict
of tensors: same key names, same stacked-period layout, same dtypes.  This
module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":            # ml_dtypes.bfloat16: torch cannot read it
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def from_jax(params_np, device=None):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (``None`` means the card; pass ``"cpu"`` for the CPU)."""
    dev = resolve_device(device)
    if isinstance(params_np, dict):
        return {k: from_jax(v, dev) for k, v in params_np.items()}
    return _tensor(params_np, dev)
