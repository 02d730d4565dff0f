"""Weights from the seed, made on the device, in the port's parameter tree.

The tree's names, shapes and dtypes are the port's (``init_params`` on the
``meta`` device, drawing nothing); the values are the harness's own: one
draw of a ``torch.Generator`` on the device per leaf, every period of a
stacked leaf in the same call, in the dtype the leaf is served in.  Scales
follow the usual decoder initialisation: N(0, 0.02) for projections and
embeddings, 0.02 / sqrt(2 * layers) for the products that write the residual
stream, 1 / sqrt(fan-in) for the Mamba conv and dt projection, ones for norm
scales and the Mamba skip, and A_log = log(1..N) (S4D-real).  The reference
reads these same tensors.
"""

from __future__ import annotations

import math

import torch

# leaves that write into the residual stream
_RESIDUAL_OUT = ("wo", "w_out", "we_out", "m_out")


def _scale(cfg: dict, name: str, shape: tuple[int, ...]) -> float | None:
    """The normal draw's scale of a leaf, or None for a constant leaf."""
    n_layers = len(cfg["block_pattern"]) * cfg["n_periods"]
    if name in ("scale", "q_norm", "k_norm", "m_D", "m_Alog"):
        return None
    if name in _RESIDUAL_OUT:
        return 0.02 / math.sqrt(2 * n_layers)
    if name == "m_conv":
        return 1.0 / math.sqrt(cfg["ssm_conv_width"])
    if name == "m_dtproj":
        return 1.0 / math.sqrt(shape[-2])
    return 0.02


def _fill(leaf: torch.Tensor, name: str, cfg: dict, gen: torch.Generator, device
          ) -> torch.Tensor:
    shape = tuple(leaf.shape)
    if name == "m_Alog":
        n = torch.arange(1, shape[-1] + 1, dtype=leaf.dtype, device=device)
        return torch.log(n).expand(shape).contiguous()
    scale = _scale(cfg, name, shape)
    if scale is None:
        return torch.ones(shape, dtype=leaf.dtype, device=device)
    return torch.randn(shape, generator=gen, dtype=leaf.dtype, device=device).mul_(scale)


def layout(model_cfg) -> dict:
    """The port's params tree on the ``meta`` device, shapes and dtypes only.

    ``init_params`` draws each leaf with a generator and builds A_log with a
    cumulative sum and a log, which on ``meta`` route through PyTorch's
    compiler stack and import it (seconds of set-up); with the three
    shape-only for the call, nothing is drawn and nothing more is imported."""
    from unittest import mock

    from repro_torch.models import model as M

    def shape_only(shape, generator=None, device=None, dtype=None):
        return torch.empty(shape, device="meta", dtype=dtype)

    with mock.patch.object(torch, "randn", shape_only), \
            mock.patch.object(torch.Tensor, "cumsum", lambda t, dim: t), \
            mock.patch.object(torch, "log", lambda t: t):
        return M.init_params(model_cfg, device="meta")


def make(model_cfg, cfg: dict, seed: int, device) -> dict:
    """The params tree of ``model_cfg`` (the port's ``ModelConfig`` built
    from the configuration file's ``model``, here ``cfg``) with values drawn
    from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(v) if isinstance(v, dict) else _fill(v, k, cfg, gen, device)
                    for k, v in tree.items()}
        raise TypeError("a params tree is a dict of dicts and tensors")

    return build(layout(model_cfg))
