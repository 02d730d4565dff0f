"""What the port's tests share that takes only PyTorch, so that the card's
tests (``tests/test_torch_gpu.py``, which import no JAX) share it with the
CPU tests: a tolerance and the loader of the examples and ``chip_smoke.py``."""

import importlib.util
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_example(name):
    """``examples/torch_<name>.py`` imported as a module."""
    return _load(f"torch_{name}", EXAMPLES / f"torch_{name}.py")


def load_chip_smoke():
    """``chip_smoke.py`` imported as a module (its phases and helpers)."""
    return _load("chip_smoke", REPO / "chip_smoke.py")


def hold_bf16_cast(got, want, tol, label):
    """``got`` finite, of ``want``'s shape and within ``tol`` x max(1, max
    |want|) of the f32 ``want``; a bf16 ``got`` also within half a bf16 ulp
    of each value, the one rounding of its cast.  Returns the largest |err|."""
    g, w = got.detach().float(), want.float()
    assert g.shape == w.shape, label
    assert bool(torch.isfinite(g).all()), label
    if not w.numel():
        return 0.0
    limit = tol * max(1.0, float(w.abs().max())) * torch.ones_like(w)
    if got.dtype == torch.bfloat16:
        limit = limit + torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 9)
    err = (g - w).abs()
    assert bool((err <= limit).all()), (label, float(err.max()), float(limit.min()))
    return float(err.max())
