"""What the port's tests share that takes only PyTorch, so that the card's
tests (``tests/test_torch_gpu.py``, which import no JAX) share it with the
CPU tests: a tolerance and the examples' loader."""

import importlib.util
from pathlib import Path

import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load_example(name):
    """``examples/torch_<name>.py`` imported as a module."""
    spec = importlib.util.spec_from_file_location(f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
