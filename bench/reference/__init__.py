"""The plain float32 reference: imports neither JAX nor the program.

``load(name)`` returns the module ``bench/reference/<name>.py`` that a
configuration file names; ``strict_float32()`` turns TF32 off."""

from __future__ import annotations

import importlib

import torch


def strict_float32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def load(name: str):
    return importlib.import_module(f"bench.reference.{name}")
