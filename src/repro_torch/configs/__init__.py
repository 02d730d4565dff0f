"""Architecture registry of the port: one module per architecture.

``get_config(name)`` returns the full production config;
``get_config(name).reduced()`` is the CPU test variant.  Architectures join
this registry as their slice of the port lands.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHITECTURES = ("qwen3_1_7b", "jamba_v0_1_52b", "smollm_135m")

_ALIASES = {"qwen3-1.7b": "qwen3_1_7b", "qwen3-1-7b": "qwen3_1_7b",
            "jamba-v0.1-52b": "jamba_v0_1_52b", "smollm-135m": "smollm_135m"}


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name)
    if mod_name not in ARCHITECTURES:
        raise KeyError(f"{name!r} is not ported yet (ported: {', '.join(ARCHITECTURES)})")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
