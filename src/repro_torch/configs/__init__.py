"""Architecture registry of the port: one module per architecture.

``get_config(name)`` returns the full production config;
``get_config(name).reduced()`` is the CPU test variant.  The registry holds
every architecture of the JAX package, the audio encoder-decoder
(``whisper_medium``) and the vision-language model (``llama_3_2_vision_11b``)
too; those two run through the model API only, since the rollout worker has
no admission path for cross-attention.  ``qwen3_paper`` holds three configs,
reached by their own names (``qwen3-8b``, ``qwen3-14b``, ``qwen3-32b``).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import INPUT_SHAPES, LONG_CONTEXT_WINDOW, ModelConfig

ARCHITECTURES = (
    "smollm_135m",
    "nemotron_4_15b",
    "phi3_medium_14b",
    "jamba_v0_1_52b",
    "qwen2_moe_a2_7b",
    "xlstm_350m",
    "qwen3_1_7b",
    "arctic_480b",
    "whisper_medium",
    "llama_3_2_vision_11b",
)

# the paper's Qwen3 configs: name -> attribute of configs/qwen3_paper.py
PAPER_CONFIGS = {"qwen3-8b": "QWEN3_8B", "qwen3-14b": "QWEN3_14B", "qwen3-32b": "QWEN3_32B"}

_ALIASES = {a.replace("_", "-"): a for a in ARCHITECTURES}
_ALIASES.update({"jamba-v0.1-52b": "jamba_v0_1_52b", "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
                 "qwen3-1.7b": "qwen3_1_7b",
                 "llama-3.2-vision-11b": "llama_3_2_vision_11b"})


def get_config(name: str) -> ModelConfig:
    if name in PAPER_CONFIGS:
        return getattr(importlib.import_module("repro_torch.configs.qwen3_paper"),
                       PAPER_CONFIGS[name])
    mod_name = _ALIASES.get(name, name)
    if mod_name not in ARCHITECTURES:
        raise KeyError(f"unknown architecture {name!r} (known: "
                       f"{', '.join(ARCHITECTURES + tuple(PAPER_CONFIGS))})")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def all_configs() -> dict[str, ModelConfig]:
    """``{architecture: its full config}`` over ``ARCHITECTURES``."""
    return {a: get_config(a) for a in ARCHITECTURES}


def combos(include_skipped: bool = False):
    """Every (architecture, input shape) of the dry run, with the reference's
    rules: the audio encoder-decoder skips ``long_500k`` (its decoder's
    context is bounded), and a config with full attention takes the
    ``LONG_CONTEXT_WINDOW`` sliding window there.  Yields (architecture,
    shape name, config), the config None for a skip when
    ``include_skipped`` holds."""
    for arch in ARCHITECTURES:
        cfg = get_config(arch)
        for shape_name in INPUT_SHAPES:
            if shape_name == "long_500k":
                if cfg.arch_type == "audio":
                    if include_skipped:
                        yield arch, shape_name, None
                    continue
                if not cfg.is_subquadratic():
                    yield arch, shape_name, cfg.with_sliding_window(LONG_CONTEXT_WINDOW)
                    continue
            yield arch, shape_name, cfg
