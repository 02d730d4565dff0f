"""Architecture registry of the port: one module per architecture.

``get_config(name)`` returns the full production config;
``get_config(name).reduced()`` is the CPU test variant.  The registry holds
every decoder-only architecture of the JAX package; the audio and
vision-language ones (``whisper_medium``, ``llama_3_2_vision_11b``) join it
with their worker path.  ``qwen3_paper`` holds three configs, reached by
their own names (``qwen3-8b``, ``qwen3-14b``, ``qwen3-32b``).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHITECTURES = (
    "smollm_135m",
    "nemotron_4_15b",
    "phi3_medium_14b",
    "jamba_v0_1_52b",
    "qwen2_moe_a2_7b",
    "xlstm_350m",
    "qwen3_1_7b",
    "arctic_480b",
)

# the paper's Qwen3 configs: name -> attribute of configs/qwen3_paper.py
PAPER_CONFIGS = {"qwen3-8b": "QWEN3_8B", "qwen3-14b": "QWEN3_14B", "qwen3-32b": "QWEN3_32B"}

_ALIASES = {a.replace("_", "-"): a for a in ARCHITECTURES}
_ALIASES.update({"jamba-v0.1-52b": "jamba_v0_1_52b", "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
                 "qwen3-1.7b": "qwen3_1_7b"})


def get_config(name: str) -> ModelConfig:
    if name in PAPER_CONFIGS:
        return getattr(importlib.import_module("repro_torch.configs.qwen3_paper"),
                       PAPER_CONFIGS[name])
    mod_name = _ALIASES.get(name, name)
    if mod_name not in ARCHITECTURES:
        raise KeyError(f"{name!r} is not ported yet (ported: "
                       f"{', '.join(ARCHITECTURES + tuple(PAPER_CONFIGS))}; audio and "
                       "vision-language configs are ROADMAP Queue 1 slice 5 item 3)")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
