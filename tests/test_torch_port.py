"""Ground rules of the port that hold for every file of it.

The port and the scripts that run it on the card (chip_smoke.py,
tools/, examples/torch_*.py) import PyTorch and never JAX or the JAX package
(``repro``); the port keeps its own copy of what it needs.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = (sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
         + sorted((REPO / "tools").glob("*.py")) + sorted((REPO / "examples").glob("torch_*.py")))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


ENTRY_POINTS = ("engine/worker.py", "core/orchestrator.py", "engine/runtime.py",
                "launch/serve.py", "engine/legacy.py", "rl/loop.py", "rl/service.py",
                "launch/train.py", "distributed/sharding.py", "launch/mesh.py",
                "analysis/lint.py", "launch/specs.py", "launch/dryrun.py")


def test_port_files_exist():
    assert len(FILES) > 10 and all(f.exists() for f in FILES)
    for name in ENTRY_POINTS:                  # each slice's entry points are scanned
        assert REPO / "src" / "repro_torch" / name in FILES, name
    examples = {f.name for f in FILES if f.parent.name == "examples"}
    assert examples == {f"torch_{n}.py" for n in ("quickstart", "serve_rollout",
                                                  "orchestration_at_scale",
                                                  "train_agentic_grpo")}


def test_every_ported_config_is_scanned():
    """Each architecture of the port's registry is a module of its own in
    the scanned files, and no config module lies outside the registry."""
    from repro_torch.configs import ARCHITECTURES, PAPER_CONFIGS, get_config

    configs = REPO / "src" / "repro_torch" / "configs"
    modules = {f.stem for f in configs.glob("*.py")} - {"__init__"}
    assert modules == set(ARCHITECTURES) | {"qwen3_paper"}
    for name in modules:
        assert configs / f"{name}.py" in FILES, name
    for name in list(ARCHITECTURES) + list(PAPER_CONFIGS):
        assert get_config(name).n_layers > 0


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_reference_package(path):
    bad = [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"
