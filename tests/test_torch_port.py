"""Ground rules of the port that hold for every file of it.

The port and the scripts that run it on the card (chip_smoke.py,
tools/decode_timers.py) import PyTorch and never JAX or the JAX package
(``repro``); the port keeps its own copy of what it needs.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                                 REPO / "tools" / "decode_timers.py"]
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
                "launch/serve.py")


def test_port_files_exist():
    assert len(FILES) > 10 and all(f.exists() for f in FILES)
    for name in ENTRY_POINTS:                  # each slice's entry points are scanned
        assert REPO / "src" / "repro_torch" / name in FILES, name


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_reference_package(path):
    bad = [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"
