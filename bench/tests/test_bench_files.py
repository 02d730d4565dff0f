"""What the harness finds by name, and what it may import."""

from __future__ import annotations

import ast
import json
import sys

import pytest

from bench.tests import _tiny

ROOT = _tiny.ROOT
BENCH = ROOT / "bench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _imports(path) -> set[str]:
    """Top-level names of every module a file imports (absolute imports)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"repro_torch", "jax", "repro"}


def test_a_run_loads_no_jax(monkeypatch):
    """A tiny run in a fresh interpreter leaves no JAX module loaded."""
    import subprocess
    code = ("import sys; sys.path[:0] = [%r, %r]; from bench.tests import _tiny; "
            "from bench import run; run.run_cell(_tiny.spec('qwen3_8b.coding'), 3, 0.5, "
            "False, device='cpu'); print(run.forbidden_modules())") % (str(ROOT),
                                                                       str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_every_cell_resolves_by_name():
    from bench import run
    from bench.metrics import reader
    for cell in SPEC["workloads"]:
        spec = run.cell_spec(SPEC, cell["name"])
        assert spec["end_to_end"] and spec["per_layer"]
        reported = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert all(m["moves"] in reported for m in spec["per_layer"])
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert callable(reader(m["name"]))
        assert set(spec["limits"]) == {"served_gap", "mean_gap", "max_lanes", "min_tokens"}


@pytest.mark.parametrize("folder,suffix,names", [
    ("configs", ".json", [c["file"].rsplit("/", 1)[1][:-5] for c in SPEC["configs"]]),
    ("traffic", ".json", sorted({w["traffic"] for w in SPEC["workloads"]})),
    ("metrics", ".py",
     [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]),
    ("limits", ".json", [w["name"] for w in SPEC["workloads"]]),
])
def test_every_file_is_found_by_a_name(folder, suffix, names):
    """Each data file or reader is named by BENCHMARK.json, and each name has
    its file."""
    have = {p.name[:-len(suffix)] for p in (BENCH / folder).glob("*" + suffix)
            if p.name != "__init__.py"}
    assert have == set(names)


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_configs_are_the_ports(conf):
    """Each configuration file's model is the port's registered config, with
    only the keys it lists as changed (beyond the port's own) moved."""
    import dataclasses
    from repro_torch.configs import get_config
    data = json.loads((ROOT / conf["file"]).read_text())
    model = data["model"]
    port = dataclasses.asdict(get_config(model["name"]))
    port["block_pattern"] = list(port["block_pattern"])
    moved = {k for k in port if port[k] != model[k]}
    assert moved <= set(conf["reduced"]) | set(data.get("departures", {})), moved
    assert conf["reduced"] == data["reduced"]
    assert (BENCH / "reference" / f"{data['reference']}.py").is_file()
