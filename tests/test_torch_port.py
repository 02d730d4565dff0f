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


# ---------------------------------------------------------------- completeness

# reference "module:name" -> the port's counterpart "file::name", for the
# public names of the JAX package that the port has under another name
EXEMPT = {
    # the Pallas kernels: sm_90a CUDA (csrc/*.cu) behind the port's wrappers
    "kernels.decode_attention:paged_decode_attention_pallas":
        "kernels/decode_attention.py::paged_decode_attention",
    "kernels.decode_attention:decode_attention_pallas":
        "kernels/decode_attention.py::decode_attention",
    "kernels.mamba_scan:mamba_scan_pallas": "kernels/mamba_scan.py::mamba_scan",
    # the plain scan lives beside the other plain versions
    "kernels.mamba_scan:mamba_scan_ref": "kernels/ref.py::mamba_scan_ref",
    # GSPMD NamedSharding plumbing: the port's split is explicit
    "distributed.sharding:axis_rules": "distributed/sharding.py::logical_pspec",
    "distributed.sharding:current_mesh": "launch/mesh.py::WorkerMesh",
    "distributed.sharding:shard": "distributed/sharding.py::shard_params",
    "distributed.sharding:param_shardings": "distributed/sharding.py::param_pspecs",
    "distributed.sharding:cache_shardings": "distributed/sharding.py::cache_pspecs",
    # the port's meshes are WorkerMesh and have no data axis
    "launch.mesh:make_debug_mesh": "launch/mesh.py::WorkerMesh",
    # collectives are counted in the dry run's TorchDispatchMode, not parsed from HLO
    "launch.dryrun:collective_bytes": "launch/dryrun.py::Tally",
    # ShapeDtypeStruct trees: tensors on the meta device
    "launch.specs:batch_specs": "launch/specs.py::batch_tensors",
    "launch.specs:param_specs": "models/model.py::init_params",
    # knobs that nothing reads: the buffer takes them as arguments,
    # ReplayBuffer(capacity, ...) and take(n_groups, *, max_staleness)
    "rl.service:ServiceConfig": "rl/service.py::ReplayBuffer",
}


def _public_names(path: Path) -> set[str]:
    """A module's public top-level functions and classes and the public
    methods of its top-level classes (``Class.method``), by its AST."""
    defs = (ast.FunctionDef, ast.AsyncFunctionDef)
    names = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, defs + (ast.ClassDef,)) and not node.name.startswith("_"):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, defs) and not m.name.startswith("_")}
    return names


def _modules(root: Path) -> dict[str, set[str]]:
    return {".".join(f.relative_to(root).with_suffix("").parts): _public_names(f)
            for f in sorted(root.rglob("*.py"))}


def missing_counterparts(ref_root: Path, port_root: Path, exempt: dict) -> list[str]:
    """Every public name of the package at ``ref_root`` that the same module
    under ``port_root`` does not define and ``exempt`` does not name, and
    every stale exemption: a name the reference no longer has, one the port
    now defines itself, or a counterpart the port does not define."""
    ref, port = _modules(ref_root), _modules(port_root)
    problems = [f"missing {mod}:{name}" for mod, names in ref.items()
                for name in sorted(names - port.get(mod, set()))
                if f"{mod}:{name}" not in exempt]
    for key, where in exempt.items():
        mod, name = key.split(":")
        file, counterpart = where.split("::")
        if name not in ref.get(mod, set()):
            problems.append(f"stale {key}: the reference has no such name")
        if name in port.get(mod, set()):
            problems.append(f"stale {key}: the port defines it under the same name")
        path = port_root / file
        if not path.is_file() or counterpart not in _public_names(path):
            problems.append(f"stale {key}: its counterpart {where} is not in the port")
    return problems


def test_every_public_name_has_a_counterpart():
    assert missing_counterparts(REPO / "src" / "repro", REPO / "src" / "repro_torch",
                                EXEMPT) == []


def _tree(root: Path, files: dict) -> Path:
    for rel, text in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    return root


REF_TREE = {"__init__.py": "",
            "engine/sampler.py": "def sample(): ...\ndef _private(): ...\n"
                                 "class Config:\n    def scale(self): ...\n"
                                 "    def _hidden(self): ...\n",
            "kernels/scan.py": "def scan_pallas(): ...\n"}
PORT_TREE = {"__init__.py": "",
             "engine/sampler.py": "def sample(): ...\nclass Config:\n    def scale(self): ...\n",
             "kernels/scan.py": "def scan(): ...\n"}


@pytest.mark.parametrize("port_edit, exempt, want", [
    ({}, {"kernels.scan:scan_pallas": "kernels/scan.py::scan"}, []),
    ({"engine/sampler.py": "class Config:\n    def scale(self): ...\n"},
     {"kernels.scan:scan_pallas": "kernels/scan.py::scan"}, ["missing engine.sampler:sample"]),
    ({"engine/sampler.py": "def sample(): ...\nclass Config: ...\n"},
     {"kernels.scan:scan_pallas": "kernels/scan.py::scan"},
     ["missing engine.sampler:Config.scale"]),
    ({}, {}, ["missing kernels.scan:scan_pallas"]),
    ({}, {"kernels.scan:scan_pallas": "kernels/scan.py::scan",
          "kernels.scan:gone": "kernels/scan.py::scan"},
     ["stale kernels.scan:gone: the reference has no such name"]),
    ({"kernels/scan.py": "def scan(): ...\ndef scan_pallas(): ...\n"},
     {"kernels.scan:scan_pallas": "kernels/scan.py::scan"},
     ["stale kernels.scan:scan_pallas: the port defines it under the same name"]),
    ({}, {"kernels.scan:scan_pallas": "kernels/scan.py::scan_fast"},
     ["stale kernels.scan:scan_pallas: its counterpart kernels/scan.py::scan_fast is not in "
      "the port"]),
    ({}, {"kernels.scan:scan_pallas": "kernels/gone.py::scan"},
     ["stale kernels.scan:scan_pallas: its counterpart kernels/gone.py::scan is not in the "
      "port"]),
], ids=["complete", "missing-function", "missing-method", "unexempted", "stale-reference",
        "stale-same-name", "stale-counterpart", "stale-counterpart-file"])
def test_counterpart_check_reports_each_gap(tmp_path, port_edit, exempt, want):
    ref = _tree(tmp_path / "ref", REF_TREE)
    port = _tree(tmp_path / "port", {**PORT_TREE, **port_edit})
    assert missing_counterparts(ref, port, exempt) == want
