"""The port's heddle-lint against the JAX package's, and in torch spelling.

HDL001, HDL002 and HDL004 read the same Python either way: on every fixture
of ``tests/fixtures/lint/`` the port gives the reference linter's
``(rule, line, col)`` under the same forced scope.  HDL003 and HDL005, and
HDL001's torch RNG cases, read torch: their fixtures are inline sources here,
with pinned hits and silent negatives.  The gate is that the port and its
examples lint clean, and the port's noqas are exactly the reference's four
justified host bounces.
"""

import re
from pathlib import Path

import pytest

from repro.analysis.lint import lint_source as jax_lint_source
from repro.analysis.rules.base import Scope as JaxScope
from repro_torch.analysis.lint import lint_paths, lint_source, main as lint_main, \
    scope_for_path
from repro_torch.analysis.rules.base import Scope

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "lint"
PORT = REPO / "src" / "repro_torch"
EXAMPLES = sorted((REPO / "examples").glob("torch_*.py"))
FULL = Scope.CONTROL | Scope.CORE
SCOPES = {"full": (FULL, JaxScope.CONTROL | JaxScope.CORE),
          "control": (Scope.CONTROL, JaxScope.CONTROL),
          "none": (Scope.NONE, JaxScope.NONE)}
SHARED = ("HDL001", "HDL002", "HDL004")


def _hits(source: str, scope: Scope = FULL):
    return [(v.rule, v.line) for v in lint_source(source, path="fixture.py", scope=scope)]


# ------------------------------------------------------- the reference's rules

@pytest.mark.parametrize("scope", sorted(SCOPES))
@pytest.mark.parametrize("name", sorted(p.name for p in FIXTURES.glob("*.py")))
def test_shared_rules_match_the_reference_on_its_fixtures(name, scope):
    """HDL001, HDL002 and HDL004 on every reference fixture: the port's
    violations are the reference linter's, position for position."""
    source = (FIXTURES / name).read_text()
    port_scope, jax_scope = SCOPES[scope]
    want = [(v.rule, v.line, v.col) for v in
            jax_lint_source(source, path=name, scope=jax_scope, select=SHARED)]
    got = [(v.rule, v.line, v.col) for v in
           lint_source(source, path=name, scope=port_scope, select=SHARED)]
    assert got == want
    if scope == "full" and name.startswith(("hdl001", "hdl002", "hdl004")):
        assert got, "a fixture of a shared rule must have hits"


# ------------------------------------------------------- HDL001: torch's RNG

TORCH_RNG = '''\
"""HDL001 torch fixture (linted as CONTROL)."""
import torch
from torch import randn


def draw(n):
    a = torch.rand(n)                              # line 7
    b = randn(n)                                   # line 8: imported name
    c = torch.randint(0, 10, (n,))                 # line 9
    d = torch.randperm(n)                          # line 10
    e = torch.multinomial(a, 1)                    # line 11
    f = torch.normal(0.0, 1.0, (n,))               # line 12
    g = torch.bernoulli(a)                         # line 13
    h = torch.rand_like(a)                         # line 14
    a.uniform_()                                   # line 15: in place
    torch.manual_seed(0)                           # line 16
    torch.seed()                                   # line 17
    torch.cuda.manual_seed_all(0)                  # line 18
    return a, b, c, d, e, f, g, h


def seeded_ok(n, seed):
    gen = torch.Generator().manual_seed(seed)      # fine: an explicit generator
    a = torch.rand(n, generator=gen)               # fine
    b = torch.multinomial(a, 1, generator=gen)     # fine
    a.uniform_(generator=gen)                      # fine
    return torch.randn(n, generator=gen) + b       # fine
'''


def test_hdl001_flags_torch_global_generator_exact_lines():
    assert _hits(TORCH_RNG, Scope.CONTROL) == [("HDL001", n) for n in range(7, 19)]


def test_hdl001_torch_rng_is_control_plane_only():
    assert _hits(TORCH_RNG, Scope.NONE) == []


# ------------------------------------------------------- HDL003 in torch spelling

HDL003 = '''\
"""HDL003 torch fixture: host syncs in hot loops."""
import numpy as np
import torch


def decode_loop(tokens, emitted, live):
    parts = []
    for tok in tokens:
        parts.append(tok.cpu())                 # line 9
        done = emitted.item()                   # line 10
        host = tok.numpy()                      # line 11
        moved = tok.to("cpu")                   # line 12
        moved = tok.to(device="cpu")            # line 13
        torch.cuda.synchronize()                # line 14
        arr = np.asarray(tok)                   # line 15
        n = int(live.sum())                     # line 16
        stop = bool(live.any())                 # line 17
        ids = tok.tolist()                      # line 18
        if done or stop:
            break
    return parts, host, moved, arr, n, ids


def _prefill_chunks(chunks, pos):
    while chunks:
        for c in chunks.pop():
            pos = float(c.max())                # line 27: nested loops, once
    return pos


def extend_ok(tokens, dev):
    out = []
    for tok in tokens:
        out.append(tok.to(dev))                 # fine: device to device
        out.append(int(np.sum(tok.shape)))      # fine: a numpy reduction
    host = torch.stack(out).cpu()               # fine: after the loop
    return host, host.sum().item()              # fine: outside any loop


def cold_path(xs):
    for x in xs:
        x.item()                                # fine: not a decode/prefill/extend
'''


def test_hdl003_torch_host_syncs_exact_lines():
    assert _hits(HDL003) == [("HDL003", n) for n in range(9, 19)] + [("HDL003", 27)]


def test_hdl003_binds_in_every_scope():
    assert _hits(HDL003, Scope.NONE) == _hits(HDL003)


# ------------------------------------------------------- HDL005 in torch spelling

HDL005 = '''\
"""HDL005 torch fixture: host-gathers of KV on migration paths."""
import numpy as np

from repro_torch.models import model as M


def migrate_out(seq, pool):
    pkg = {"tokens": list(seq.tokens)}
    pkg["cache"] = M.tree_map(lambda t: t.cpu(), pool)     # line 9: mapped gather
    pkg["key"] = np.asarray(seq.key)                        # fine: metadata, not KV
    pkg["slot"] = seq.slot_ids.cpu()                        # fine: metadata
    return pkg


def checkpoint_lane(lane, blocks, pages):
    host = lane.cpu()                                       # line 16
    resident = np.asarray(blocks)                           # line 17
    flat = pages.to("cpu")                                  # line 18
    arr = pages.numpy()                                     # line 19
    return host, resident, flat, arr


def checkpoint_out(pkg):
    for name in ("cache", "pages", "state"):
        pkg[name] = M.tree_to(pkg[name], "cpu")             # line 25: KV keys by loop
    pkg["meta"] = M.tree_to(pkg["meta"], device="cpu")      # fine: not KV
    return pkg


def restore_cache(package, device):
    return M.tree_to(package["cache"], device)              # fine: host -> device


def migrate_mapped(seq, pool):
    a = M.tree_map(np.asarray, seq.cache)                   # line 35
    b = M.tree_map(lambda t: t.to("cpu"), pool)             # line 36
    c = M.tree_map(lambda t: t.to(t.device), pool)          # fine: stays on device
    d = M.tree_to(pool, device="cpu")                       # line 38
    return a, b, c, d


def gather_stats(pool):
    return pool["cache"].cpu()                              # fine: not a migration fn


def migrate_with_noqa(pool):
    return M.tree_map(lambda t: t.cpu(), pool)  # heddle: noqa HDL005 -- durability copy
'''


def test_hdl005_torch_kv_host_gather_exact_lines():
    assert _hits(HDL005) == [("HDL005", n) for n in (9, 16, 17, 18, 19, 25, 35, 36, 38)]


def test_hdl005_binds_in_every_scope():
    assert _hits(HDL005, Scope.NONE) == _hits(HDL005)


# ---------------------------------------------------------------- suppression

NOQA = '''\
import torch


def draw(n):
    return torch.rand(n)  # heddle: noqa HDL001 -- fixture: by id


def decode(tokens):
    for t in tokens:
        t.item()  # heddle: noqa -- fixture: bare
    for t in tokens:
        t.item()  # heddle: noqa HDL001
'''


def test_noqa_suppresses_by_id_and_bare():
    """Line 5 (HDL001 noqa) and line 10 (bare) are silenced; the HDL001
    noqa on line 12 does not silence that line's HDL003 hit."""
    assert _hits(NOQA) == [("HDL003", 12)]


# -------------------------------------------------------------------- scoping

@pytest.mark.parametrize("path, scope", [
    ("src/repro_torch/core/orchestrator.py", FULL),
    ("src/repro_torch/engine/worker.py", Scope.CONTROL),
    ("src/repro_torch/rl/loop.py", Scope.CONTROL),
    ("src/repro_torch/analysis/lint.py", Scope.NONE),
    ("src/repro_torch/models/model.py", Scope.NONE),
    ("examples/torch_quickstart.py", Scope.NONE),
    ("src/repro/core/orchestrator.py", Scope.NONE),       # the reference's tree
])
def test_scope_for_path(path, scope):
    assert scope_for_path(path) == scope


# ---------------------------------------------------------------- the CLI

def test_cli_exit_status_counts_violations(tmp_path, capsys):
    """Outside the port's control plane only the unscoped rules apply, and
    the exit code is the violation count."""
    f = tmp_path / "hot.py"
    f.write_text(HDL003)
    assert lint_main([str(f)]) == 11
    out = capsys.readouterr().out
    assert "HDL003" in out and "hot.py" in out
    assert lint_main([str(f), "--select", "HDL005", "--quiet"]) == 0


def test_syntax_error_reported_not_raised():
    vs = lint_source("def broken(:\n", path="bad.py")
    assert [v.rule for v in vs] == ["HDL000"]


# ---------------------------------------------------------------- the gate

def test_port_and_examples_are_lint_clean():
    """The enforced gate: ``python -m repro_torch.analysis.lint src/repro_torch
    examples/torch_*.py`` exits 0."""
    assert EXAMPLES
    assert lint_paths([str(PORT), *map(str, EXAMPLES)]) == []


_NOQA = re.compile(r"#\s*heddle:\s*noqa\s+(HDL\d{3})\s+--\s+(.*)$")
# the port's justified host bounces: (file, rule, the flagged statement)
NOQA_SITES = [
    ("engine/worker.py", "HDL003", "n_live = int(live_t.sum())"),
    ("engine/worker.py", "HDL005", 'pkg[name] = M.tree_to(pkg[name], "cpu")'),
    ("engine/legacy.py", "HDL003", "toks_np = toks.cpu().numpy()"),
    ("engine/legacy.py", "HDL005", '"cache": M.tree_map(lambda t: t.cpu(), seq.cache)}'),
]


def _noqas(root: Path) -> list[tuple[str, str, str, str]]:
    """(file, rule, statement, reason) of every ``# heddle: noqa HDLxxx --``."""
    out = []
    for f in sorted(root.rglob("*.py")):
        for line in f.read_text().splitlines():
            m = _NOQA.search(line)
            if m and "analysis" not in f.parts:
                out.append((str(f.relative_to(root)), m.group(1),
                            line[:m.start()].strip(), m.group(2).strip()))
    return out


def test_port_noqas_are_the_reference_four():
    """The port carries exactly four noqas, and each has a noqa of the same
    rule with the same reason in the same reference module."""
    got = _noqas(PORT)
    assert [(f, rule, stmt) for f, rule, stmt, _ in got] == sorted(NOQA_SITES)
    reference = _noqas(REPO / "src" / "repro")
    for f, rule, _, reason in got:
        assert any(rf == f and rr == rule and rreason.startswith(reason)
                   for rf, rr, _, rreason in reference), (f, rule, reason)


def test_each_port_noqa_silences_a_real_hit():
    """With the noqas stripped, the port's violations are exactly the four
    sites: no noqa is stale, and nothing else hides behind one."""
    hits = []
    for f in sorted(PORT.rglob("*.py")):
        text = f.read_text()
        stripped = re.sub(r"#\s*heddle:\s*noqa.*$", "", text, flags=re.M)
        rel = f"src/repro_torch/{f.relative_to(PORT)}"
        for v in lint_source(stripped, path=rel):
            hits.append((str(f.relative_to(PORT)), v.rule,
                         text.splitlines()[v.line - 1].split("#")[0].strip()))
    assert sorted(hits) == sorted(NOQA_SITES)
