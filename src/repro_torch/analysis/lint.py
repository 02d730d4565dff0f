"""heddle-lint for the port: AST linter for Heddle's control-plane invariants
in the port's own spelling.

Usage::

    python -m repro_torch.analysis.lint src/repro_torch            # lint a tree
    python -m repro_torch.analysis.lint path/to/file.py            # lint one file
    python -m repro_torch.analysis.lint --select HDL002 src        # one rule only

Rules (catalog in README.md, the port's section):

* **HDL001** — no wall-clock / unseeded-RNG calls in control-plane modules
  (``repro_torch/core/``, ``engine/``, ``rl/``): numpy's and ``random``'s
  global state, and torch's global generator (a sampler without
  ``generator=``, ``torch.manual_seed`` and the like); ``time.perf_counter``
  additionally banned in ``repro_torch/core/`` (virtual time only).
* **HDL002** — no iteration over a set or ``dict.keys()`` in control-plane
  loops (hash-order traversal breaks decision-trace parity).
* **HDL003** — no host-sync calls (``.item()``, ``.cpu()``, ``.numpy()``,
  ``.to("cpu")``, ``torch.cuda.synchronize()``, ``np.asarray``, ``int()`` of
  a reduction) inside decode/prefill/extend loops.
* **HDL004** — every event kind pushed onto an orchestrator heap has a
  handler branch, and tuple payloads carry a version/token stamp.
* **HDL005** — no host-gather (``.cpu()`` / ``np.asarray`` / ``tree_to(...,
  "cpu")``) of KV buffers inside migration/checkpoint/restore paths;
  same-process moves D2D-copy resident pages (durability bounces carry a
  justified noqa).

Suppression: append ``# heddle: noqa HDL002`` (comma-separate multiple ids,
bare ``# heddle: noqa`` silences all rules) to the flagged line, with a
justification after ``--``::

    for tid in live_set:  # heddle: noqa HDL002 -- feeds an order-insensitive sum

Exit status is the number of unsuppressed violations (0 = clean), capped at
the shell's 8-bit range by the CLI.
"""

from __future__ import annotations

import argparse
import ast
import re
import sys
from pathlib import Path
from typing import Iterable, Optional, Sequence

from repro_torch.analysis.rules import ALL_RULES
from repro_torch.analysis.rules.base import FileContext, Scope, Violation

_NOQA = re.compile(r"#\s*heddle:\s*noqa(?:\s+(?P<ids>HDL\d{3}(?:\s*,\s*HDL\d{3})*))?",
                   re.I)

#: path fragments that place a file in the port's decision-making planes
_CONTROL_FRAGMENTS = ("repro_torch/core/", "repro_torch/engine/", "repro_torch/rl/")
_CORE_FRAGMENT = "repro_torch/core/"


def scope_for_path(path: str) -> Scope:
    p = path.replace("\\", "/")
    scope = Scope.NONE
    if any(f in p for f in _CONTROL_FRAGMENTS):
        scope |= Scope.CONTROL
    if _CORE_FRAGMENT in p:
        scope |= Scope.CORE
    return scope


def _noqa_ids(line: str) -> Optional[set[str]]:
    """Rule ids suppressed on this line; empty set = all rules; None = none."""
    m = _NOQA.search(line)
    if m is None:
        return None
    ids = m.group("ids")
    if not ids:
        return set()
    return {i.strip().upper() for i in ids.split(",")}


def _suppressed(v: Violation, lines: list[str]) -> bool:
    if not 1 <= v.line <= len(lines):
        return False
    ids = _noqa_ids(lines[v.line - 1])
    if ids is None and v.line >= 2:
        # multi-line statements report the first line; accept a noqa on the
        # physical line above (decorators, wrapped calls)
        ids = _noqa_ids(lines[v.line - 2])
    if ids is None:
        return False
    return not ids or v.rule in ids


def lint_source(source: str, path: str = "<memory>",
                scope: Optional[Scope] = None,
                select: Optional[Iterable[str]] = None) -> list[Violation]:
    """Lint one module's source; returns unsuppressed violations sorted by
    position.  ``scope`` overrides path-derived scoping (tests force
    CONTROL|CORE on fixtures that live outside src/repro_torch)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Violation("HDL000", path, exc.lineno or 1, 0,
                          f"syntax error: {exc.msg}")]
    ctx = FileContext(path=path, source=source, tree=tree,
                      scope=scope_for_path(path) if scope is None else scope)
    wanted = set(select) if select else set(ALL_RULES)
    out: list[Violation] = []
    for rule_id, rule in ALL_RULES.items():
        if rule_id not in wanted:
            continue
        if rule.scope is not Scope.NONE and not ctx.scope & rule.scope:
            continue
        out.extend(rule.check(ctx))
    out = [v for v in out if not _suppressed(v, ctx.lines)]
    return sorted(out, key=lambda v: (v.line, v.col, v.rule))


def _iter_py_files(paths: Sequence[str]) -> Iterable[Path]:
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            yield from sorted(q for q in p.rglob("*.py")
                              if "__pycache__" not in q.parts)
        elif p.suffix == ".py":
            yield p


def lint_paths(paths: Sequence[str],
               select: Optional[Iterable[str]] = None) -> list[Violation]:
    """Lint every ``.py`` under ``paths`` (files or trees)."""
    out: list[Violation] = []
    for f in _iter_py_files(paths):
        try:
            rel = f.resolve().relative_to(Path.cwd())
        except ValueError:
            rel = f
        out.extend(lint_source(f.read_text(), path=str(rel), select=select))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="heddle-lint: control-plane determinism linter")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--select", action="append", metavar="HDLxxx",
                    help="restrict to these rule ids (repeatable)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-violation lines; print only the summary")
    args = ap.parse_args(argv)
    violations = lint_paths(args.paths, select=args.select)
    if not args.quiet:
        for v in violations:
            print(v.render())
    n = len(violations)
    print(f"heddle-lint: {n} violation{'s' if n != 1 else ''}"
          f" ({', '.join(sorted(args.select)) if args.select else 'HDL001-HDL005'})",
          file=sys.stderr)
    return min(n, 125)


if __name__ == "__main__":
    sys.exit(main())
