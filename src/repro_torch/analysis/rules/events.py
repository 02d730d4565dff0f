"""HDL004 — event-heap discipline.

The orchestrator's versioned heap is the only channel control-plane causality
flows through; PRs 5–7 each added event kinds (worker, tool_done,
migration_done, restore_done, arrival, worker_death, worker_up) and each new
kind needed both a handler branch *and* a staleness guard.  This rule keeps
the three legs aligned inside any module that pushes events:

* every kind pushed via ``self._push(t, "kind", payload)`` has a matching
  ``kind == "kind"`` handler comparison (no silently dropped events);
* every handled kind is actually pushed somewhere (no dead branches masking
  a renamed event);
* every *tuple* payload carries a version/token stamp — a field whose name
  contains ``version``/``token``/``ver``/``seq`` — so the handler can reject
  stale deliveries.  Scalar payloads (a bare traj/worker id) are exempt:
  they identify an entity whose handler re-validates against live state.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.rules.base import FileContext, Scope, Violation

_STAMP_MARKERS = ("version", "token", "ver", "seq")


def _push_kind(call: ast.Call) -> Optional[tuple[str, Optional[ast.AST]]]:
    """Match ``self._push(t, "kind", payload)``; return (kind, payload)."""
    fn = call.func
    if not (isinstance(fn, ast.Attribute) and fn.attr == "_push"):
        return None
    if len(call.args) < 2:
        return None
    kind = call.args[1]
    if not (isinstance(kind, ast.Constant) and isinstance(kind.value, str)):
        return None
    payload = call.args[2] if len(call.args) > 2 else None
    return kind.value, payload


def _handled_kinds(tree: ast.Module) -> dict[str, int]:
    """kind -> first line of a ``kind == "..."`` / ``kind in (...)`` test."""
    handled: dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1:
            continue
        if not (isinstance(node.left, ast.Name) and node.left.id == "kind"):
            continue
        cmp = node.comparators[0]
        if isinstance(node.ops[0], ast.Eq) and isinstance(cmp, ast.Constant) \
                and isinstance(cmp.value, str):
            handled.setdefault(cmp.value, node.lineno)
        elif isinstance(node.ops[0], ast.In):
            for el in ast.walk(cmp):
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    handled.setdefault(el.value, node.lineno)
    return handled


def _tuple_has_stamp(payload: ast.Tuple) -> bool:
    for el in payload.elts:
        for sub in ast.walk(el):
            name = None
            if isinstance(sub, ast.Name):
                name = sub.id
            elif isinstance(sub, ast.Attribute):
                name = sub.attr
            elif isinstance(sub, ast.Call):
                # next(self._xfer_seq)-style freshly minted tokens
                continue
            if name and any(m in name.lower() for m in _STAMP_MARKERS):
                return True
    return False


class RuleHDL004:
    """Pushed event kinds ↔ handler branches ↔ version-stamped payloads."""

    rule_id = "HDL004"
    scope = Scope.NONE  # applies to any module that pushes heap events

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        pushes: list[tuple[str, Optional[ast.AST], int, int]] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                m = _push_kind(node)
                if m is not None:
                    pushes.append((m[0], m[1], node.lineno, node.col_offset))
        if not pushes:
            return
        handled = _handled_kinds(ctx.tree)
        if not handled:
            # pushes but no dispatcher in this module: cross-module event flow
            # is out of scope for a per-file rule
            return
        pushed_kinds = {k for k, _, _, _ in pushes}
        for kind, payload, line, col in pushes:
            if kind not in handled:
                yield Violation(
                    self.rule_id, ctx.path, line, col,
                    f"event kind '{kind}' is pushed onto the heap but has no "
                    f"`kind == \"{kind}\"` handler branch: the event would be "
                    f"popped and dropped silently")
            if isinstance(payload, ast.Tuple) and not _tuple_has_stamp(payload):
                yield Violation(
                    self.rule_id, ctx.path, line, col,
                    f"event kind '{kind}' carries a multi-field payload with "
                    f"no version/token stamp: the handler cannot reject a "
                    f"stale delivery (add a lane.version / transfer token "
                    f"field)")
        for kind, line in sorted(handled.items()):
            if kind not in pushed_kinds:
                yield Violation(
                    self.rule_id, ctx.path, line, 0,
                    f"handler branch for event kind '{kind}' but nothing in "
                    f"this module pushes it: dead branch, or the emission was "
                    f"renamed without its handler")


__all__ = ["RuleHDL004"]
