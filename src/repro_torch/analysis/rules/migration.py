"""HDL005 — no host-gather of KV buffers on migration/checkpoint paths.

The paged data plane moves KV between workers as device-to-device block
copies of *resident* pages (``worker._ingest_pages`` / ``model
.paged_gather_pages``).  A ``.cpu()`` / ``.numpy()`` / ``.to("cpu")`` /
``np.asarray`` of cache pages inside a ``migrate*`` / ``checkpoint*`` /
``restore*`` function round-trips the whole payload through host memory —
the exact bounce the paged pool exists to eliminate, and it serializes the
device against the host for the full transfer.

The mapped forms are caught too: ``tree_map(lambda t: t.cpu(), tree)`` (any
``tree_map``, the port's ``models.model.tree_map`` among them, whose mapped
function host-gathers its argument, or maps ``np.asarray``) and the port's
``tree_to(tree, "cpu")``.

Legitimate host bounces carry a noqa with the reason: a tool-boundary
checkpoint must outlive its source device; the legacy lane engine has no
page tables to D2D-copy.

The rule only fires when the gathered expression references a KV-ish name
(``cache`` / ``page`` / ``kv`` / ``lane`` / ``pool`` / ``block``), or a loop
variable that runs over such names (``for name in ("cache", "pages")``) —
small metadata like RNG keys or slot indices host-gather freely.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from repro_torch.analysis.rules.base import FileContext, Scope, Violation, dotted_name
from repro_torch.analysis.rules.jit_hygiene import is_cpu, to_cpu

#: functions that form the KV transfer family
_MIG_FN = re.compile(r"(^|_)(migrate|checkpoint|restore)", re.I)

#: host-gathering callables (resolved dotted paths)
_SYNC_PATHS = {"numpy.asarray", "numpy.array"}

#: tensor methods that copy their receiver to the host (no arguments)
_HOST_ATTRS = {"cpu", "numpy"}

#: identifier fragments that mark an expression as KV-cache data
_KV_HINTS = ("cache", "page", "kv", "lane", "pool", "block")


def _kv_text(text: str) -> bool:
    low = text.lower()
    return any(h in low for h in _KV_HINTS)


def _mentions_kv(node: ast.AST, kv_names: set[str]) -> bool:
    """True if any identifier / attribute / string key in ``node`` looks
    KV-ish, or names a loop variable in ``kv_names``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            if sub.id in kv_names or _kv_text(sub.id):
                return True
        elif isinstance(sub, ast.Attribute):
            if _kv_text(sub.attr):
                return True
        elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            if _kv_text(sub.value):
                return True
    return False


def _kv_loop_names(fn: ast.AST) -> set[str]:
    """Names bound by a ``for`` (or comprehension) of ``fn`` whose iterable
    mentions KV: ``for name in ("cache", "pages", "state")``."""
    names: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)) \
                and isinstance(node.target, ast.Name) and _mentions_kv(node.iter, set()):
            names.add(node.target.id)
    return names


def _host_gather_fn(fn: ast.AST, ctx: FileContext) -> bool:
    """A mapped function that host-gathers its argument: ``np.asarray``, or
    ``lambda t: t.cpu()`` / ``t.numpy()`` / ``t.to("cpu")`` /
    ``np.asarray(t)``."""
    if ctx.imports.resolve(fn) in _SYNC_PATHS:
        return True
    if not (isinstance(fn, ast.Lambda) and isinstance(fn.body, ast.Call)):
        return False
    body = fn.body
    if ctx.imports.resolve(body.func) in _SYNC_PATHS:
        return True
    return to_cpu(body) or (isinstance(body.func, ast.Attribute)
                            and body.func.attr in _HOST_ATTRS and not body.args)


class RuleHDL005:
    """Migration/checkpoint paths must move KV device-to-device, not via host."""

    rule_id = "HDL005"
    scope = Scope.NONE  # anywhere a worker moves KV

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _MIG_FN.search(node.name):
                continue
            kv_names = _kv_loop_names(node)
            for call in ast.walk(node):
                if not isinstance(call, ast.Call):
                    continue
                hit = self._host_gather(call, ctx)
                if hit is None:
                    continue
                spelled, payload = hit
                if not _mentions_kv(payload, kv_names):
                    continue  # keys / slot indices / metadata: fine to gather
                yield Violation(
                    self.rule_id, ctx.path, call.lineno, call.col_offset,
                    f"`{spelled}` host-gathers a KV buffer inside "
                    f"`{node.name}`: same-process moves must D2D-copy "
                    f"resident pages (paged_gather_pages/_ingest_pages); "
                    f"justify a durability or legacy-engine bounce with "
                    f"a noqa")

    @staticmethod
    def _host_gather(call: ast.Call,
                     ctx: FileContext) -> Optional[tuple[str, ast.AST]]:
        """(spelling, gathered expression) when ``call`` host-gathers."""
        fn = call.func
        target = ctx.imports.resolve(fn)
        if target in _SYNC_PATHS and call.args:
            return f"{dotted_name(fn)}(...)", call.args[0]
        if isinstance(fn, ast.Attribute) and fn.attr in _HOST_ATTRS \
                and not call.args and not call.keywords:
            return f".{fn.attr}()", fn.value
        if to_cpu(call):
            return '.to("cpu")', fn.value
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
        # tree_map(lambda t: t.cpu(), tree): the gather hides in the mapped fn
        if name.endswith("tree_map") and len(call.args) >= 2 \
                and _host_gather_fn(call.args[0], ctx):
            return f"{dotted_name(fn)}(<host gather>, ...)", call.args[1]
        # the port's tree_to(tree, "cpu")
        if name.endswith("tree_to") and call.args and (
                (len(call.args) > 1 and is_cpu(call.args[1]))
                or any(kw.arg == "device" and is_cpu(kw.value) for kw in call.keywords)):
            return f'{dotted_name(fn)}(..., "cpu")', call.args[0]
        return None


__all__ = ["RuleHDL005"]
