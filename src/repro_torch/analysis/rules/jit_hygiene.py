"""HDL003 — host-sync discipline in the decode and prefill loops.

A ``.item()`` / ``.cpu()`` / ``np.asarray`` inside the per-token or per-chunk
loop of a decode or prefill path serializes the host against the card once
per iteration: the launch queue drains, and the device idles while the host
waits for the copy and then enqueues the next step.  Device values must stay
on the device until the loop exits (or the sync must be justified with a
noqa, e.g. a deliberate early-exit check).  In the port the same guard keeps
the decode step capturable as a CUDA graph, which breaks on any host sync.

Flagged inside a loop of a function whose name says decode, prefill or
extend:

* ``.item()``, ``.tolist()``, ``.cpu()`` and ``.numpy()`` with no arguments;
* ``.to("cpu")`` and ``.to(device="cpu")``;
* ``torch.cuda.synchronize()``;
* ``np.asarray(...)`` / ``np.array(...)``;
* ``int(...)``, ``float(...)`` or ``bool(...)`` applied directly to a
  reduction method call (``.sum()``, ``.any()``, ``.all()``, ``.max()``,
  ``.min()``), which reads one device value back.

The reference's other half of HDL003, retrace leaks at ``jax.jit`` sites
whose mesh or config is traced, has no counterpart: no path of the port
compiles anything (eager PyTorch, and hand-written kernels built once per
source), so there is no jit cache to key.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from repro_torch.analysis.rules.base import FileContext, Scope, Violation, dotted_name

#: function names whose loop bodies are token/chunk hot paths
_HOT_FN = re.compile(r"(^|_)(decode|prefill|extend)", re.I)

#: host-synchronizing callables (by resolved dotted path)
_SYNC_PATHS = {"numpy.asarray", "numpy.array", "torch.cuda.synchronize"}
#: tensor methods that copy to the host when called with no arguments
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
#: Python scalar casts that read a device value back
_SCALAR_CASTS = {"int", "float", "bool"}
#: reductions whose result such a cast reads
_REDUCTIONS = {"sum", "any", "all", "max", "min"}


def is_cpu(node: ast.AST) -> bool:
    """The constant ``"cpu"``."""
    return isinstance(node, ast.Constant) and node.value == "cpu"


def to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` or ``x.to(device="cpu")``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    return (bool(call.args) and is_cpu(call.args[0])) or any(
        kw.arg == "device" and is_cpu(kw.value) for kw in call.keywords)


class RuleHDL003:
    """Decode and prefill loops must not host-sync."""

    rule_id = "HDL003"
    scope = Scope.NONE  # anywhere a decode loop lives

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        seen: set[tuple[int, int]] = set()  # nested loops and hot functions: once
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _HOT_FN.search(node.name):
                continue
            for loop in ast.walk(node):
                if not isinstance(loop, (ast.For, ast.While)):
                    continue
                for call in ast.walk(loop):
                    if not isinstance(call, ast.Call):
                        continue
                    msg = self._sync_call(call, ctx)
                    if msg is None or (call.lineno, call.col_offset) in seen:
                        continue
                    seen.add((call.lineno, call.col_offset))
                    yield Violation(self.rule_id, ctx.path, call.lineno,
                                    call.col_offset,
                                    f"{msg} inside the `{node.name}` "
                                    f"loop forces a device→host sync per "
                                    f"iteration; hoist it out of the "
                                    f"loop or justify with a noqa")

    @staticmethod
    def _sync_call(call: ast.Call, ctx: FileContext) -> Optional[str]:
        target = ctx.imports.resolve(call.func)
        if target in _SYNC_PATHS:
            return f"`{dotted_name(call.func)}(...)`"
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr in _SYNC_ATTRS and not call.args and not call.keywords:
            return f"`.{call.func.attr}()`"
        if to_cpu(call):
            return "`.to(\"cpu\")`"
        if isinstance(call.func, ast.Name) and call.func.id in _SCALAR_CASTS \
                and len(call.args) == 1 and isinstance(call.args[0], ast.Call):
            inner = call.args[0].func
            if isinstance(inner, ast.Attribute) and inner.attr in _REDUCTIONS and not \
                    (ctx.imports.resolve(inner) or "").startswith("numpy."):
                return f"`{call.func.id}(x.{inner.attr}())`"
        return None


__all__ = ["RuleHDL003"]
