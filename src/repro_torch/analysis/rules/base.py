"""Shared infrastructure for the port's heddle lint rules: violations, file
context, import-alias resolution.

Rules operate on a :class:`FileContext` — one parsed module plus the scope
tags the lint driver derived from its path (see :data:`Scope`).  The
:class:`ImportMap` resolves attribute chains like ``np.random.default_rng``
back to canonical dotted module paths (``numpy.random.default_rng``,
``F.softmax`` to ``torch.nn.functional.softmax``) so rules match semantics,
not surface spelling.
"""

from __future__ import annotations

import ast
import enum
from dataclasses import dataclass, field
from typing import Iterator, Optional, Protocol


class Scope(enum.Flag):
    """Where a file sits in the codebase; rules opt into scopes.

    CONTROL covers the port's decision-making planes (``repro_torch/core/``,
    ``engine/``, ``rl/``) where determinism rules apply.  CORE narrows to
    ``repro_torch/core/`` alone — the virtual-time
    control plane where even ``time.perf_counter`` wall telemetry is banned
    (the engine legitimately measures wall time; core must never see it).
    """

    NONE = 0
    CONTROL = enum.auto()
    CORE = enum.auto()


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: {self.rule} {self.message}"


@dataclass
class FileContext:
    """One module as the rules see it."""

    path: str  # display path (repo-relative when possible)
    source: str
    tree: ast.Module
    scope: Scope
    lines: list[str] = field(default_factory=list)
    imports: "ImportMap" = None  # type: ignore[assignment]

    def __post_init__(self):
        if not self.lines:
            self.lines = self.source.splitlines()
        if self.imports is None:
            self.imports = ImportMap.from_tree(self.tree)


class Rule(Protocol):
    rule_id: str
    scope: Scope  # Scope.NONE means "applies everywhere"

    def check(self, ctx: FileContext) -> Iterator[Violation]: ...


class ImportMap:
    """Alias table mapping local names to canonical dotted import paths."""

    def __init__(self, aliases: dict[str, str]):
        self.aliases = aliases

    @classmethod
    def from_tree(cls, tree: ast.Module) -> "ImportMap":
        aliases: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for a in node.names:
                    if a.name != "*":
                        aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        # the port's conventions even when the import is elided/lazy
        aliases.setdefault("np", "numpy")
        aliases.setdefault("F", "torch.nn.functional")
        return cls(aliases)

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted path for a Name/Attribute chain, else None."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        head = self.aliases.get(parts[0], parts[0])
        return ".".join([head] + parts[1:])


def dotted_name(node: ast.AST) -> Optional[str]:
    """Surface spelling of a Name/Attribute chain (no alias resolution)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))
