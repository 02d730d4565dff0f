"""HDL001/HDL002 — control-plane determinism rules.

The decision-trace parity harness (tests/test_orchestrator.py) proves the
sim and engine backends make bit-identical scheduling decisions.  That proof
only holds while the control plane draws on no ambient nondeterminism: no
wall clock, no process-seeded RNG, no iteration order that CPython does not
guarantee.  These two rules mechanize that contract.

The port draws random numbers through torch as well as numpy, so HDL001 also
knows torch's global generator: a sampler called without ``generator=``
(``torch.rand``, ``randn``, ``randint``, ``randperm``, ``multinomial``,
``normal``, ``bernoulli``, the ``*_like`` forms and the in-place ``.uniform_()``
family) and any call that seeds or restores the global state
(``torch.manual_seed``, ``torch.seed``, ``torch.cuda.manual_seed*``).  An
explicit ``torch.Generator`` is legal.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.rules.base import FileContext, ImportMap, Scope, Violation

# ---------------------------------------------------------------- HDL001

# ambient wall clocks: any read makes a decision depend on the host
_WALL_CLOCK = {
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.ctime",
    "time.localtime",
    "time.gmtime",
}
# wall telemetry: legal in the engine (measured stats), banned in core/
# where every timestamp must be virtual
_WALL_TELEMETRY = {"time.perf_counter", "time.perf_counter_ns", "time.process_time"}
_DATETIME_NOW = {"now", "utcnow", "today"}
# numpy.random attrs that construct *explicitly seeded* generators (legal);
# everything else on numpy.random touches the hidden global state
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64", "Philox",
                 "MT19937", "BitGenerator", "RandomState"}
# random-module attrs that construct a seedable instance (legal)
_PY_RANDOM_OK = {"Random"}
# torch samplers that draw from the global generator unless given generator=
_TORCH_SAMPLERS = {f"torch.{name}" for name in (
    "rand", "randn", "randint", "randperm", "multinomial", "normal", "bernoulli",
    "poisson", "rand_like", "randn_like", "randint_like")}
# in-place samplers, as tensor methods or under torch.nn.init
_TORCH_INPLACE = {"uniform_", "normal_", "random_", "exponential_", "bernoulli_",
                  "cauchy_", "log_normal_", "geometric_", "trunc_normal_"}
# calls that seed or restore torch's global generators
_TORCH_SEEDING = {"torch.manual_seed", "torch.seed", "torch.set_rng_state",
                  "torch.random.manual_seed", "torch.random.seed",
                  "torch.random.set_rng_state", "torch.cuda.manual_seed",
                  "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
                  "torch.cuda.set_rng_state", "torch.cuda.set_rng_state_all"}


class RuleHDL001:
    """No wall-clock or unseeded-RNG calls in control-plane modules."""

    rule_id = "HDL001"
    scope = Scope.CONTROL

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            target = ctx.imports.resolve(node.func)
            msg = _torch_rng(node, target)
            if msg is None and target is not None:
                msg = self._classify(target, ctx.scope)
            if msg is not None:
                yield Violation(self.rule_id, ctx.path, node.lineno,
                                node.col_offset, msg)

    @staticmethod
    def _classify(target: str, scope: Scope) -> Optional[str]:
        if target in _WALL_CLOCK:
            return (f"wall-clock read `{target}()` in a control-plane module: "
                    f"decisions must depend only on virtual time")
        if target in _WALL_TELEMETRY and scope & Scope.CORE:
            return (f"`{target}()` in repro_torch/core: wall telemetry is an engine "
                    f"concern; core sees only virtual time")
        last = target.rsplit(".", 1)[-1]
        if target.startswith("datetime.") and last in _DATETIME_NOW:
            return (f"`{target}()` reads the wall clock; control-plane "
                    f"decisions must depend only on virtual time")
        if target.startswith("numpy.random.") and last not in _NP_RANDOM_OK:
            return (f"`{target}()` uses numpy's hidden global RNG; construct "
                    f"an explicit `numpy.random.default_rng(seed)` instead")
        if target.startswith("random.") and last not in _PY_RANDOM_OK:
            return (f"`{target}()` uses the process-global `random` state; "
                    f"use an explicitly seeded `random.Random(seed)` or a "
                    f"numpy Generator")
        return None


def _torch_rng(call: ast.Call, target: Optional[str]) -> Optional[str]:
    """Why ``call`` (resolved to ``target``) touches torch's global
    generator, else None."""
    if target in _TORCH_SEEDING:
        return (f"`{target}()` seeds torch's process-global generator; draw "
                f"from an explicit `torch.Generator().manual_seed(seed)` instead")
    if any(kw.arg == "generator" for kw in call.keywords):
        return None
    inplace = isinstance(call.func, ast.Attribute) and call.func.attr in _TORCH_INPLACE
    if target in _TORCH_SAMPLERS or inplace:
        spelled = target if target in _TORCH_SAMPLERS else f".{call.func.attr}"
        return (f"`{spelled}()` without `generator=` draws from torch's "
                f"process-global generator; pass an explicitly seeded "
                f"`torch.Generator`")
    return None


# ---------------------------------------------------------------- HDL002

_SET_ANNOTATIONS = {"set", "Set", "frozenset", "FrozenSet", "MutableSet",
                    "AbstractSet"}


def _annotation_is_set(node: ast.AST) -> bool:
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        base = node.value.split("[", 1)[0].strip()
        return base.rsplit(".", 1)[-1] in _SET_ANNOTATIONS
    name = None
    if isinstance(node, ast.Name):
        name = node.id
    elif isinstance(node, ast.Attribute):
        name = node.attr
    return name in _SET_ANNOTATIONS


def _value_is_set(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    return False


_SCOPE_BARRIERS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)


def _scope_nodes(body) -> Iterator[ast.AST]:
    """Yield nodes of one lexical scope without descending into nested defs."""
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _SCOPE_BARRIERS):
            stack.extend(ast.iter_child_nodes(node))


class _SetNames:
    """Inventory of set-typed names: per-scope locals + module-wide attributes.

    Locals are tracked per function scope (a name that is a set in one
    function does not taint a same-named Sequence parameter elsewhere).
    Attribute matching is by name only (any ``x.active`` matches a module
    that declares ``self.active: set[int]`` somewhere) — deliberately
    over-approximate: a decision loop over *any* unordered collection in a
    control-plane module deserves a look, and ``sorted(...)`` or a noqa with
    justification resolves the finding either way.
    """

    def __init__(self, tree: ast.Module):
        self.attrs: set[str] = set()
        self.module_names: set[str] = set()
        self._locals: set[str] = set()  # active function scope, set per check
        for node in ast.walk(tree):
            # instance/class attributes are module-wide by attr name
            if isinstance(node, ast.AnnAssign) and _annotation_is_set(node.annotation) \
                    and isinstance(node.target, ast.Attribute):
                self.attrs.add(node.target.attr)
            elif isinstance(node, ast.Assign) and _value_is_set(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Attribute):
                        self.attrs.add(t.attr)
            elif isinstance(node, ast.ClassDef):
                for sub in _scope_nodes(node.body):
                    if isinstance(sub, ast.AnnAssign) \
                            and _annotation_is_set(sub.annotation) \
                            and isinstance(sub.target, ast.Name):
                        self.attrs.add(sub.target.id)
        self.module_names = self._scope_locals(tree.body)

    @staticmethod
    def _scope_locals(body) -> set[str]:
        names: set[str] = set()
        for node in _scope_nodes(body):
            if isinstance(node, ast.AnnAssign) and _annotation_is_set(node.annotation) \
                    and isinstance(node.target, ast.Name):
                names.add(node.target.id)
            elif isinstance(node, ast.Assign) and _value_is_set(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
        return names

    def enter_scope(self, fn) -> None:
        if fn is None:
            self._locals = set()
            return
        self._locals = self._scope_locals(fn.body)
        # parameters annotated as sets are set-typed for this scope
        a = fn.args
        for arg in (*a.posonlyargs, *a.args, *a.kwonlyargs):
            if arg.annotation is not None and _annotation_is_set(arg.annotation):
                self._locals.add(arg.arg)

    def is_set_expr(self, node: ast.AST) -> bool:
        if _value_is_set(node):
            return True
        if isinstance(node, ast.Name):
            return node.id in self._locals or node.id in self.module_names
        if isinstance(node, ast.Attribute):
            return node.attr in self.attrs
        if isinstance(node, ast.Call):
            # list(s) / tuple(s) / iter(s) preserve the unordered traversal
            if isinstance(node.func, ast.Name) and node.func.id in (
                    "list", "tuple", "iter", "enumerate", "reversed") and node.args:
                return self.is_set_expr(node.args[0])
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                    "union", "intersection", "difference", "symmetric_difference",
                    "copy") and self.is_set_expr(node.func.value):
                return True
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
            return self.is_set_expr(node.left) or self.is_set_expr(node.right)
        return False


class RuleHDL002:
    """No iteration over a set (or ``dict.keys()``) in control-plane loops.

    ``for x in some_set`` traverses in hash order — stable within one process
    for int keys, but an implementation detail, and instantly divergent the
    moment ids become strings or the insert/delete history differs between
    backends.  Any such loop that feeds scheduling, placement, shedding or
    event emission silently breaks decision-trace parity.  Wrap the iterable
    in ``sorted(...)`` (canonical order) or suppress with a justification.
    ``dict.keys()`` is flagged in the same position: control-plane convention
    is explicit ``sorted(...)`` order at decision sites, and a bare
    ``.keys()`` loop is where unordered rewrites creep in.
    """

    rule_id = "HDL002"
    scope = Scope.CONTROL

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        inventory = _SetNames(ctx.tree)
        scopes: list = [None]  # module scope first, then each function
        scopes.extend(n for n in ast.walk(ctx.tree)
                      if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)))
        for fn in scopes:
            inventory.enter_scope(fn)
            body = ctx.tree.body if fn is None else fn.body
            for node in _scope_nodes(body):
                iters: list[ast.AST] = []
                if isinstance(node, (ast.For, ast.AsyncFor)):
                    iters.append(node.iter)
                elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                       ast.GeneratorExp)):
                    iters.extend(gen.iter for gen in node.generators)
                for it in iters:
                    v = self._inspect(it, inventory, ctx)
                    if v is not None:
                        yield v

    def _inspect(self, it: ast.AST, inv: _SetNames,
                 ctx: FileContext) -> Optional[Violation]:
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute) \
                and it.func.attr == "keys" and not it.args:
            return Violation(
                self.rule_id, ctx.path, it.lineno, it.col_offset,
                "iteration over `.keys()` in a control-plane loop: iterate "
                "`sorted(d)` at decision sites (or the dict itself for "
                "order-insensitive reads)")
        if inv.is_set_expr(it):
            return Violation(
                self.rule_id, ctx.path, it.lineno, it.col_offset,
                "iteration over a set in a control-plane loop traverses in "
                "hash order; wrap in `sorted(...)` so the decision sequence "
                "is canonical")
        return None


__all__ = ["RuleHDL001", "RuleHDL002", "ImportMap"]
