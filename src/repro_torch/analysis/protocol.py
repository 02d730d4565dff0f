"""ExecutionBackend conformance checker.

``repro_torch.core.orchestrator.ExecutionBackend`` is a ``typing.Protocol``: it is
never instantiated, so nothing at runtime forces SimBackend and EngineBackend
to keep matching it — a renamed parameter or a dropped method surfaces only
as a confusing orchestrator crash (or worse, a silent behavioural fork
between the backends the parity harness then chases for hours).  This module
diffs a backend class against the protocol **statically**:

* **method set** — every protocol method exists and is callable; the
  ``interruptible`` attribute and ``n_workers`` property are present (class
  attribute, property, or an ``__init__`` assignment found by AST);
* **signatures** — positional parameter names *and order* match the protocol
  exactly (the orchestrator calls positionally); extra backend-specific
  parameters are allowed only when they carry defaults; a default the
  protocol declares (e.g. ``admit(..., now=0.0)``) may not be dropped;
* **return contract** — when the backend annotates a return type it must
  match the protocol's (modulo the compatibility table below, e.g. ``list``
  satisfies ``Iterable``); an unannotated override must at least carry a
  docstring so the return shape is documented somewhere.

Run ``python -m repro_torch.analysis.protocol`` to check the two shipped backends;
``check_backend(cls)`` returns a list of human-readable drift findings
(empty = conformant) for use from tests and CI.
"""

from __future__ import annotations

import ast
import inspect
import sys
import textwrap
from typing import Optional, Sequence, get_type_hints

#: return-annotation compatibility: protocol annotation -> accepted backend
#: annotations (string-normalized).  Anything not listed must match exactly.
_RETURN_COMPAT = {
    "Iterable[int]": {"Iterable[int]", "list[int]", "tuple[int, ...]",
                      "Sequence[int]"},
    "Optional[float]": {"Optional[float]", "float | None", "None | float"},
}


def _norm_annotation(ann) -> Optional[str]:
    if ann is inspect.Signature.empty:
        return None
    if isinstance(ann, str):
        s = ann
    else:
        s = getattr(ann, "__name__", None) or str(ann)
    for junk in ("typing.", "builtins."):
        s = s.replace(junk, "")
    return s.replace(" ", "").replace("'", "")


def _compatible_return(proto: Optional[str], impl: Optional[str]) -> bool:
    if proto is None or impl is None:
        return True  # nothing to diff
    if proto == impl:
        return True
    accepted = _RETURN_COMPAT.get(proto.replace(",...]", ", ...]"), set())
    return impl in {_norm_annotation(a) for a in accepted} | accepted


def _init_assigns_attr(cls: type, attr: str) -> bool:
    """AST check: does any method in ``cls`` (or a base) assign ``self.attr``?

    Backends set ``interruptible`` in ``__init__`` rather than as a class
    attribute (it can depend on construction arguments), so a pure
    ``hasattr`` on the class misses it.
    """
    for klass in cls.__mro__:
        if klass is object:
            continue
        try:
            src = textwrap.dedent(inspect.getsource(klass))
        except (OSError, TypeError):
            continue
        for node in ast.walk(ast.parse(src)):
            targets: list[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            for t in targets:
                if (isinstance(t, ast.Attribute) and t.attr == attr
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    return True
    return False


def _protocol_methods(protocol: type) -> dict[str, inspect.Signature]:
    out: dict[str, inspect.Signature] = {}
    for name, member in vars(protocol).items():
        if name.startswith("_"):
            continue
        if isinstance(member, property):
            continue  # properties checked separately
        if callable(member):
            out[name] = inspect.signature(member)
    return out


def _protocol_properties(protocol: type) -> list[str]:
    return [n for n, m in vars(protocol).items()
            if isinstance(m, property) and not n.startswith("_")]


def _protocol_attrs(protocol: type) -> list[str]:
    return [n for n in getattr(protocol, "__annotations__", {})
            if not n.startswith("_")]


def check_backend(cls: type, protocol: Optional[type] = None) -> list[str]:
    """Diff ``cls`` against the ExecutionBackend protocol; [] = conformant."""
    if protocol is None:
        from repro_torch.core.orchestrator import ExecutionBackend as protocol  # noqa: N813
    findings: list[str] = []
    who = cls.__name__

    for attr in _protocol_attrs(protocol):
        if not (hasattr(cls, attr) or _init_assigns_attr(cls, attr)):
            findings.append(f"{who}: missing attribute `{attr}` (declared on "
                            f"the protocol; set it in __init__ or on the class)")

    for prop in _protocol_properties(protocol):
        member = inspect.getattr_static(cls, prop, None)
        if member is None:
            findings.append(f"{who}: missing property `{prop}`")
        elif not isinstance(member, property) and not callable(member):
            findings.append(f"{who}: `{prop}` must be a property or method, "
                            f"found {type(member).__name__}")

    try:
        proto_hints = get_type_hints(protocol)  # noqa: F841  (resolves lazily)
    except Exception:
        pass

    for name, proto_sig in _protocol_methods(protocol).items():
        impl = inspect.getattr_static(cls, name, None)
        if impl is None:
            findings.append(f"{who}: missing method `{name}`")
            continue
        impl_fn = impl.__func__ if isinstance(impl, (staticmethod, classmethod)) \
            else impl
        if not callable(impl_fn):
            findings.append(f"{who}: `{name}` is not callable")
            continue
        try:
            impl_sig = inspect.signature(impl_fn)
        except (TypeError, ValueError):
            continue
        findings.extend(_diff_signature(who, name, proto_sig, impl_sig))
        proto_ret = _norm_annotation(proto_sig.return_annotation)
        impl_ret = _norm_annotation(impl_sig.return_annotation)
        if not _compatible_return(proto_ret, impl_ret):
            findings.append(
                f"{who}.{name}: return annotation `{impl_ret}` does not "
                f"satisfy the protocol's `{proto_ret}`")
        if impl_ret is None and not inspect.getdoc(impl_fn) \
                and proto_sig.return_annotation is not inspect.Signature.empty:
            findings.append(
                f"{who}.{name}: no return annotation and no docstring — the "
                f"return contract (protocol: `{proto_ret}`) must be stated "
                f"on the override")
    return findings


def _diff_signature(who: str, name: str, proto: inspect.Signature,
                    impl: inspect.Signature) -> list[str]:
    findings: list[str] = []
    pp = [p for p in proto.parameters.values() if p.name != "self"]
    ip = [p for p in impl.parameters.values() if p.name != "self"]
    for idx, p in enumerate(pp):
        if idx >= len(ip):
            findings.append(f"{who}.{name}: missing parameter `{p.name}` "
                            f"(protocol position {idx + 1})")
            continue
        q = ip[idx]
        if q.kind in (inspect.Parameter.VAR_POSITIONAL,
                      inspect.Parameter.VAR_KEYWORD):
            break  # *args/**kwargs absorbs the rest
        if q.name != p.name:
            findings.append(
                f"{who}.{name}: parameter {idx + 1} is `{q.name}`, protocol "
                f"says `{p.name}` — the orchestrator calls positionally and "
                f"keyword callers would break")
        if p.default is not inspect.Parameter.empty \
                and q.default is inspect.Parameter.empty:
            findings.append(
                f"{who}.{name}: parameter `{p.name}` drops the protocol's "
                f"default ({p.default!r})")
    for q in ip[len(pp):]:
        if q.kind in (inspect.Parameter.VAR_POSITIONAL,
                      inspect.Parameter.VAR_KEYWORD):
            continue
        if q.default is inspect.Parameter.empty \
                and q.kind is not inspect.Parameter.KEYWORD_ONLY:
            findings.append(
                f"{who}.{name}: extra required parameter `{q.name}` — the "
                f"orchestrator will never pass it; give it a default")
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    from repro_torch.core.orchestrator import ExecutionBackend
    from repro_torch.engine.backends import EngineBackend, SimBackend

    failed = 0
    for cls in (SimBackend, EngineBackend):
        findings = check_backend(cls, ExecutionBackend)
        status = "ok" if not findings else f"{len(findings)} finding(s)"
        print(f"{cls.__name__}: {status}")
        for f in findings:
            print(f"  - {f}")
        failed += len(findings)
    return min(failed, 125)


if __name__ == "__main__":
    sys.exit(main())
