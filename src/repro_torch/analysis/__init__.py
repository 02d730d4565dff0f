"""Runtime sanitization and backend conformance for the port's control plane.

* :mod:`repro_torch.analysis.protocol` — an ``ExecutionBackend`` conformance
  checker that statically diffs SimBackend/EngineBackend against the protocol
  so the implementations cannot silently drift.
* :mod:`repro_torch.analysis.sanitize` — ``TraceSanitizer``, a runtime
  validator the orchestrator drives over every emitted decision event
  (monotone virtual time, liveness, slot conservation, migration balance,
  tenancy legality).

The JAX package's AST linter (``repro.analysis.lint``) is not ported yet.
"""

# lazy attribute access: the orchestrator's sanitize hook imports only the
# submodule it needs
_EXPORTS = {
    "check_backend": "repro_torch.analysis.protocol",
    "TraceSanitizer": "repro_torch.analysis.sanitize",
    "TraceViolationError": "repro_torch.analysis.sanitize",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'repro_torch.analysis' has no attribute {name!r}")


__all__ = ["check_backend", "TraceSanitizer", "TraceViolationError"]
