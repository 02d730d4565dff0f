"""Static analysis, runtime sanitization and backend conformance for the
port's control plane.

* :mod:`repro_torch.analysis.lint` — an AST linter (``python -m
  repro_torch.analysis.lint src/repro_torch``) with rules HDL001–HDL005 in
  the port's spelling (wall-clock and unseeded numpy / torch RNG,
  unordered-set iteration in decision paths, host syncs in decode loops,
  event-heap discipline, host-gathers of KV on migration paths).  The
  README's port section has the catalog and the ``# heddle: noqa HDLxxx``
  suppression syntax.
* :mod:`repro_torch.analysis.protocol` — an ``ExecutionBackend`` conformance
  checker that statically diffs SimBackend/EngineBackend against the protocol
  so the implementations cannot silently drift.
* :mod:`repro_torch.analysis.sanitize` — ``TraceSanitizer``, a runtime
  validator the orchestrator drives over every emitted decision event
  (monotone virtual time, liveness, slot conservation, migration balance,
  tenancy legality).
"""

# lazy attribute access: `python -m repro_torch.analysis.lint` must not
# pre-import the submodule through the package (runpy double-import), and the
# orchestrator's sanitize hook must not pay for the linter's ast machinery
_EXPORTS = {
    "Violation": "repro_torch.analysis.lint",
    "lint_paths": "repro_torch.analysis.lint",
    "lint_source": "repro_torch.analysis.lint",
    "check_backend": "repro_torch.analysis.protocol",
    "TraceSanitizer": "repro_torch.analysis.sanitize",
    "TraceViolationError": "repro_torch.analysis.sanitize",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'repro_torch.analysis' has no attribute {name!r}")


__all__ = ["Violation", "lint_paths", "lint_source", "check_backend", "TraceSanitizer",
           "TraceViolationError"]
