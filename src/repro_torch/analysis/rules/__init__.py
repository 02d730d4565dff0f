"""Rule registry for the port's heddle linter.

Each rule is a callable ``check(ctx) -> Iterator[Violation]`` over a parsed
module (:class:`repro_torch.analysis.rules.base.FileContext`).  Rules are
registered by id in :data:`ALL_RULES`; :mod:`repro_torch.analysis.lint`
applies every rule whose scope matches the file being linted and filters
``# heddle: noqa`` lines.

To add a rule: implement it in a module here, give it a unique ``HDLxxx`` id,
add it to :data:`ALL_RULES`, list it in the README's catalog, and add
positive/negative cases to tests/test_torch_lint.py.
"""

from __future__ import annotations

from repro_torch.analysis.rules.determinism import RuleHDL001, RuleHDL002
from repro_torch.analysis.rules.events import RuleHDL004
from repro_torch.analysis.rules.jit_hygiene import RuleHDL003
from repro_torch.analysis.rules.migration import RuleHDL005

#: all registered rules, keyed by id, in catalog order
ALL_RULES = {
    "HDL001": RuleHDL001(),
    "HDL002": RuleHDL002(),
    "HDL003": RuleHDL003(),
    "HDL004": RuleHDL004(),
    "HDL005": RuleHDL005(),
}

__all__ = ["ALL_RULES", "RuleHDL001", "RuleHDL002", "RuleHDL003", "RuleHDL004",
           "RuleHDL005"]
