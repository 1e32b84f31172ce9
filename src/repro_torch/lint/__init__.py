"""repro_torch.lint — determinism & feasibility checks for the simulator.

A copy of ``repro.lint`` with the imports renamed. Three layers, one goal
(a virtual-clock run is a pure function of (spec, seed) and its accounting
balances):

- static rules over the source (``repro_torch.lint.rules`` / ``runner``,
  ``python -m repro_torch.lint src/repro_torch``),
- static feasibility over a spec (``Scenario.check()``),
- dynamic invariants over a running sim (``repro_torch.lint.sanitizer``,
  enabled with ``sanitize=True`` on the engine/cluster).
"""
from repro_torch.lint.rules import ALL_RULES, Finding, Rule, default_rules
from repro_torch.lint.runner import (format_json, format_text, iter_py_files,
                                     lint_file, lint_paths, lint_source,
                                     parse_suppressions)
from repro_torch.lint.sanitizer import (ClusterSanitizer, EngineSanitizer,
                                        SanitizerError)

__all__ = [
    "ALL_RULES", "Finding", "Rule", "default_rules",
    "lint_source", "lint_file", "lint_paths", "iter_py_files",
    "parse_suppressions", "format_text", "format_json",
    "SanitizerError", "EngineSanitizer", "ClusterSanitizer",
]
