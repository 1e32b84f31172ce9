"""repro_torch.lint runner — file walking, suppressions, reporting.

Suppression syntax (trailing or own-line comment)::

    x = time.time()  # lint: disable=REP002 (measuring real compile latency)
    # lint: disable=REP001,REP003 (fixture intentionally exercises both)
    rng = np.random.default_rng()

A trailing comment suppresses its own line; an own-line comment suppresses
the next line. The parenthesized justification is mandatory — a suppression
without one is itself reported as REP000, so every silenced finding carries
a written reason reviewers can audit.
"""
from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.lint.rules import Finding, Rule, default_rules

_SUPPRESS = re.compile(
    r"#\s*lint:\s*disable=(?P<ids>REP\d{3}(?:\s*,\s*REP\d{3})*)"
    r"(?P<reason>\s*\(.*\))?")


def parse_suppressions(source: str, path: str) \
        -> Tuple[Dict[int, Set[str]], List[Finding]]:
    """Map line -> suppressed rule ids; findings for reason-less pragmas."""
    by_line: Dict[int, Set[str]] = {}
    problems: List[Finding] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(t.start[0], t.string, t.line) for t in tokens
                    if t.type == tokenize.COMMENT]
    except tokenize.TokenizeError:
        return by_line, problems
    src_lines = source.splitlines()
    for lineno, comment, line in comments:
        m = _SUPPRESS.search(comment)
        if not m:
            continue
        ids = {s.strip() for s in m.group("ids").split(",")}
        reason = (m.group("reason") or "").strip()
        if len(reason) < 3:          # "()" or absent
            problems.append(Finding(
                rule_id="REP000", path=path, line=lineno, severity="error",
                message="suppression missing justification: write "
                        "`# lint: disable=REPxxx (why this is legitimate)`"))
            continue
        # a trailing comment governs its own line; an own-line comment
        # governs the next code line (skipping blanks and further comments,
        # so a pragma can lead a multi-line explanation block)
        target = lineno
        if line.lstrip().startswith("#"):
            target = lineno + 1
            while target <= len(src_lines):
                stripped = src_lines[target - 1].strip()
                if stripped and not stripped.startswith("#"):
                    break
                target += 1
        by_line.setdefault(target, set()).update(ids)
    return by_line, problems


def lint_source(source: str, path: str,
                rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    rules = list(rules) if rules is not None else default_rules()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rule_id="REP000", path=path, line=e.lineno or 0,
                        severity="error", message=f"syntax error: {e.msg}")]
    suppressed, findings = parse_suppressions(source, path)
    for rule in rules:
        if not rule.applies_to(path):
            continue
        for f in rule.run(tree, path):
            if f.rule_id in suppressed.get(f.line, ()):
                continue
            findings.append(f)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule_id))


def lint_file(path: str,
              rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    with open(path, encoding="utf-8") as fh:
        return lint_source(fh.read(), path, rules)


def iter_py_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(p)
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
    return out


def lint_paths(paths: Iterable[str],
               rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        findings.extend(lint_file(path, rules))
    return findings


def format_text(findings: Sequence[Finding]) -> str:
    lines = [f.format() for f in findings]
    n_err = sum(1 for f in findings if f.severity == "error")
    n_warn = len(findings) - n_err
    lines.append(f"{len(findings)} finding(s): {n_err} error(s), "
                 f"{n_warn} warning(s)")
    return "\n".join(lines)


def format_json(findings: Sequence[Finding]) -> str:
    return json.dumps([vars(f) for f in findings], indent=2)
