"""The port's static lint (``repro_torch.lint``: rules, runner and ``python -m
repro_torch.lint``) against ``repro.lint``. The modules are framework-free
copies whose path scopes name ``repro_torch/`` where the reference's name
``repro/``, so every fire/clean fixture of ``tests/test_lint.py``, linted at
its path with ``repro/`` mapped to ``repro_torch/``, must give the
reference's findings (rule, line, severity, message; the package's name in a
message masked). Also here: suppression parsing and REP000, both CLIs'
text, JSON and exit codes, each package's scopes flagging only its own
package, and the repository's own trees lint-clean under both rule sets
(``python -m repro.lint src/`` is the CI gate).
"""
import json
import os
import subprocess
import sys

import pytest

from repro import lint as jlint
from repro.lint.__main__ import main as jlint_main
from repro_torch import lint
from repro_torch.lint.__main__ import main as lint_main

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")

SIM = "repro/core/fixture.py"
LAUNCH = "repro/launch/fixture.py"
OBS = "repro/obs/fixture.py"
OTHER = "repro/analysis/fixture.py"

ROUTING_BASE = (
    "from typing import List\n"
    "class RoutingPolicy:\n"
    "    def pick(self, views: List[WorkerView], prompt_len: int,\n"
    "             max_new: int, urgency: float = 0.0) -> int:\n"
    "        raise NotImplementedError\n")
FROZEN = ("import dataclasses\n"
          "@dataclasses.dataclass(frozen=True)\n"
          "class Spec:\n"
          "    x: int = 0\n")
RNG = "import numpy as np\nx = np.random.normal(0, 1)\n"
SET_ITER = "for x in set(items):\n    pass\n"
TIME_EQ = "ok = t_end == horizon\n"
MUT = "self.finished.append(ev.ref)\nself.metrics.on_event(ev)\n"
RAW_ENGINE = "kv = w.engine.alloc.utilization()\n"
DECISION = ("repro/cluster/policies.py", "repro/cluster/rebalance.py",
            "repro/cluster/autoscale.py")

# (rule, source, reference path, fires): every fixture of tests/test_lint.py
FIXTURES = [
    ("REP001", RNG, SIM, True),
    ("REP001", "import numpy as np\nnp.random.seed(0)\n", SIM, True),
    ("REP001", "import numpy as np\nrng = np.random.default_rng()\n", SIM, True),
    ("REP001", "import random\nx = random.random()\n", SIM, True),
    ("REP001", "import numpy as np\nrng = np.random.default_rng(42)\n"
               "x = rng.normal(0, 1)\n", SIM, False),
    ("REP001", RNG, OTHER, False),
    ("REP001", RNG, LAUNCH, True),
    ("REP001", RNG, OBS, True),
    ("REP003", SET_ITER, LAUNCH, True),
    ("REP003", SET_ITER, OBS, True),
    ("REP006", TIME_EQ, LAUNCH, False),
    ("REP006", TIME_EQ, OBS, False),
    ("REP006", TIME_EQ, SIM, True),
    ("REP002", "import time\nt = time.time()\n", OTHER, True),
    ("REP002", "import time\nt = time.monotonic()\n", OTHER, True),
    ("REP002", "from datetime import datetime\nd = datetime.now()\n", OTHER, True),
    ("REP002", "t = engine.now\n", SIM, False),
    ("REP003", "for x in {1, 2, 3}:\n    pass\n", SIM, True),
    ("REP003", SET_ITER, SIM, True),
    ("REP003", "ys = [f(x) for x in {1, 2}]\n", SIM, True),
    ("REP003", "for x in sorted({1, 2, 3}):\n    pass\n", SIM, False),
    ("REP003", "for x in [1, 2, 3]:\n    pass\n", SIM, False),
    ("REP004", "key = id(engine) & 0xffff\n", SIM, True),
    ("REP004", "import itertools\nseq = itertools.count()\nkey = next(seq)\n",
     SIM, False),
    ("REP005", "def f(xs=[]):\n    pass\n", SIM, True),
    ("REP005", "def f(m={}):\n    pass\n", SIM, True),
    ("REP005", "def f(*, xs=list()):\n    pass\n", SIM, True),
    ("REP005", "def f(xs=None):\n    xs = xs or []\n", SIM, False),
    ("REP006", "if a.t_finished == b.t_finished:\n    pass\n", SIM, True),
    ("REP006", "if now != deadline:\n    pass\n", SIM, True),
    ("REP006", "if t_retire is None:\n    pass\n", SIM, False),
    ("REP006", "if abs(now - deadline) < 1e-9:\n    pass\n", SIM, False),
    ("REP006", "if count == 3:\n    pass\n", SIM, False),
    ("REP007", ROUTING_BASE + (
        "class Mine(RoutingPolicy):\n"
        "    def pick(self, views, prompt_len, max_new, urgency=0.0):\n"
        "        return 0\n"), OTHER, True),
    ("REP007", "class RebalancePolicy:\n"
               "    def decide(self, fleet):\n"
               "        raise NotImplementedError\n", OTHER, True),
    ("REP007", ROUTING_BASE + (
        "class Mine(RoutingPolicy):\n"
        "    def pick(self, views: List[WorkerView], prompt_len: int,\n"
        "             max_new: int, urgency: float = 0.0) -> int:\n"
        "        return 0\n"), OTHER, False),
    ("REP008", FROZEN + "s = Spec()\nobject.__setattr__(s, 'x', 1)\n", OTHER, True),
    ("REP008", "import dataclasses\n"
               "@dataclasses.dataclass(frozen=True)\n"
               "class Spec:\n"
               "    x: int = 0\n"
               "    def __post_init__(self):\n"
               "        object.__setattr__(self, 'x', abs(self.x))\n", OTHER, False),
    ("REP009", "eng.metrics.finish(req, t=1.0)\n", SIM, True),
    ("REP009", "self.metrics.on_event(ev)\n", SIM, True),
    ("REP009", "rt.metrics.note_migration(rec)\n", SIM, True),
    ("REP009", "note_scaling(t, 'join', w)\n", SIM, True),
    ("REP009", "eng.metrics.preemption_events.append(2.0)\n", SIM, True),
    ("REP009", "eng.metrics.t_end = 5.0\n", SIM, True),
    ("REP009", "eng.metrics.n_steps += 1\n", SIM, True),
    ("REP009", "s = eng.metrics.summary()\n", SIM, False),
    ("REP009", "x = eng.metrics.t_end\n", SIM, False),
    ("REP009", "log.subscribe(self.metrics.on_event)\n", SIM, False),
    ("REP009", "self.metrics = MetricsLog()\n", SIM, False),
    ("REP009", MUT, "repro/core/metrics.py", False),
    ("REP009", MUT, "repro/cluster/metrics.py", False),
    ("REP009", "eng.metrics.finish(r, t=0)\n", LAUNCH, False),
    *[("REP010", src, path, True) for path in DECISION for src in (
        "def pick(views):\n    return views[0].engine.alloc.free_pages\n",
        "cap = w.engine.alloc.n_pages * w.engine.alloc.page_size\n",
        "q = len(w.engine.sched.waiting)\n")],
    ("REP010", "head = v.predicted_headroom_pages() - v.candidate_pages(p, m)\n",
     DECISION[0], False),
    ("REP010", "ok = v.kv_util >= 0.9 and v.n_waiting > 0\n", DECISION[0], False),
    ("REP010", "pool = fleet.pool('decode')\n", DECISION[0], False),
    ("REP010", RAW_ENGINE, "repro/cluster/view.py", False),
    ("REP010", RAW_ENGINE, "repro/cluster/runtime.py", False),
]


def port_path(path):
    return path.replace("repro/", "repro_torch/")


def rows(findings, package):
    """Findings as comparable tuples, the package's name masked."""
    return [(f.rule_id, f.path.replace(package + "/", "PKG/"), f.line, f.severity,
             f.message.replace(package + ".", "PKG.")) for f in findings]


@pytest.mark.parametrize("rule,src,path,fires", FIXTURES,
                         ids=[f"{r}-{i}" for i, (r, *_) in enumerate(FIXTURES)])
def test_fixture_findings_equal_the_reference(rule, src, path, fires):
    """A fixture linted at its path in each package gives the same findings;
    the rule fires where ``tests/test_lint.py`` says it does."""
    mine = lint.lint_source(src, port_path(path))
    ref = jlint.lint_source(src, path)
    assert rows(mine, "repro_torch") == rows(ref, "repro")
    assert (rule in [f.rule_id for f in mine]) == fires


def test_rules_equal_the_reference_but_for_their_scopes():
    """Same ids, severities, titles and order; every path scope the
    reference's with ``repro/`` renamed."""
    mine, ref = lint.default_rules(), jlint.default_rules()
    assert [(r.rule_id, r.severity, r.title) for r in mine] \
        == [(r.rule_id, r.severity, r.title) for r in ref]
    assert [tuple(port_path(p) for p in r.paths) for r in ref] \
        == [r.paths for r in mine]
    assert sorted(lint.__all__) == sorted(jlint.__all__)


@pytest.mark.parametrize("src", [
    "import time\nt = time.time()  # lint: disable=REP002 (measuring)\n",
    "import time\n# lint: disable=REP002 (measuring real wall time here)\n"
    "# (a longer explanation may follow the pragma)\nt = time.time()\n",
    "import time\nt = time.time()  # lint: disable=REP002\n",
    "import time\nt = time.time()  # lint: disable=REP001 (wrong rule named)\n",
    "import time\nt = time.time()  # lint: disable=REP001,REP002 (both)\n",
    "x = 1  # lint: disable=REP002 ()\n",
    "def f(:\n    pass\n",
], ids=["trailing", "own_line", "no_reason", "wrong_rule", "two_rules",
        "empty_reason", "syntax_error"])
def test_suppressions_and_rep000_equal_the_reference(src):
    """``parse_suppressions`` gives the same lines and REP000 findings, and
    what the suppressions leave of the findings is the reference's. (A
    source that does not parse never reaches ``parse_suppressions``:
    ``lint_source`` reports its syntax error as REP000 first.)"""
    if not src.startswith("def f(:"):
        by_line, problems = lint.parse_suppressions(src, port_path(OTHER))
        j_by_line, j_problems = jlint.parse_suppressions(src, OTHER)
        assert by_line == j_by_line
        assert rows(problems, "repro_torch") == rows(j_problems, "repro")
    assert rows(lint.lint_source(src, port_path(OTHER)), "repro_torch") \
        == rows(jlint.lint_source(src, OTHER), "repro")


def seeded_tree(tmp_path):
    """One file with an unseeded RNG (REP001, scoped to the sim core) and a
    wall-clock read (REP002, everywhere), under both packages' core."""
    for package in ("repro", "repro_torch"):
        f = tmp_path / package / "core" / "bad.py"
        f.parent.mkdir(parents=True)
        f.write_text("import time\nimport numpy as np\n"
                     "x = np.random.normal(0, 1)\nt = time.time()\n")
    (tmp_path / "clean.py").write_text("x = 1\n")
    (tmp_path / "mutable.py").write_text("def f(xs=[]):\n    pass\n")
    return tmp_path


def test_each_linter_scopes_only_its_own_package(tmp_path):
    """The port's REP001 flags the file under ``repro_torch/core/`` and not
    the one under ``repro/core/``; the reference's the other way round.
    Unscoped REP002 flags both under both."""
    root = seeded_tree(tmp_path)
    for mod, own in ((lint, "repro_torch"), (jlint, "repro")):
        found = {(os.path.relpath(f.path, root), f.rule_id)
                 for f in mod.lint_paths([str(root)])}
        other = "repro" if own == "repro_torch" else "repro_torch"
        assert (f"{own}/core/bad.py", "REP001") in found
        assert (f"{other}/core/bad.py", "REP001") not in found
        assert {(f"{p}/core/bad.py", "REP002") for p in (own, other)} <= found
        assert ("mutable.py", "REP005") in found


def own_tree(root, package):
    """The seeded file under ``package``'s core, a clean file and one with
    a mutable default (REP005, everywhere)."""
    f = root / package / "core" / "bad.py"
    f.parent.mkdir(parents=True)
    f.write_text("import time\nimport numpy as np\n"
                 "x = np.random.normal(0, 1)\nt = time.time()\n")
    (root / "clean.py").write_text("x = 1\n")
    (root / "mutable.py").write_text("def f(xs=[]):\n    pass\n")
    return root


@pytest.mark.parametrize("args", [[], ["--json"], ["--errors-only"],
                                  ["--json", "clean.py"], ["clean.py"]],
                         ids=["text", "json", "errors_only", "json_clean", "clean"])
def test_cli_in_process_equals_the_reference(args, tmp_path, capsys):
    """Each package's ``main`` on a tree that holds the seeded file under
    its own package prints the same report (the package's name and the
    tree masked) and returns the same exit code: 1 on findings, 0 on a
    clean file."""
    outs = {}
    for package, main in (("repro_torch", lint_main), ("repro", jlint_main)):
        root = own_tree(tmp_path / package, package)
        argv = [a if a.startswith("--") else str(root / a) for a in args]
        if all(a.startswith("--") for a in args):
            argv.append(str(root))
        rc = main(argv)
        out = capsys.readouterr().out.replace(str(root) + os.sep, "ROOT/")
        outs[package] = (rc, out.replace(package + "/", "PKG/")
                         .replace(package + ".", "PKG."))
    assert outs["repro_torch"] == outs["repro"]
    rc, out = outs["repro_torch"]
    assert rc == (0 if "clean.py" in args else 1)
    if args == ["--json"]:
        assert [(r["path"], r["line"], r["rule_id"]) for r in json.loads(out)] == [
            ("ROOT/mutable.py", 1, "REP005"), ("ROOT/PKG/core/bad.py", 3, "REP001"),
            ("ROOT/PKG/core/bad.py", 4, "REP002")]


def run_cli(package, *args):
    res = subprocess.run([sys.executable, "-m", f"{package}.lint", *args],
                         env={**os.environ, "PYTHONPATH": SRC}, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    return res.returncode, res.stdout.replace(package + ".", "PKG."), \
        res.stderr.replace(package + ".", "PKG.")


@pytest.mark.parametrize("case", ["help", "bad_flag", "tree_text", "tree_json"])
def test_cli_subprocess_equals_the_reference(case, tmp_path):
    """``python -m repro_torch.lint`` prints the reference's usage, errors
    and reports (package masked) with its exit codes."""
    f = tmp_path / "bad.py"
    f.write_text("import time\nt = time.time()\ndef g(xs={}):\n    pass\n")
    args = {"help": ["--help"], "bad_flag": ["--no-such-flag"],
            "tree_text": [str(tmp_path)],
            "tree_json": ["--json", str(tmp_path)]}[case]
    mine, ref = run_cli("repro_torch", *args), run_cli("repro", *args)
    assert mine == ref
    assert mine[0] == {"help": 0, "bad_flag": 2}.get(case, 1)
    if case == "tree_json":
        assert [r["rule_id"] for r in json.loads(mine[1])] == ["REP002", "REP005"]


def test_port_tree_is_lint_clean_under_its_own_rules():
    """The port's scopes reach its engine, cluster, scenario, data, launch
    and obs modules; every legitimate pattern there carries a justified
    suppression."""
    findings = lint.lint_paths([os.path.join(SRC, "repro_torch")])
    assert findings == [], "\n".join(f.format() for f in findings)


def test_repo_src_is_lint_clean_under_the_reference_rules():
    """``python -m repro.lint src/``, the CI gate, over both packages."""
    findings = jlint.lint_paths([SRC])
    assert findings == [], "\n".join(f.format() for f in findings)
