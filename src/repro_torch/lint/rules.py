"""repro_torch.lint rules — our actual bug history distilled into AST checks.

A copy of ``repro.lint.rules`` whose path scopes name ``repro_torch/``, so
the rules guard the port's own engine, cluster, scenario, data, launch and
obs modules (a scope is a path substring, and ``repro/core/`` does not occur
in ``repro_torch/core/``). Every rule encodes a defect class that shipped
and was hand-found; the rule id is stable and citable from inline
suppressions (``# lint: disable=REP0xx (reason)``). Rules are
``ast.NodeVisitor`` subclasses emitting ``Finding`` rows; ``paths`` scopes a
rule to the package paths where the invariant holds (empty = everywhere).

Catalog (see docs/lint.md for the history behind each):

  REP001  unseeded / global-state RNG in simulation code
  REP002  wall-clock reachable from virtual-clock sim paths
  REP003  iteration over unordered collections (set) in sim code
  REP004  ``id(...)`` used as a key / identity token
  REP005  mutable default argument
  REP006  ``==`` / ``!=`` on virtual-time floats
  REP007  RoutingPolicy / DispatchPolicy / AutoscalePolicy signature drift
  REP008  frozen-spec dataclass mutated outside ``__post_init__``
  REP009  MetricsLog / ClusterMetrics state mutated outside the event spine
  REP010  live engine state read from a decision-plane (policy) module
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    rule_id: str
    path: str
    line: int
    severity: str                 # "error" | "warning"
    message: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule_id}] "
                f"{self.severity}: {self.message}")


# the simulation core: code where determinism invariants must hold
SIM_PATHS = ("repro_torch/core/", "repro_torch/cluster/",
             "repro_torch/scenario/", "repro_torch/data/")

# determinism scope = sim core + everything whose *output feeds* a sim run:
# launch-side sweep/spec enumeration (a shuffled or entropy-seeded sweep
# grid silently changes which scenarios a campaign runs) and the obs folds
# (two same-seed traces must window/classify identically). Rules about
# hidden nondeterminism (REP001 RNG, REP003 unordered iteration) apply
# here; engine-internal invariants (REP006 time-float equality) stay
# sim-scoped.
DET_PATHS = SIM_PATHS + ("repro_torch/launch/", "repro_torch/obs/")


class Rule(ast.NodeVisitor):
    """One lint rule: visit a module AST, emit ``Finding``s via ``report``.

    ``paths`` is a tuple of path substrings gating where the rule applies
    (normalised to "/"); empty applies everywhere. Subclasses override
    visitor methods and call ``self.report(node, message)``.
    """
    rule_id = "REP000"
    severity = "error"
    title = ""
    paths: Tuple[str, ...] = ()

    def __init__(self):
        self.findings: List[Finding] = []
        self._path = ""

    def applies_to(self, path: str) -> bool:
        p = path.replace("\\", "/")
        return not self.paths or any(tok in p for tok in self.paths)

    def run(self, tree: ast.AST, path: str) -> List[Finding]:
        self.findings = []
        self._path = path
        self.visit(tree)
        return self.findings

    def report(self, node: ast.AST, message: str):
        self.findings.append(Finding(
            rule_id=self.rule_id, path=self._path,
            line=getattr(node, "lineno", 0), severity=self.severity,
            message=message))


def _dotted(node: ast.AST) -> str:
    """'np.random.default_rng' for an Attribute/Name chain ('' otherwise)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class UnseededRNG(Rule):
    """REP001 — all randomness in sim code must thread a seeded
    ``np.random.Generator``. Module-level ``np.random.*`` draws and stdlib
    ``random.*`` share hidden global state (two call sites perturb each
    other's streams — reordering code changes every trace), and
    ``default_rng()`` without a seed is fresh entropy per process (two runs
    of one scenario disagree)."""
    rule_id = "REP001"
    title = "unseeded or global-state RNG in simulation code"
    paths = DET_PATHS

    def visit_Call(self, node: ast.Call):
        name = _dotted(node.func)
        root = name.split(".", 1)[0]
        if name.endswith("random.default_rng") and root in ("np", "numpy"):
            if not node.args and not node.keywords:
                self.report(node, "default_rng() without a seed draws fresh "
                                  "OS entropy per process; pass an explicit "
                                  "seed so runs replay")
        elif ".random." in f"{name}." and root in ("np", "numpy"):
            self.report(node, f"{name}() uses numpy's hidden global RNG; "
                              "thread a seeded np.random.Generator instead")
        elif root == "random" and name.count(".") == 1:
            self.report(node, f"{name}() uses the stdlib global RNG; thread "
                              "a seeded np.random.Generator instead")
        self.generic_visit(node)


class WallClock(Rule):
    """REP002 — ``time.time``/``time.monotonic``/``datetime.now`` reachable
    from simulation paths couples results to host speed: a virtual-clock run
    must be a pure function of (spec, seed). Real measurement code (launch
    CLIs, real-execution engine paths) suppresses with a justification."""
    rule_id = "REP002"
    title = "wall-clock call on a virtual-clock sim path"
    WALL = ("time.time", "time.monotonic", "time.perf_counter",
            "time.process_time", "datetime.now", "datetime.utcnow",
            "datetime.today", "date.today")

    def visit_Call(self, node: ast.Call):
        name = _dotted(node.func)
        if name and any(name == w or name.endswith("." + w)
                        for w in self.WALL):
            self.report(node, f"{name}() reads the wall clock; simulated "
                              "time must come from the virtual clock "
                              "(engine.now)")
        self.generic_visit(node)


def _is_set_expr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Set):
        return "a set literal"
    if isinstance(node, ast.SetComp):
        return "a set comprehension"
    if isinstance(node, ast.Call):
        name = _dotted(node.func)
        if name == "set":
            return "set(...)"
        if name in ("frozenset",):
            return "frozenset(...)"
        if name.endswith((".union", ".intersection", ".difference",
                          ".symmetric_difference")):
            return f"{name.rsplit('.', 1)[1]}(...) (a set)"
    return None


class UnorderedIteration(Rule):
    """REP003 — iterating a set in sim code lets CPython's hash seed pick
    the order; when that order reaches the event heap (worker scan order,
    tie-broken submissions) two identical runs diverge. Sort first, or keep
    a list alongside the membership set."""
    rule_id = "REP003"
    title = "iteration over an unordered collection in simulation code"
    paths = DET_PATHS

    def _check_iter(self, node: ast.AST, it: ast.AST):
        # sorted(set(...)) / sorted({...}) / sum(set) are fine: sorted
        # restores a total order, and the flagged construct is the bare
        # for-loop (min/max/len/any/all are order-insensitive)
        kind = _is_set_expr(it)
        if kind:
            self.report(node, f"iterating {kind}: set order is "
                              "hash-seed-dependent and can reach the event "
                              "loop; sort it or iterate a list")

    def visit_For(self, node: ast.For):
        self._check_iter(node, node.iter)
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension):
        self._check_iter(node, node.iter)
        self.generic_visit(node)


class IdAsKey(Rule):
    """REP004 — ``id(obj)`` is an address: the GC reuses it the moment the
    object dies, so id-derived names/keys collide across object lifetimes
    (the PR-4 worker-name collision under autoscaler minting). Use a
    monotonic counter or an explicit name."""
    rule_id = "REP004"
    title = "id(...) used as a key or identity token"

    def visit_Call(self, node: ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id == "id" \
                and len(node.args) == 1:
            self.report(node, "id(...) is a reusable address, not an "
                              "identity: a dead object's id transfers to its "
                              "successor; use a monotonic counter or name")
        self.generic_visit(node)


class MutableDefault(Rule):
    """REP005 — a mutable default is one shared object across every call:
    state leaks between requests/engines that look independent."""
    rule_id = "REP005"
    title = "mutable default argument"

    def _check_args(self, node):
        args = node.args
        for arg, default in zip(
                (args.posonlyargs + args.args)[-len(args.defaults):]
                if args.defaults else [], args.defaults):
            self._check_default(arg.arg, default)
        for arg, default in zip(args.kwonlyargs, args.kw_defaults):
            if default is not None:
                self._check_default(arg.arg, default)

    def _check_default(self, name: str, default: ast.AST):
        bad = None
        if isinstance(default, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                                ast.DictComp, ast.SetComp)):
            bad = "a mutable literal"
        elif isinstance(default, ast.Call) \
                and _dotted(default.func) in ("list", "dict", "set",
                                              "bytearray", "defaultdict",
                                              "deque"):
            bad = f"{_dotted(default.func)}(...)"
        if bad:
            self.report(default, f"default for {name!r} is {bad}, shared "
                                 "across all calls; default to None and "
                                 "build inside")

    def visit_FunctionDef(self, node):
        self._check_args(node)
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node):
        self._check_args(node)
        self.generic_visit(node)


# names that denote points on the virtual clock (or durations derived from
# it): direct equality on these floats is how the stale-horizon class of bug
# hides — two clocks that "should" coincide differ by 1e-12 after different
# summation orders
_TIME_NAME = re.compile(
    r"^(now|arrival|makespan|horizon|deadline|next_tick"
    r"|t_[a-z0-9_]+|[a-z0-9_]*_time|[a-z0-9_]*_s)$")


class FloatTimeEquality(Rule):
    """REP006 — virtual-time floats accumulate different rounding depending
    on event interleaving; ``==`` on them encodes an invariant that breaks
    at the 1e-12 level. Compare with <=/>= against an epsilon (or a shared
    tolerance helper)."""
    rule_id = "REP006"
    title = "direct ==/!= on virtual-time floats"
    paths = SIM_PATHS

    def _time_like(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Attribute) and _TIME_NAME.match(node.attr):
            return _dotted(node) or node.attr
        if isinstance(node, ast.Name) and _TIME_NAME.match(node.id):
            return node.id
        return None

    def visit_Compare(self, node: ast.Compare):
        operands = [node.left, *node.comparators]
        for op, lhs, rhs in zip(node.ops, operands, operands[1:]):
            if not isinstance(op, (ast.Eq, ast.NotEq)):
                continue
            # `x == None` is a style bug, not a tolerance bug; and equality
            # against a sentinel int like -1 is common — only flag when the
            # OTHER side is a float-ish expression or another time name
            for a, b in ((lhs, rhs), (rhs, lhs)):
                name = self._time_like(a)
                if name is None:
                    continue
                if isinstance(b, ast.Constant) and (
                        b.value is None or isinstance(b.value, (str, bool))):
                    continue
                self.report(node, f"{name!r} is virtual-clock time; == is "
                                  "brittle at float precision — compare "
                                  "against a tolerance")
                break
        self.generic_visit(node)


# the policy duck-type contracts (source of truth for REP007): every
# override must match parameter names, annotations and defaults exactly, or
# call sites using keywords / subclass-agnostic wrappers drift apart
POLICY_CONTRACTS = {
    "RoutingPolicy": {
        "pick": "(self, views: List[WorkerView], prompt_len: int, "
                "max_new: int, urgency: float = 0.0) -> int",
    },
    "DispatchPolicy": {
        "pick": "(self, views: List[WorkerView], req: Request, "
                "urgency: float = 0.0) -> Optional[int]",
    },
    "RebalancePolicy": {
        "decide": "(self, fleet: FleetView) -> Optional[RebalanceDecision]",
    },
    "AutoscalePolicy": {
        "desired_delta": "(self, s: ScalingSignals, n_provisioned: int) "
                         "-> int",
    },
}


def _signature_str(fn) -> str:
    """Canonical '(self, a: T, b: U = d) -> R' string for a FunctionDef."""
    a = fn.args
    parts = []
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    for arg, d in zip(pos, defaults):
        s = arg.arg
        if arg.annotation is not None:
            s += f": {ast.unparse(arg.annotation)}"
        if d is not None:
            s += f" = {ast.unparse(d)}" if arg.annotation is not None \
                else f"={ast.unparse(d)}"
        parts.append(s)
    if a.vararg:
        parts.append("*" + a.vararg.arg)
    for arg, d in zip(a.kwonlyargs, a.kw_defaults):
        s = arg.arg
        if arg.annotation is not None:
            s += f": {ast.unparse(arg.annotation)}"
        if d is not None:
            s += f" = {ast.unparse(d)}"
        parts.append(s)
    if a.kwarg:
        parts.append("**" + a.kwarg.arg)
    sig = "(" + ", ".join(parts) + ")"
    if fn.returns is not None:
        sig += f" -> {ast.unparse(fn.returns)}"
    return sig


class PolicyConformance(Rule):
    """REP007 — policy objects are duck-typed plug points: the runtime calls
    ``pick`` / ``desired_delta`` with keywords, so a subclass that renames,
    un-annotates or re-defaults a parameter works until the first
    keyword/default-relying call site. Overrides (and the bases themselves)
    must match the contract signature exactly."""
    rule_id = "REP007"
    title = "policy duck-type signature drift"

    def visit_ClassDef(self, node: ast.ClassDef):
        contracts = {}
        if node.name in POLICY_CONTRACTS:
            contracts = POLICY_CONTRACTS[node.name]
        else:
            for base in node.bases:
                base_name = _dotted(base).rsplit(".", 1)[-1]
                if base_name in POLICY_CONTRACTS:
                    contracts = {**contracts,
                                 **POLICY_CONTRACTS[base_name]}
        for stmt in node.body:
            if isinstance(stmt, ast.FunctionDef) and stmt.name in contracts:
                want = contracts[stmt.name]
                got = _signature_str(stmt)
                if got != want:
                    self.report(stmt, f"{node.name}.{stmt.name} signature "
                                      f"drifts from the policy contract:\n"
                                      f"      have {got}\n"
                                      f"      want {want}")
        self.generic_visit(node)


def _is_frozen_dataclass(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        if isinstance(dec, ast.Call) \
                and _dotted(dec.func).endswith("dataclass"):
            for kw in dec.keywords:
                if kw.arg == "frozen" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value is True:
                    return True
    return False


class FrozenSpecMutation(Rule):
    """REP008 — ``object.__setattr__`` is the one sanctioned escape hatch
    for frozen specs, and only inside ``__post_init__`` (normalisation at
    construction). Anywhere else it silently invalidates every consumer's
    assumption that a spec in hand never changes (hash stability, safe
    sharing across fidelities)."""
    rule_id = "REP008"
    title = "frozen-spec dataclass mutated outside __post_init__"

    def visit_Module(self, node: ast.Module):
        self._walk(node.body, in_post_init=False)

    def _walk(self, body, in_post_init: bool):
        for stmt in body:
            if isinstance(stmt, ast.ClassDef):
                frozen = _is_frozen_dataclass(stmt)
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        ok = frozen and sub.name == "__post_init__"
                        self._walk(sub.body, in_post_init=ok)
                    elif isinstance(sub, ast.ClassDef):
                        self._walk([sub], in_post_init=False)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk(stmt.body, in_post_init=False)
            else:
                for call in (n for n in ast.walk(stmt)
                             if isinstance(n, ast.Call)):
                    if _dotted(call.func) == "object.__setattr__" \
                            and not in_post_init:
                        self.report(call, "object.__setattr__ on a frozen "
                                          "spec outside __post_init__: "
                                          "specs are immutable after "
                                          "construction — build a new one "
                                          "with dataclasses.replace")


class MetricsBypass(Rule):
    """REP009 — metrics objects are fold-downs of the ``repro_torch.trace``
    event stream: their ONLY mutation path is ``on_event``, driven by the
    subscribed ``EventLog``. Sim code that pokes metrics state directly
    (calling the retired ``submit``/``finish``/``snapshot``/``note_*``
    mutators, assigning metrics attributes, or appending to metrics
    collections) re-creates the parallel-bookkeeping split the event spine
    exists to kill: the stream and the summaries silently disagree and
    ``repro_torch.trace diff`` can no longer vouch for a run. Emit an event from
    the one place that performs the transition instead."""
    rule_id = "REP009"
    title = "metrics state mutated outside the event spine"
    paths = ("repro_torch/core/", "repro_torch/cluster/",
             "repro_torch/scenario/")
    # the consumer modules themselves: on_event's folds live here
    EXCLUDE = ("repro_torch/core/metrics.py", "repro_torch/cluster/metrics.py")
    MUTATORS = ("submit", "finish", "snapshot", "on_event",
                "note_migration", "note_scaling")
    COLLECTION_MUT = ("append", "remove", "extend", "insert", "pop",
                      "clear", "update", "add")

    def applies_to(self, path: str) -> bool:
        p = path.replace("\\", "/")
        if any(tok in p for tok in self.EXCLUDE):
            return False
        return super().applies_to(p)

    def visit_Call(self, node: ast.Call):
        name = _dotted(node.func)
        parts = name.split(".")
        last = parts[-1]
        if len(parts) >= 2 and parts[-2] == "metrics" \
                and last in self.MUTATORS:
            self.report(node, f"{name}() mutates metrics state directly; "
                              "accounting derives from the event stream — "
                              "emit the transition's event instead")
        elif last in ("note_migration", "note_scaling"):
            self.report(node, f"{name}(): the note_* mutators are retired; "
                              "scaling/migration records fold out of "
                              "mint/join/retire/drained and "
                              "kv_transfer/inject events")
        elif len(parts) >= 3 and parts[-3] == "metrics" \
                and last in self.COLLECTION_MUT:
            self.report(node, f"{name}() mutates a metrics collection "
                              "behind the event stream's back; emit the "
                              "transition's event instead")
        self.generic_visit(node)

    def _check_target(self, node: ast.AST, target: ast.AST):
        # flag `x.metrics.attr = ...` / `x.metrics.attr += ...`, but not
        # `self.metrics = ...` (wiring the consumer up is construction)
        if isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Attribute) \
                and target.value.attr == "metrics":
            self.report(node, f"assignment to "
                              f"{_dotted(target) or target.attr!r} bypasses "
                              "the event stream; metrics state is a fold "
                              "over events — emit one instead")

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            self._check_target(node, t)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._check_target(node, node.target)
        self.generic_visit(node)


class DecisionPlaneBypass(Rule):
    """REP010 — policy and signal modules decide on the frozen decision
    plane (``repro_torch.cluster.view``): ``WorkerView``/``FleetView`` snapshots
    are the ONLY fleet state they may read. Reaching through a live worker
    (``.engine``, ``.alloc``, ``.sched``) re-derives KV headroom / queue
    state at the call site — the forked-math drift the unified-view refactor
    deleted (six modules each computing their own headroom, silently
    disagreeing about saturation) — and reads state mid-mutation (policies
    run inside the event loop). Add the missing field to the view instead."""
    rule_id = "REP010"
    title = "live engine state read from a decision-plane module"
    paths = ("repro_torch/cluster/policies.py",
             "repro_torch/cluster/rebalance.py",
             "repro_torch/cluster/autoscale.py")
    FORBIDDEN = ("engine", "alloc", "sched")

    def visit_Attribute(self, node: ast.Attribute):
        if node.attr in self.FORBIDDEN:
            self.report(node, f"`.{node.attr}` reaches into live engine "
                              "state from a decision-plane module; policies "
                              "and signals read frozen WorkerView/FleetView "
                              "snapshots (repro_torch.cluster.view) — add the "
                              "missing field to the view instead")
        self.generic_visit(node)


ALL_RULES = (UnseededRNG, WallClock, UnorderedIteration, IdAsKey,
             MutableDefault, FloatTimeEquality, PolicyConformance,
             FrozenSpecMutation, MetricsBypass, DecisionPlaneBypass)


def default_rules() -> List[Rule]:
    return [cls() for cls in ALL_RULES]
