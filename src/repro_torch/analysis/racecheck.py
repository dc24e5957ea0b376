"""AST lock-discipline lint for the farm control plane.

The farm's threading contract is documented prose (manager.py's
"Threading invariants") — this pass makes it machine-checked. It parses
the sources (never imports them), builds an OWNERSHIP MAP per class from
the :mod:`repro_torch.analysis.annotations` decorators plus observed
``with self.<lock>:`` blocks, and reports every mutation of a shared
``self.`` attribute outside its lock or owner thread.

Ownership inference, per class:

* an attribute EVER mutated while holding ``self.X`` (a ``with self.X:``
  block or an ``@locked("X")`` method, where ``X`` was assigned a
  ``threading.Lock``/``RLock`` in ``__init__``) is LOCK-GUARDED by
  ``X`` — every other mutation site must hold ``X`` (RC201);
* otherwise, an attribute mutated in an ``@control_thread_only``
  (resp. ``@slot_thread_only``) method is OWNED by that thread — a
  mutation from an unannotated or ``@any_thread`` method is a cross-
  thread write (RC202), and mixing control- and slot-owned mutations of
  one attribute is RC203. This is the ``force_evict`` shape: an
  any-thread test/CLI hook ``add()``-ing into a set the control plane's
  sweep also mutates — under this lint, a finding.
* ``__init__`` and ``@exclusive`` methods run before concurrency and are
  exempt; ``@thread_confined`` classes (``ClientDriver``) are skipped
  whole; a mutation line ending in ``# zp-cert: ok`` is suppressed.

Rule catalog:

=======  ========  ====================================================
rule     severity  hazard
=======  ========  ====================================================
RC201    error     lock-guarded attribute mutated without its lock
RC202    error     owner-thread attribute mutated from an unowned method
RC203    error     attribute mutated under two different thread owners
=======  ========  ====================================================
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Set, Tuple

RACE_RULES = {
    "RC201": "lock-guarded attribute mutated without its lock",
    "RC202": "owner-thread attribute mutated from an unowned method",
    "RC203": "attribute mutated under two different thread owners",
}

_OWNER_DECOS = {"control_thread_only": "control",
                "slot_thread_only": "slot",
                "any_thread": "any",
                "exclusive": "exclusive"}

#: method names that mutate their receiver in place
_MUTATORS = frozenset({
    "append", "appendleft", "add", "discard", "remove", "pop", "popleft",
    "popitem", "clear", "extend", "extendleft", "insert", "update",
    "setdefault"})

_SUPPRESS = "zp-cert: ok"


@dataclasses.dataclass(frozen=True)
class RaceFinding:
    rule: str
    path: str
    line: int
    cls: str
    method: str
    attr: str
    summary: str
    severity: str = "error"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self):
        return (f"{self.path}:{self.line} {self.rule} "
                f"{self.cls}.{self.method}: {self.summary}")


@dataclasses.dataclass
class _Mutation:
    attr: str
    method: str
    owner: Optional[str]        # control/slot/any/exclusive/None
    locks: frozenset            # locks held at the mutation site
    line: int


def _deco_name(deco) -> Tuple[Optional[str], Optional[ast.Call]]:
    """(bare decorator name, call node if it is a call)."""
    node = deco
    call = None
    if isinstance(node, ast.Call):
        call = node
        node = node.func
    if isinstance(node, ast.Attribute):
        return node.attr, call
    if isinstance(node, ast.Name):
        return node.id, call
    return None, call


def _self_attr(node) -> Optional[str]:
    """``self.X`` -> ``X`` (descending through subscripts: the base of
    ``self.x[k]`` is still ``x``)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _is_lock_ctor(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr in ("Lock", "RLock")
    if isinstance(fn, ast.Name):
        return fn.id in ("Lock", "RLock")
    return False


class _MethodWalker(ast.NodeVisitor):
    """Collect self-attribute mutations in one method body, tracking the
    set of ``with self.<lock>:`` locks held at each site."""

    def __init__(self, method: str, owner: Optional[str],
                 base_locks: frozenset, lock_attrs: Set[str],
                 src_lines: List[str]):
        self.method = method
        self.owner = owner
        self.locks: frozenset = base_locks
        self.lock_attrs = lock_attrs
        self.src_lines = src_lines
        self.mutations: List[_Mutation] = []
        self.lock_ctor_attrs: Set[str] = set()

    # ------------------------------------------------------- helpers --
    def _suppressed(self, line: int) -> bool:
        try:
            return _SUPPRESS in self.src_lines[line - 1]
        except IndexError:
            return False

    def _record(self, attr: Optional[str], line: int):
        if attr is None or self._suppressed(line):
            return
        self.mutations.append(_Mutation(
            attr=attr, method=self.method, owner=self.owner,
            locks=self.locks, line=line))

    # ------------------------------------------------------- visitors --
    def visit_With(self, node: ast.With):
        held = set()
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr is not None and attr in self.lock_attrs:
                held.add(attr)
        if held:
            outer = self.locks
            self.locks = frozenset(outer | held)
            for stmt in node.body:
                self.visit(stmt)
            self.locks = outer
            for item in node.items:     # with-exprs themselves
                self.visit(item.context_expr)
        else:
            self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        for tgt in node.targets:
            if isinstance(tgt, ast.Attribute) and _is_lock_ctor(node.value):
                attr = _self_attr(tgt)
                if attr is not None:
                    self.lock_ctor_attrs.add(attr)
                    continue
            if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                self._record(_self_attr(tgt), node.lineno)
            elif isinstance(tgt, (ast.Tuple, ast.List)):
                for el in tgt.elts:
                    if isinstance(el, (ast.Attribute, ast.Subscript)):
                        self._record(_self_attr(el), node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        if isinstance(node.target, (ast.Attribute, ast.Subscript)):
            self._record(_self_attr(node.target), node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None and isinstance(
                node.target, (ast.Attribute, ast.Subscript)):
            self._record(_self_attr(node.target), node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete):
        for tgt in node.targets:
            if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                self._record(_self_attr(tgt), node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS:
            self._record(_self_attr(fn.value), node.lineno)
        self.generic_visit(node)

    def visit_FunctionDef(self, node):      # nested defs: same thread
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self.generic_visit(node)


def _check_class(cls: ast.ClassDef, path: str,
                 src_lines: List[str]) -> List[RaceFinding]:
    for deco in cls.decorator_list:
        name, _ = _deco_name(deco)
        if name == "thread_confined":
            return []

    methods = [n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

    # pass 1: discover lock attributes (assigned Lock()/RLock() anywhere,
    # typically __init__) so pass 2 knows which with-blocks are locks
    lock_attrs: Set[str] = set()
    for m in methods:
        w = _MethodWalker(m.name, None, frozenset(), set(), src_lines)
        for stmt in m.body:
            w.visit(stmt)
        lock_attrs |= w.lock_ctor_attrs

    # pass 2: collect mutations with owner + held-lock context
    mutations: List[_Mutation] = []
    for m in methods:
        owner = None
        base_locks: Set[str] = set()
        for deco in m.decorator_list:
            name, call = _deco_name(deco)
            if name in _OWNER_DECOS:
                owner = _OWNER_DECOS[name]
            elif name == "locked" and call is not None and call.args:
                arg = call.args[0]
                if isinstance(arg, ast.Constant) and isinstance(
                        arg.value, str):
                    lk = arg.value
                    base_locks.add(lk[5:] if lk.startswith("self.")
                                   else lk)
        if m.name == "__init__":
            owner = "exclusive"
        w = _MethodWalker(m.name, owner, frozenset(base_locks),
                          lock_attrs, src_lines)
        for stmt in m.body:
            w.visit(stmt)
        mutations.extend(w.mutations)

    # pass 3: ownership map + findings
    findings: List[RaceFinding] = []
    by_attr: Dict[str, List[_Mutation]] = {}
    for mu in mutations:
        if mu.attr in lock_attrs:
            continue                    # rebinding a lock: out of scope
        by_attr.setdefault(mu.attr, []).append(mu)

    for attr, mus in sorted(by_attr.items()):
        live = [m for m in mus
                if m.owner != "exclusive" and m.method != "__init__"]
        if not live:
            continue
        guards: Set[str] = set()
        for m in live:
            guards |= set(m.locks)
        if guards:
            # lock-guarded attribute: every live mutation must hold ONE
            # consistent lock (the intersection of held sets across
            # sites; empty intersection = inconsistent discipline)
            common = frozenset.intersection(
                *[frozenset(m.locks) for m in live])
            if common:
                continue
            for m in live:
                if not m.locks:
                    findings.append(RaceFinding(
                        rule="RC201", path=path, line=m.line,
                        cls=cls.name, method=m.method, attr=attr,
                        summary=(f"'{attr}' is mutated under "
                                 f"{sorted(guards)} elsewhere but "
                                 f"lock-free here")))
            if all(m.locks for m in live):
                m0 = live[0]
                findings.append(RaceFinding(
                    rule="RC201", path=path, line=m0.line,
                    cls=cls.name, method=m0.method, attr=attr,
                    summary=(f"'{attr}' is mutated under inconsistent "
                             f"locks {sorted(guards)} — no single lock "
                             f"covers every site")))
            continue
        owners = {m.owner for m in live if m.owner in ("control", "slot")}
        if not owners:
            continue                    # no declared owner: no contract
        if len(owners) > 1:
            m0 = live[0]
            findings.append(RaceFinding(
                rule="RC203", path=path, line=m0.line, cls=cls.name,
                method=m0.method, attr=attr,
                summary=(f"'{attr}' is mutated from both control- and "
                         f"slot-owned methods with no lock")))
            continue
        owner = next(iter(owners))
        for m in live:
            if m.owner not in (owner, "exclusive"):
                findings.append(RaceFinding(
                    rule="RC202", path=path, line=m.line, cls=cls.name,
                    method=m.method, attr=attr,
                    summary=(f"'{attr}' is owned by the {owner} thread "
                             f"(mutated in @{owner}_thread_only methods) "
                             f"but mutated lock-free in "
                             f"'{m.method}', which any thread may call")))
    return findings


# --------------------------------------------------------- entry points --
def check_source(src: str, path: str = "<memory>") -> List[RaceFinding]:
    """Lint one module's source text."""
    tree = ast.parse(src, filename=path)
    lines = src.splitlines()
    findings: List[RaceFinding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            findings.extend(_check_class(node, path, lines))
    return findings


def check_paths(paths) -> List[RaceFinding]:
    """Lint the given files (directories recurse over ``*.py``)."""
    findings: List[RaceFinding] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, files in os.walk(p):
                for f in sorted(files):
                    if f.endswith(".py"):
                        fp = os.path.join(root, f)
                        with open(fp) as fh:
                            findings.extend(
                                check_source(fh.read(), fp))
        else:
            with open(p) as fh:
                findings.extend(check_source(fh.read(), p))
    return findings


def farm_sources() -> List[str]:
    """The control-plane sources the ZP-Cert gate lints: the port's
    ``farm/`` and the scheduler module its threading contract leans on
    (found beside this package, not imported)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [os.path.join(root, "farm"),
            os.path.join(root, "core", "schedule.py")]
