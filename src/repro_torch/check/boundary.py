"""Host/device boundary lint for torch code (rules BND001-BND004 and
PLN001-PLN002), the counterpart of ``repro.check.boundary``.

The port runs eagerly: a host sync inside a device loop (``.item()``, a
Python branch on a tensor, ``np.*`` on a tensor) does not fail the way a
tracer does under ``jax.jit``; it silently makes the host wait for the card
on every iteration.  One AST pass per file:

**Device-loop rules (BND001-BND004).**  A function is *device loop* when
``config.DEVICE_LOOP_FUNCTIONS`` names it for its file (the fleet engine's
pop and chain segments, the decode step, the step builders, the server
tick), when it is handed to ``torch.func.vmap`` / ``grad`` /
``grad_and_value`` / ``value_and_grad`` or ``torch.utils.checkpoint``
(directly, or via a factory call whose nested defs all count), or when it
is nested in a device-loop def.  Inside those a light forward taint pass
tracks which names hold device tensors, as ``repro``'s does for tracers:

- parameters seed the set, except ``self``/``cls`` and parameters annotated
  with a type other than a tensor (``pop(self, mafl: bool)``: a Python
  flag is not on the device);
- ``torch.*`` / ``F.*`` call results and anything derived from tainted
  values propagate it;
- ``.shape`` / ``.dtype`` / ``.device`` (and the metadata methods
  ``.dim()``, ``.size()``, ``.numel()``, ...) reads drop it, as do
  ``len()``, ``isinstance()`` and identity or membership tests;
- a sync (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``float()``/``int()``/``bool()``, ``np.*``) reports and yields a host
  value.

Functions merely called from device-loop code get the weak rule set: only
BND004 (``torch.float64``, ``.double()``, an f64 literal), which is wrong
whatever the arguments are.

**Planner rules (PLN001-PLN002).**  The dual contract for the f64 dry-run
planner (``plan_fleet``): no engine/kernel or torch imports, no torch, no
f32 drop mid-plan.

``repro``'s BND005 (a donated buffer read after the donating call) has no
counterpart: torch has no ``donate_argnums``.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Optional

from repro_torch.check import config
from repro_torch.check.findings import Finding

NP_ROOTS = {"np", "numpy"}
DEVICE_ROOTS = {"torch", "F"}
SHAPE_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
               "requires_grad"}
# tensor methods that read host-side metadata, never device values
META_METHODS = {"size", "dim", "numel", "nelement", "data_ptr",
                "is_contiguous", "element_size", "stride", "storage_offset",
                "get_device", "is_floating_point"}
# builtins whose result is a host value computed without reading the device
HOST_BUILTINS = {"len", "isinstance"}
SCALAR_PULLS = {"float", "int", "bool", "complex"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
F64_ATTRS = {"float64", "double"}
F64_STRINGS = {"float64", "f8", ">f8", "<f8"}
F32_STRINGS = {"float32", "f4", ">f4", "<f4"}
HOST_ITER_FUNCS = {"zip", "enumerate", "range", "reversed", "sorted",
                   "list", "tuple", "items", "keys", "values"}
# parameter annotations that name a tensor (everything else is host data)
TENSOR_ANNOTATIONS = {"Tensor"}

# callables whose function-valued argument positions mark device-loop defs
_ENTRY_ARGS = {
    "vmap": (0,), "grad": (0,), "grad_and_value": (0,),
    "value_and_grad": (0,), "checkpoint": (0,),
}


def _root_name(node) -> Optional[str]:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _callee_name(func) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _host_annotation(ann) -> bool:
    """Whether a parameter annotation names a host type (anything but a
    tensor)."""
    if ann is None:
        return False
    names = {n.attr if isinstance(n, ast.Attribute) else n.id
             for n in ast.walk(ann)
             if isinstance(n, (ast.Name, ast.Attribute))}
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        names = {ann.value.rsplit(".", 1)[-1]}
    return not names & TENSOR_ANNOTATIONS


# ---------------------------------------------------------------------------
# module indexing: parents, defs, scopes
# ---------------------------------------------------------------------------
class _Module:
    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.parent: dict = {}
        self.defs: list = []
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs.append(node)

    def enclosing_def(self, node):
        n = self.parent.get(node)
        while n is not None:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return n
            n = self.parent.get(n)
        return None

    def qualname(self, d) -> str:
        parts = [d.name]
        n = self.parent.get(d)
        while n is not None:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                parts.append(n.name)
            n = self.parent.get(n)
        return ".".join(reversed(parts))

    def is_method(self, d) -> bool:
        return isinstance(self.parent.get(d), ast.ClassDef)

    def resolve_def(self, name: str, at):
        """The def a Name refers to: nearest enclosing scope first, then
        module level, then a unique global match."""
        scope = self.enclosing_def(at)
        while scope is not None:
            for d in self.defs:
                if d.name == name and self.enclosing_def(d) is scope:
                    return d
            scope = self.enclosing_def(scope)
        mod_level = [d for d in self.defs
                     if d.name == name and self.enclosing_def(d) is None
                     and not self.is_method(d)]
        if mod_level:
            return mod_level[0]
        named = [d for d in self.defs if d.name == name]
        return named[0] if len(named) == 1 else None


# ---------------------------------------------------------------------------
# marking: device loop (listed, handed to a transform, nested), weak
# ---------------------------------------------------------------------------
def _mark(mod: _Module) -> tuple[set, set]:
    """(device-loop def nodes, weak def nodes).  Lambdas handed to a
    transform are handled inline by the taint pass (they cannot contain
    statements)."""
    loop: set = set()

    listed = ()
    for suffix, names in config.DEVICE_LOOP_FUNCTIONS.items():
        if config.matches(mod.path, (suffix,)):
            listed = names
    for d in mod.defs:
        if mod.qualname(d) in listed:
            loop.add(d)

    def mark_fn_expr(expr, at):
        if isinstance(expr, ast.Name):
            d = mod.resolve_def(expr.id, at)
            if d is not None:
                loop.add(d)
        elif isinstance(expr, ast.Call):
            # factory call: every def nested in the factory runs
            name = _callee_name(expr.func)
            d = mod.resolve_def(name, at) if name else None
            if d is not None:
                for sub in ast.walk(d):
                    if isinstance(sub, ast.FunctionDef) and sub is not d:
                        loop.add(sub)

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            spots = _ENTRY_ARGS.get(_callee_name(node.func))
            for i in spots or ():
                if i < len(node.args):
                    mark_fn_expr(node.args[i], node)

    # nesting closure: defs inside device-loop defs are device loop
    changed = True
    while changed:
        changed = False
        for d in mod.defs:
            if d in loop:
                continue
            enc = mod.enclosing_def(d)
            if enc is not None and enc in loop:
                loop.add(d)
                changed = True

    # weak reachability: defs called by name from device-loop (or weak) defs
    weak: set = set()
    frontier = list(loop)
    while frontier:
        src = frontier.pop()
        for node in ast.walk(src):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                d = mod.resolve_def(node.func.id, node)
                if d is not None and d not in loop and d not in weak:
                    weak.add(d)
                    frontier.append(d)
    return loop, weak


# ---------------------------------------------------------------------------
# taint lint over one device-loop def
# ---------------------------------------------------------------------------
class _TaintLint:
    def __init__(self, mod: _Module, findings: list, loop: set):
        self.mod = mod
        self.findings = findings
        self.loop = loop
        self.done: set = set()

    def hit(self, rule, node, msg):
        self.findings.append(Finding(rule, self.mod.path, node.lineno, msg))

    def run_def(self, fn, inherited=()):
        if fn in self.done:
            return
        self.done.add(fn)
        tainted = set(inherited)
        a = fn.args
        params = [*a.posonlyargs, *a.args, *a.kwonlyargs,
                  *([a.vararg] if a.vararg else []),
                  *([a.kwarg] if a.kwarg else [])]
        if self.mod.is_method(fn) and params:
            params = params[1:]                  # self / cls
        for arg in params:
            if _host_annotation(arg.annotation):
                tainted.discard(arg.arg)
            else:
                tainted.add(arg.arg)
        self.block(fn.body, tainted)

    # -- statements --------------------------------------------------------
    def block(self, stmts, tainted):
        for s in stmts:
            self.stmt(s, tainted)

    def assign_target(self, target, t: bool, tainted):
        if isinstance(target, ast.Name):
            (tainted.add if t else tainted.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self.assign_target(el, t, tainted)
        elif isinstance(target, ast.Starred):
            self.assign_target(target.value, t, tainted)
        # subscript/attribute targets mutate containers; no name to track

    def stmt(self, s, tainted):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if s in self.loop:
                self.run_def(s, inherited=frozenset(tainted))
            return
        if isinstance(s, ast.Assign):
            t = self.taint(s.value, tainted)
            if (isinstance(s.value, ast.Tuple)
                    and len(s.targets) == 1
                    and isinstance(s.targets[0], ast.Tuple)
                    and len(s.targets[0].elts) == len(s.value.elts)):
                for tgt, val in zip(s.targets[0].elts, s.value.elts):
                    self.assign_target(tgt, self.taint(val, tainted),
                                       tainted)
            else:
                for tgt in s.targets:
                    self.assign_target(tgt, t, tainted)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self.assign_target(s.target, self.taint(s.value, tainted),
                                   tainted)
        elif isinstance(s, ast.AugAssign):
            t = self.taint(s.value, tainted)
            if isinstance(s.target, ast.Name) and t:
                tainted.add(s.target.id)
        elif isinstance(s, ast.If):
            if self.taint(s.test, tainted):
                self.hit("BND002", s.test,
                         "Python `if` on a device tensor")
            self.block(s.body, tainted)
            self.block(s.orelse, tainted)
        elif isinstance(s, ast.While):
            if self.taint(s.test, tainted):
                self.hit("BND002", s.test,
                         "Python `while` on a device tensor")
            self.block(s.body, tainted)
            self.block(s.body, tainted)
        elif isinstance(s, ast.For):
            t = self.taint(s.iter, tainted)
            host_iter = (isinstance(s.iter, ast.Call)
                         and _callee_name(s.iter.func) in HOST_ITER_FUNCS)
            if t and not host_iter:
                # zip/enumerate/... over tensors walks a host container of a
                # fixed length, not the values of a tensor
                self.hit("BND002", s.iter,
                         "Python `for` over a device tensor")
            self.assign_target(s.target, t, tainted)
            self.block(s.body, tainted)
            self.block(s.body, tainted)
            self.block(s.orelse, tainted)
        elif isinstance(s, ast.Assert):
            if self.taint(s.test, tainted):
                self.hit("BND002", s.test,
                         "`assert` on a device tensor")
        elif isinstance(s, (ast.Return, ast.Expr)):
            if s.value is not None:
                self.taint(s.value, tainted)
        elif isinstance(s, ast.With):
            for item in s.items:
                self.taint(item.context_expr, tainted)
            self.block(s.body, tainted)
        elif isinstance(s, ast.Try):
            self.block(s.body, tainted)
            for h in s.handlers:
                self.block(h.body, tainted)
            self.block(s.orelse, tainted)
            self.block(s.finalbody, tainted)
        elif isinstance(s, (ast.Delete, ast.Pass, ast.Break, ast.Continue,
                            ast.Import, ast.ImportFrom, ast.Global,
                            ast.Nonlocal, ast.Raise)):
            return
        else:
            for child in ast.iter_child_nodes(s):
                if isinstance(child, ast.expr):
                    self.taint(child, tainted)

    # -- expressions -------------------------------------------------------
    def taint(self, e, tainted) -> bool:
        if e is None:
            return False
        if isinstance(e, ast.Constant):
            if isinstance(e.value, str) and e.value in F64_STRINGS:
                self.hit("BND004", e, "'float64' dtype string in "
                         "device-loop code (device contract is f32)")
            return False
        if isinstance(e, ast.Name):
            return e.id in tainted
        if isinstance(e, ast.Attribute):
            if e.attr in F64_ATTRS:
                self.hit("BND004", e, f"{e.attr} in device-loop code "
                         "(device contract is f32)")
                return False
            if e.attr in SHAPE_ATTRS:
                self.taint(e.value, tainted)
                return False
            return self.taint(e.value, tainted)
        if isinstance(e, ast.Subscript):
            return (self.taint(e.value, tainted)
                    | self.taint(e.slice, tainted))
        if isinstance(e, ast.Call):
            return self.call(e, tainted)
        if isinstance(e, ast.BinOp):
            return (self.taint(e.left, tainted)
                    | self.taint(e.right, tainted))
        if isinstance(e, ast.UnaryOp):
            return self.taint(e.operand, tainted)
        if isinstance(e, ast.BoolOp):
            return any([self.taint(v, tainted) for v in e.values])
        if isinstance(e, ast.Compare):
            res = self.taint(e.left, tainted)
            for c in e.comparators:
                res |= self.taint(c, tainted)
            # identity and membership read no tensor value
            host = all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                       for op in e.ops)
            return res and not host
        if isinstance(e, ast.IfExp):
            if self.taint(e.test, tainted):
                self.hit("BND002", e.test,
                         "conditional expression on a device tensor")
            return (self.taint(e.body, tainted)
                    | self.taint(e.orelse, tainted))
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any([self.taint(el, tainted) for el in e.elts])
        if isinstance(e, ast.Dict):
            return any([self.taint(v, tainted)
                        for v in [*e.keys, *e.values] if v is not None])
        if isinstance(e, ast.Lambda):
            inner = set(tainted)
            for arg in [*e.args.posonlyargs, *e.args.args,
                        *e.args.kwonlyargs]:
                inner.add(arg.arg)
            return self.taint(e.body, inner)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            inner = set(tainted)
            for gen in e.generators:
                self.assign_target(gen.target,
                                   self.taint(gen.iter, inner), inner)
                for cond in gen.ifs:
                    self.taint(cond, inner)
            if isinstance(e, ast.DictComp):
                return (self.taint(e.key, inner)
                        | self.taint(e.value, inner))
            return self.taint(e.elt, inner)
        if isinstance(e, ast.Starred):
            return self.taint(e.value, tainted)
        if isinstance(e, ast.JoinedStr):
            for v in e.values:
                if isinstance(v, ast.FormattedValue):
                    self.taint(v.value, tainted)
            return False
        if isinstance(e, ast.Slice):
            return any([self.taint(x, tainted)
                        for x in (e.lower, e.upper, e.step)
                        if x is not None])
        return any([self.taint(c, tainted)
                    for c in ast.iter_child_nodes(e)
                    if isinstance(c, ast.expr)])

    def call(self, e, tainted) -> bool:
        arg_taints = [self.taint(a, tainted) for a in e.args]
        arg_taints += [self.taint(kw.value, tainted) for kw in e.keywords]
        any_arg = any(arg_taints)
        func = e.func

        if isinstance(func, ast.Name):
            if func.id in SCALAR_PULLS:
                if any_arg:
                    self.hit("BND003", e,
                             f"{func.id}() on a device tensor forces a host "
                             "sync")
                return False
            if func.id in HOST_BUILTINS:
                return False
        if isinstance(func, ast.Attribute):
            if func.attr in SYNC_METHODS:
                if self.taint(func.value, tainted):
                    self.hit("BND003", e,
                             f".{func.attr}() on a device tensor forces a "
                             "host sync")
                return False
            if func.attr in META_METHODS:
                self.taint(func.value, tainted)
                return False

        root = _root_name(func)
        if root in NP_ROOTS:
            if any_arg:
                self.hit("BND001", e,
                         "np.* applied to a device tensor in device-loop "
                         "code")
            return False
        if root in DEVICE_ROOTS:
            self.taint(func, tainted)
            return True
        func_taint = (self.taint(func, tainted)
                      if isinstance(func, (ast.Attribute, ast.Subscript,
                                           ast.Call))
                      else (isinstance(func, ast.Name)
                            and func.id in tainted))
        return any_arg or bool(func_taint)


def _weak_lint(mod: _Module, fn, findings: list):
    """BND004 only: f64 on the device is wrong whatever the arguments are;
    everything else needs taint context we don't have here."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and node.attr in F64_ATTRS:
            findings.append(Finding(
                "BND004", mod.path, node.lineno,
                f"{node.attr} in a helper of device-loop code (device "
                "contract is f32)"))
        elif (isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and node.value in F64_STRINGS):
            findings.append(Finding(
                "BND004", mod.path, node.lineno,
                "'float64' dtype string in a helper of device-loop code "
                "(device contract is f32)"))


# ---------------------------------------------------------------------------
# planner rules
# ---------------------------------------------------------------------------
def _planner_import_ok(module_name: str) -> bool:
    root = module_name.split(".")[0]
    if root in ("torch", "jax", "repro"):
        return False
    if root != "repro_torch":
        return True
    return any(module_name == p or module_name.startswith(p + ".")
               for p in config.PLANNER_ALLOWED_IMPORTS)


def _planner_lint(mod: _Module, scope, findings: list):
    """PLN001/PLN002 over ``scope`` (a module or one function body)."""
    for node in ast.walk(scope):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if not _planner_import_ok(alias.name):
                    findings.append(Finding(
                        "PLN001", mod.path, node.lineno,
                        f"planner imports {alias.name!r}: planners stay "
                        "pure host numpy (f64)"))
        elif isinstance(node, ast.ImportFrom):
            name = node.module or ""
            if not _planner_import_ok(name):
                findings.append(Finding(
                    "PLN001", mod.path, node.lineno,
                    f"planner imports from {name!r}: planners stay pure "
                    "host numpy (f64)"))
        elif isinstance(node, ast.Attribute):
            if node.attr == "float32":
                findings.append(Finding(
                    "PLN002", mod.path, node.lineno,
                    "f32 drop inside the f64 planner (timelines are "
                    "exact only in f64)"))
        elif isinstance(node, ast.Name) and node.id in ("torch", "jnp"):
            findings.append(Finding(
                "PLN002", mod.path, node.lineno,
                f"{node.id} usage inside the f64 planner (device types "
                "leak into the timeline)"))
        elif (isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and node.value in F32_STRINGS):
            findings.append(Finding(
                "PLN002", mod.path, node.lineno,
                "'float32' dtype string inside the f64 planner"))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def check_source(path: str, source: str) -> list[Finding]:
    """All boundary findings for one file."""
    findings: list[Finding] = []
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("BND001", path, e.lineno or 0,
                        f"unparseable file: {e.msg}")]
    mod = _Module(path, tree)

    loop, weak = _mark(mod)
    lint = _TaintLint(mod, findings, loop)
    for fn in sorted(loop, key=lambda d: d.lineno):
        enc = mod.enclosing_def(fn)
        if enc is not None and enc in loop:
            continue             # analyzed from its enclosing def
        lint.run_def(fn)
    for fn in sorted(weak, key=lambda d: d.lineno):
        _weak_lint(mod, fn, findings)

    if config.matches(path, config.PLANNER_MODULES):
        _planner_lint(mod, mod.tree, findings)
    for suffix, fns in config.PLANNER_FUNCTIONS.items():
        if config.matches(path, (suffix,)):
            for d in mod.defs:
                if d.name in fns:
                    _planner_lint(mod, d, findings)
    # a loop body is walked twice (to reach a fixed point of the taint), so
    # one line can report twice
    unique = {(f.rule, f.line, f.message): f for f in findings}
    return list(unique.values())


def check_file(path: Path) -> list[Finding]:
    return check_source(path.as_posix(), path.read_text())
