"""AST lint for the port's runtime tree (the port's copy of
``repro.verify.lint``, its rules rewritten for PyTorch's idiom): three
rules codifying hard-won serving-runtime lessons, each a bug class the
model checker cannot see because it lives in the device/host seam or in
incidental dict order.

* ``alias-dispatch`` — a host-to-device site (``torch.from_numpy``,
  ``torch.as_tensor``, the Server's ``self._tensor`` helper) must take a
  provably FRESH host buffer (assigned in the same function from a
  ``np.*`` constructor, ``.copy()``, or ``_snapshot``).
  ``torch.from_numpy`` shares the numpy buffer, and on the CPU ``.to()``
  hands the same storage to the step: passing a long-lived mutable buffer
  (``self.slot_pos``, a ``getattr`` alias) lets a later in-place host
  write reach a step's input.  The same rule flags raw host-buffer
  attributes (``page_table``, ``slot_pos``, ...) passed straight into
  the model's dispatch calls (``decode_step``/``prefill_step``/
  ``verify_step``).
* ``pool-write`` — an in-place write into a shared pool entry's ``"kv"``
  leaf: replacing ``entry["kv"]``, assigning into a slice of a tensor
  reached through it (``entry["kv"]["k"][:, dst] = ...``, or ``buf[...] =
  ...`` for a ``buf`` bound from ``entry["kv"]``), or an in-place tensor
  method on one (``buf.copy_(...)``).  The pool's pages are shared across
  requests; an unguarded write changes what other holders read.  Audited
  sites carry a waiver.
* ``ordered-policy`` — in scheduler modules, iterating a dict's
  ``.values()``/``.items()``/``.keys()`` in a loop or comprehension
  (or ``min``/``max`` with ``key=`` over one) makes a *policy
  decision* depend on insertion order; wrap in ``sorted(...)``.

Waivers: ``# verify: waive(<rule>) -- <reason>`` on the finding's line
or in the comment block above it.  The reason is mandatory — a bare
waiver does not waive (the point is an audit trail, not an off switch).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

# host-side buffers the Server mutates in place between dispatches
HOST_BUFFERS = {"slot_pos", "page_table", "refcount", "owner",
                "_top", "_slot_seq"}
# the ModelAPI calls that take a step's inputs to the device
DISPATCH_FNS = {"decode_step", "prefill_step", "verify_step"}
# host-to-device sites: torch.<fn>(buf) and the Server's self._tensor(buf)
TENSOR_FNS = {"from_numpy", "as_tensor"}
TENSOR_HELPERS = {"_tensor"}
FRESH_NP_CTORS = {"zeros", "array", "ones", "full", "empty", "arange",
                  "asarray", "zeros_like", "ones_like", "full_like",
                  "empty_like", "copy", "ascontiguousarray", "stack",
                  "concatenate"}
ORDERED_METHODS = {"values", "items", "keys"}

_WAIVE_RE = re.compile(r"#\s*verify:\s*waive\(([a-z-]+)\)(?:\s*--\s*(.*))?")

RULES = {
    "alias-dispatch": "torch.from_numpy / torch.as_tensor / _tensor / "
                      "dispatch call takes a host buffer that is not "
                      "provably fresh in this function",
    "pool-write": "in-place write into a shared pool entry's 'kv' leaf",
    "ordered-policy": "scheduler decision iterates a dict in insertion "
                      "order (wrap in sorted(...))",
}


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str
    waived: bool = False

    def __str__(self) -> str:
        tag = " (waived)" if self.waived else ""
        return f"{self.path}:{self.line}: [{self.rule}]{tag} {self.message}"


def _is_np_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in ("np", "numpy")
            and node.func.attr in FRESH_NP_CTORS)


def _is_fresh_value(node: ast.AST) -> bool:
    """A value that cannot alias long-lived mutable host state."""

    if isinstance(node, (ast.Constant, ast.List, ast.Tuple, ast.ListComp,
                         ast.GeneratorExp)):
        return True
    if _is_np_call(node):
        return True
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "copy":
            return True
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else "")
        if name.endswith("_snapshot"):
            return True
    return False


def _tensor_site(f: ast.expr) -> str | None:
    """The printable name of a host-to-device call, or None."""

    if not isinstance(f, ast.Attribute):
        return None
    if f.attr in TENSOR_FNS and isinstance(f.value, ast.Name) \
            and f.value.id in ("torch", "th"):
        return f"{f.value.id}.{f.attr}"
    if f.attr in TENSOR_HELPERS:
        return f.attr
    return None


def _is_kv_key(node: ast.AST) -> bool:
    return (isinstance(node, ast.Subscript)
            and isinstance(node.slice, ast.Constant)
            and node.slice.value == "kv")


def _mentions_kv(node: ast.AST) -> bool:
    return any(_is_kv_key(n) for n in ast.walk(node))


def _bound_names(target: ast.expr) -> list[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for t in target.elts for n in _bound_names(t)]
    return []


def _root_name(node: ast.expr) -> str | None:
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


class _FnLint(ast.NodeVisitor):
    """Per-function pass: freshness environment + the two aliasing
    rules (alias-dispatch, pool-write)."""

    def __init__(self, path: str, findings: list[Finding]):
        self.path = path
        self.findings = findings
        self.fresh: set[str] = set()
        self.tainted: set[str] = set()
        self.pool_views: set[str] = set()   # names bound from X["kv"]

    # -- freshness environment ----------------------------------------------

    def _scan_assignments(self, fn: ast.AST) -> None:
        for node in ast.walk(fn):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                if _mentions_kv(node.iter):
                    self.pool_views.update(_bound_names(node.target))
                continue
            targets: list[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets, value = list(node.targets), node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    if _is_fresh_value(value):
                        self.fresh.add(t.id)
                    else:
                        self.tainted.add(t.id)
                    if _mentions_kv(value):
                        self.pool_views.add(t.id)

    def _name_fresh(self, name: str) -> bool:
        return name in self.fresh and name not in self.tainted

    def _reaches_pool(self, node: ast.expr) -> bool:
        return _mentions_kv(node) or _root_name(node) in self.pool_views

    # -- the rules ----------------------------------------------------------

    def _check_tensor_arg(self, call: ast.Call, site: str,
                          arg: ast.expr) -> None:
        if _is_fresh_value(arg):
            return
        if isinstance(arg, ast.Name):
            if self._name_fresh(arg.id):
                return
            self.findings.append(Finding(
                self.path, call.lineno, "alias-dispatch",
                f"{site}({arg.id}) — '{arg.id}' is not assigned "
                f"from a fresh buffer in this function"))
        elif isinstance(arg, ast.Attribute):
            self.findings.append(Finding(
                self.path, call.lineno, "alias-dispatch",
                f"{site}(...{arg.attr}) aliases an attribute — "
                f"long-lived host state at a dispatch boundary"))
        elif isinstance(arg, ast.Subscript):
            self.findings.append(Finding(
                self.path, call.lineno, "alias-dispatch",
                f"{site}(<subscript>) may alias a view of "
                f"long-lived host state"))

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        site = _tensor_site(f)
        if site is not None and node.args:
            self._check_tensor_arg(node, site, node.args[0])
        if isinstance(f, ast.Attribute) and f.attr in DISPATCH_FNS:
            args = list(node.args) + [kw.value for kw in node.keywords]
            for arg in args:
                if isinstance(arg, ast.Attribute) \
                        and arg.attr in HOST_BUFFERS:
                    self.findings.append(Finding(
                        self.path, node.lineno, "alias-dispatch",
                        f"raw host buffer .{arg.attr} passed to "
                        f"{f.attr}() — snapshot it first"))
        if isinstance(f, ast.Attribute) and f.attr.endswith("_") \
                and not f.attr.startswith("_") \
                and self._reaches_pool(f.value):
            self.findings.append(Finding(
                self.path, node.lineno, "pool-write",
                f"in-place .{f.attr}() on a shared pool entry's "
                f"'kv' leaf"))
        self.generic_visit(node)

    def _check_write(self, node: ast.stmt, targets: list[ast.expr]) -> None:
        for t in targets:
            if _is_kv_key(t):
                self.findings.append(Finding(
                    self.path, node.lineno, "pool-write",
                    "in-place overwrite of a shared pool entry's "
                    "'kv' leaf"))
            elif isinstance(t, ast.Subscript) and self._reaches_pool(t.value):
                self.findings.append(Finding(
                    self.path, node.lineno, "pool-write",
                    "in-place write into a tensor of a shared pool "
                    "entry's 'kv' leaf"))

    def visit_Assign(self, node: ast.Assign) -> None:
        self._check_write(node, list(node.targets))
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_write(node, [node.target])
        self.generic_visit(node)


def _lint_ordered_policy(path: str, tree: ast.AST,
                         findings: list[Finding]) -> None:
    def dict_method(node: ast.AST) -> str | None:
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ORDERED_METHODS:
            return node.func.attr
        return None

    for node in ast.walk(tree):
        iters: list[ast.expr] = []
        if isinstance(node, (ast.For, ast.AsyncFor)):
            iters = [node.iter]
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            iters = [g.iter for g in node.generators]
        for it in iters:
            m = dict_method(it)
            if m:
                findings.append(Finding(
                    path, it.lineno, "ordered-policy",
                    f"iteration over .{m}() in a scheduler module "
                    f"depends on dict insertion order"))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("min", "max") \
                and any(kw.arg == "key" for kw in node.keywords):
            for arg in node.args:
                m = dict_method(arg)
                if m:
                    findings.append(Finding(
                        path, node.lineno, "ordered-policy",
                        f"{node.func.id}(key=...) over .{m}() picks by "
                        f"dict insertion order on ties"))


# ---------------------------------------------------------------------------
# waivers + entry points
# ---------------------------------------------------------------------------


@dataclass
class LintReport:
    findings: list[Finding] = field(default_factory=list)   # unwaived
    waived: list[Finding] = field(default_factory=list)
    bad_waivers: list[Finding] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings and not self.bad_waivers

    def extend(self, other: "LintReport") -> None:
        self.findings.extend(other.findings)
        self.waived.extend(other.waived)
        self.bad_waivers.extend(other.bad_waivers)


def _apply_waivers(findings: list[Finding],
                   lines: list[str]) -> LintReport:
    rep = LintReport()
    for f in findings:
        waived = False
        # the finding's own line, then upward through the contiguous
        # comment block above it (a waiver may open a multi-line
        # justification)
        candidates = [f.line]
        ln = f.line - 1
        while 1 <= ln <= len(lines) and \
                lines[ln - 1].lstrip().startswith("#"):
            candidates.append(ln)
            ln -= 1
        for ln in candidates:
            if not 1 <= ln <= len(lines):
                continue
            m = _WAIVE_RE.search(lines[ln - 1])
            if m and m.group(1) == f.rule:
                if m.group(2) and m.group(2).strip():
                    waived = True
                else:
                    rep.bad_waivers.append(Finding(
                        f.path, ln, f.rule,
                        "waiver without a reason (use "
                        "'# verify: waive(rule) -- why')"))
                break
        if waived:
            rep.waived.append(Finding(f.path, f.line, f.rule,
                                      f.message, waived=True))
        else:
            rep.findings.append(f)
    return rep


def lint_source(src: str, path: str = "<string>") -> LintReport:
    tree = ast.parse(src, filename=path)
    findings: list[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = _FnLint(path, findings)
            fn._scan_assignments(node)
            for stmt in node.body:
                fn.visit(stmt)
    if "scheduler" in Path(path).name:
        _lint_ordered_policy(path, tree, findings)
    dedup: dict[tuple, Finding] = {}
    for f in findings:
        dedup.setdefault((f.path, f.line, f.rule, f.message), f)
    return _apply_waivers(sorted(dedup.values(),
                                 key=lambda f: (f.path, f.line)),
                          src.splitlines())


def lint_paths(paths: list[str | Path]) -> LintReport:
    """Lint every ``*.py`` under each path (a file or a directory).  A
    path that does not exist raises :class:`FileNotFoundError`: a gate
    pointed at the wrong tree must not pass on zero files."""

    rep = LintReport()
    for root in paths:
        root = Path(root)
        if not root.exists():
            raise FileNotFoundError(f"lint: no such file or directory: "
                                    f"{root}")
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for py in files:
            rep.extend(lint_source(py.read_text(), str(py)))
    return rep


__all__ = ["Finding", "LintReport", "RULES", "lint_paths", "lint_source"]
