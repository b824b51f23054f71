"""AST-level repo-invariant lint (stdlib ``ast``, no dependencies).

Tests exercise behaviour; these rules enforce conventions behaviour
can't catch — violations that pass every test but rot the codebase:

``no-time-time``        ``time.time()`` in timed paths.  Wall clock is
                        not monotonic and jumps under NTP; every timer
                        must use ``time.perf_counter()``.  Genuine
                        wall-clock uses (file mtimes) waive the rule
                        with an inline ``lint: allow=no-time-time``.
``kernel-guard``        a ``cutjoin_reduce*`` kernel-wrapper call whose
                        enclosing function/class never consults the
                        ``exact_block`` guard or a precertification
                        certificate.  The f32-chunk kernels are only
                        exact under the guard's block bound — an
                        unguarded call site silently returns wrong
                        counts on large-magnitude factors.  The f64
                        instances (``cutjoin_reduce_f64``,
                        ``cutjoin_reduce_keep_f64``) are held to the
                        same rule, with ``cutjoin_exact_f64`` (or
                        lowering's ``_f64_admits``, which calls it) as
                        their guard: unguarded, an f64 join is exact
                        only by luck.
``ir-dict-complete``    an IR dataclass (frozen, with ``to_dict`` and
                        ``refs``) whose declared fields are not all
                        serialised by ``to_dict`` and read back by the
                        module's ``*from_dict``.  A field dropped from
                        either side round-trips plans lossily — the
                        cache serves a different plan than was compiled.
``no-mutable-default``  mutable default argument values (list/dict/set
                        literals or constructors) — shared across calls,
                        a classic aliasing bug.
``mesh-guard``          a ``shard_map`` call whose enclosing function
                        never enters ``meshes.sharding_ctx``.  Sharded
                        code that bypasses the context executes against
                        whatever mesh happens to be ambient, and
                        logical-axis ``constrain`` calls inside the
                        region silently no-op or resolve against the
                        wrong mesh.  The port's sharded tier runs its
                        slots in one process and calls no
                        ``shard_map``, so the rule finds nothing there;
                        it stays for code that does.

Suppress any rule on one line with a ``lint: allow=<rule>`` comment on
that line.  CLI::

    python -m repro_torch.analysis.lint [path ...]   # default: src/repro_torch

Exit status 1 when findings remain — CI runs this as a blocking step.
"""
from __future__ import annotations

import ast
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

RULES = ("no-time-time", "kernel-guard", "ir-dict-complete",
         "no-mutable-default", "mesh-guard")

# the public kernel wrappers whose exactness depends on the block bound
# (single-device tier, its f64 instances, and the mesh-sharded
# analogues of ``distributed.cutjoin``)
_KERNEL_WRAPPERS = {"cutjoin_reduce", "cutjoin_reduce_keep",
                    "cutjoin_reduce3", "cutjoin_reduce3_keep",
                    "cutjoin_reduce_f64", "cutjoin_reduce_keep_f64",
                    "sharded_cutjoin", "sharded_cutjoin_keep",
                    "sharded_cutjoin3", "sharded_cutjoin3_keep"}
# calls that consult the guard / certificate and so satisfy the protocol
_GUARD_CALLS = {"cutjoin_exact_block", "exact_block", "precertify",
                "runtime_block", "_guard_block", "cutjoin_exact_f64",
                "_f64_admits"}

_MUTABLE_CTORS = {"list", "dict", "set", "defaultdict", "OrderedDict",
                  "deque", "Counter"}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _call_name(func) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _suppressed(source_lines, lineno: int, rule: str) -> bool:
    if not (1 <= lineno <= len(source_lines)):
        return False
    return f"lint: allow={rule}" in source_lines[lineno - 1]


def _calls_in(tree) -> list:
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)]


def _is_dataclass_decorated(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = _call_name(target) if isinstance(target, (ast.Name,
                                                         ast.Attribute)) \
            else None
        if name == "dataclass":
            return True
    return False


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    """Lint one module's source; returns findings (suppressions already
    applied)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding("syntax", path, exc.lineno or 0, str(exc.msg))]
    lines = source.splitlines()
    out: List[Finding] = []
    out.extend(_rule_time_time(tree, path, lines))
    out.extend(_rule_mutable_default(tree, path, lines))
    out.extend(_rule_kernel_guard(tree, path, lines))
    out.extend(_rule_mesh_guard(tree, path, lines))
    out.extend(_rule_ir_dict_complete(tree, path, lines))
    out.sort(key=lambda f: (f.line, f.rule))
    return out


def _rule_time_time(tree, path, lines):
    out = []
    for call in _calls_in(tree):
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr == "time" and \
                isinstance(f.value, ast.Name) and f.value.id == "time":
            if not _suppressed(lines, call.lineno, "no-time-time"):
                out.append(Finding(
                    "no-time-time", path, call.lineno,
                    "time.time() is not monotonic — use "
                    "time.perf_counter() for timing"))
    return out


def _rule_mutable_default(tree, path, lines):
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        defaults = list(fn.args.defaults) + \
            [d for d in fn.args.kw_defaults if d is not None]
        for d in defaults:
            bad = isinstance(d, (ast.List, ast.Dict, ast.Set,
                                 ast.ListComp, ast.DictComp, ast.SetComp))
            if not bad and isinstance(d, ast.Call):
                bad = _call_name(d.func) in _MUTABLE_CTORS
            if bad and not _suppressed(lines, d.lineno,
                                       "no-mutable-default"):
                out.append(Finding(
                    "no-mutable-default", path, d.lineno,
                    f"mutable default argument in {fn.name}() is shared "
                    f"across calls"))
    return out


def _rule_kernel_guard(tree, path, lines):
    """Every ``cutjoin_reduce*`` call must sit in a function (or method
    of a class) that also consults the exactness guard.  The wrappers'
    own definitions (kernels/ops.py) contain no wrapper *calls*, so the
    rule needs no module exemptions.  A guard anywhere in an enclosing
    scope covers every wrapper call in it: lowering's ``_guard_block``
    and ``_f64_admits`` are methods of ``CompiledPlan``, which holds the
    calls."""
    out = []

    def guard_present(scope) -> bool:
        return any(_call_name(c.func) in _GUARD_CALLS
                   for c in _calls_in(scope))

    def walk(node, scopes):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                walk(child, scopes + [child])
                continue
            if isinstance(child, ast.Call):
                name = _call_name(child.func)
                if name in _KERNEL_WRAPPERS and \
                        not any(guard_present(s) for s in scopes) and \
                        not _suppressed(lines, child.lineno, "kernel-guard"):
                    out.append(Finding(
                        "kernel-guard", path, child.lineno,
                        f"{name}() called without consulting the "
                        f"exact_block guard in the enclosing scope — f32 "
                        f"chunks are only exact under the guard's bound"))
            walk(child, scopes)

    walk(tree, [])
    return out


def _rule_mesh_guard(tree, path, lines):
    """Every call named exactly ``shard_map`` must sit in a function (or
    class) that also enters ``meshes.sharding_ctx`` — the mesh-tier
    contract (``distributed/cutjoin.py`` keeps it by construction).
    Deliberately name-based: an aliased import (``from ... import
    shard_map as _sm``) is the escape hatch for non-GPM users with their
    own context discipline (e.g. ``models/moe.py``)."""
    out = []

    def ctx_present(scope) -> bool:
        return any(_call_name(c.func) == "sharding_ctx"
                   for c in _calls_in(scope))

    def walk(node, scopes):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                walk(child, scopes + [child])
                continue
            if isinstance(child, ast.Call):
                name = _call_name(child.func)
                if name == "shard_map" and \
                        not any(ctx_present(s) for s in scopes) and \
                        not _suppressed(lines, child.lineno, "mesh-guard"):
                    out.append(Finding(
                        "mesh-guard", path, child.lineno,
                        "shard_map() called without entering "
                        "meshes.sharding_ctx in the enclosing scope — "
                        "sharded code must pin the mesh it executes "
                        "against"))
            walk(child, scopes)

    walk(tree, [])
    return out


def _rule_ir_dict_complete(tree, path, lines):
    """Serialisation completeness by reflection: for every dataclass
    that has both ``to_dict`` and ``refs`` methods (the IR-op shape),
    each declared field must appear as ``self.<field>`` inside
    ``to_dict`` and as a ``"<field>"`` string constant inside one of the
    module's ``*from_dict`` functions.  Mirrors what
    ``dataclasses.fields`` would report at runtime, but at the AST layer
    so the gate needs no imports."""
    from_dict_strings = set()
    has_from_dict = False
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node.name.endswith("from_dict"):
            has_from_dict = True
            for c in ast.walk(node):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    from_dict_strings.add(c.value)

    out = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef) or \
                not _is_dataclass_decorated(cls):
            continue
        methods = {m.name: m for m in cls.body
                   if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        if "to_dict" not in methods or "refs" not in methods:
            continue
        fields = [stmt.target.id for stmt in cls.body
                  if isinstance(stmt, ast.AnnAssign) and
                  isinstance(stmt.target, ast.Name)]
        to_dict = methods["to_dict"]
        serialised = {n.attr for n in ast.walk(to_dict)
                      if isinstance(n, ast.Attribute) and
                      isinstance(n.value, ast.Name) and n.value.id == "self"}
        for f in fields:
            if f in serialised:
                continue
            if _suppressed(lines, cls.lineno, "ir-dict-complete"):
                continue
            out.append(Finding(
                "ir-dict-complete", path, to_dict.lineno,
                f"{cls.name}.{f} never serialised in to_dict() — cached "
                f"plans would drop it"))
        if has_from_dict:
            for f in fields:
                if f in from_dict_strings:
                    continue
                if _suppressed(lines, cls.lineno, "ir-dict-complete"):
                    continue
                out.append(Finding(
                    "ir-dict-complete", path, cls.lineno,
                    f"{cls.name}.{f} never read back by a *from_dict() "
                    f"in this module"))
    return out


def lint_paths(paths) -> List[Finding]:
    findings: List[Finding] = []
    for path in paths:
        p = Path(path)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            findings.extend(lint_source(f.read_text(), str(f)))
    return findings


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--list-rules" in argv:
        for r in RULES:
            print(r)
        return 0
    paths = argv or ["src/repro_torch"]
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    if findings:
        print(f"{len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
