"""Pass 1 — import-boundary: the port's host plane must not reach torch
(copy of ``repro/analysis/imports_pass.py`` over the port's package).

Builds the module import graph purely from source (``ast`` — nothing is
imported or executed) and enforces the port's layering contract:

* **Protected** (host plane, must import torch-free):
  ``repro_torch.core``, ``repro_torch.explore``, ``repro_torch.trace``,
  ``repro_torch.configs``, ``repro_torch.calibrate``,
  ``repro_torch.analysis``, ``repro_torch.obs``, and the root module
  ``repro_torch`` itself (matched exactly, not as a prefix): Python runs
  ``repro_torch/__init__.py`` before any module of the port.
* **Execution plane** (may import torch eagerly): everything else under
  ``repro_torch`` — ``models``, ``kernels``, ``serve``, ``train``,
  ``launch``, ``distributed``, ``sparsity``, ``data``, ``convert`` and
  ``tree``.

Only *eager* imports count: module-scope and class-scope statements, the
bodies of module-scope ``if``/``try``/``with``.  Imports inside function
bodies are the declared lazy-site mechanism and are allowed — being
inside a ``def`` is what *verifies* them lazy, since nothing runs at
import time.  ``if TYPE_CHECKING:`` blocks never execute and are
likewise exempt.

An eager import of ``a.b.c`` also runs ``a/__init__.py`` and
``a/b/__init__.py``, so the graph adds an edge to every parent package
of an imported module.  A protected package's ``__init__`` is checked
itself, so its breach is reported there once and not again at every
importer of a module beneath it: only parent edges to execution-plane
packages carry taint to the importer.

Codes
-----
* ``CIM101`` (error) — eager import of a forbidden root (``torch``,
  ``triton``) from a protected module.
* ``CIM102`` (error) — eager import of a port module that itself
  (transitively, via eager and parent edges) reaches torch or triton.
* ``CIM103`` (error) — eager import crossing the boundary: a protected
  module imports an execution-plane module of the port at module scope.
  Even if that module is torch-free today, the edge breaks the layering
  contract the torch-free host plane relies on.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Set, Tuple

from .diagnostics import Diagnostic, Severity
from .framework import AnalysisPass, PassContext, register

__all__ = ["ImportBoundaryPass", "PROTECTED_PREFIXES", "PROTECTED_MODULES",
           "FORBIDDEN_ROOTS", "eager_imports", "build_eager_graph"]

# Prefixes of the torch-free host plane.  A module is protected when
# its dotted name equals a prefix or starts with "<prefix>.".
PROTECTED_PREFIXES: Tuple[str, ...] = (
    "repro_torch.core", "repro_torch.explore", "repro_torch.trace",
    "repro_torch.configs", "repro_torch.calibrate", "repro_torch.analysis",
    "repro_torch.obs",
)

# Modules protected by exact name only: the package root runs before
# every module of the port, the execution plane's included.
PROTECTED_MODULES: Tuple[str, ...] = ("repro_torch",)

# Import roots the host plane must never reach eagerly.
FORBIDDEN_ROOTS: Tuple[str, ...] = ("torch", "triton")


def is_protected(module: str) -> bool:
    return module in PROTECTED_MODULES or any(
        module == p or module.startswith(p + ".") for p in PROTECTED_PREFIXES)


@dataclasses.dataclass
class ImportSite:
    target: str        # dotted module the statement names
    lineno: int
    lazy: bool         # inside a function body (or TYPE_CHECKING guard)


def _is_type_checking_guard(node: ast.If) -> bool:
    t = node.test
    return ((isinstance(t, ast.Name) and t.id == "TYPE_CHECKING")
            or (isinstance(t, ast.Attribute) and t.attr == "TYPE_CHECKING"))


def _resolve_from(module: str, node: ast.ImportFrom,
                  is_package: bool = False) -> List[str]:
    """Absolute candidate targets of a ``from X import a, b`` statement.

    For relative imports the base is computed from the importing
    module's package.  Each imported name is also emitted as a candidate
    submodule (``from ..core import workload`` reaches
    ``repro_torch.core.workload`` when ``workload`` is a module).  In a
    package's ``__init__`` (``is_package``) one dot names the package
    itself."""
    if node.level == 0:
        base = node.module or ""
    else:
        # strip the module's own leaf, then one package per extra dot
        parts = module.split(".")
        parts = parts[:len(parts) - node.level + int(is_package)]
        if node.module:
            parts.append(node.module)
        base = ".".join(parts)
    if not base:
        return []
    out = [base]
    out.extend(f"{base}.{alias.name}" for alias in node.names
               if alias.name != "*")
    return out


def eager_imports(module: str, tree: ast.Module,
                  is_package: bool = False) -> List[ImportSite]:
    """Every import statement in ``tree`` with its laziness resolved."""
    sites: List[ImportSite] = []

    def visit(node: ast.AST, lazy: bool) -> None:
        for child in ast.iter_child_nodes(node):
            child_lazy = lazy
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                child_lazy = True
            elif isinstance(child, ast.If) and _is_type_checking_guard(child):
                child_lazy = True
            if isinstance(child, ast.Import):
                for alias in child.names:
                    sites.append(ImportSite(alias.name, child.lineno, lazy))
            elif isinstance(child, ast.ImportFrom):
                for target in _resolve_from(module, child, is_package):
                    sites.append(ImportSite(target, child.lineno, lazy))
            else:
                visit(child, child_lazy)

    visit(tree, lazy=False)
    return sites


def build_eager_graph(ctx: PassContext) -> Dict[str, List[ImportSite]]:
    """module -> eager import sites, for every module under src/repro_torch."""
    graph: Dict[str, List[ImportSite]] = {}
    for module, path in ctx.iter_modules():
        sites = eager_imports(module, ctx.tree(path),
                              path.name == "__init__.py")
        graph[module] = [s for s in sites if not s.lazy]
    return graph


def _internal_target(target: str, modules: Set[str]) -> str:
    """Map an import target onto a known port module (longest match),
    or '' when it is external."""
    parts = target.split(".")
    for i in range(len(parts), 0, -1):
        cand = ".".join(parts[:i])
        if cand in modules:
            return cand
    return ""


def _packages(module: str) -> List[str]:
    """The parent packages of ``module``, outermost first."""
    parts = module.split(".")
    return [".".join(parts[:i]) for i in range(1, len(parts))]


def _runs(dep: str, module: str, modules: Set[str]) -> Set[str]:
    """The port modules that an eager import of ``dep`` from ``module``
    runs and that can carry taint to it: ``dep`` and its execution-plane
    parent packages (importing ``a.b.c`` runs ``a/__init__.py`` and
    ``a/b/__init__.py`` first).  A protected package reports its own
    breach, and ``module``'s own packages have run before it."""
    done = {module, *_packages(module)}
    return {m for m in (dep, *_packages(dep))
            if m in modules and m not in done
            and (m == dep or not is_protected(m))}


def _torch_tainted(graph: Dict[str, List[ImportSite]],
                   modules: Set[str]) -> Set[str]:
    """Modules whose *import* (not call) transitively executes a torch
    or triton import — fixpoint over eager edges and parent edges."""
    tainted = {m for m, sites in graph.items()
               if any(s.target.split(".")[0] in FORBIDDEN_ROOTS
                      for s in sites)}
    runs = {m: set().union(*(_runs(d, m, modules) for s in sites
                             for d in [_internal_target(s.target, modules)]
                             if d))
            for m, sites in graph.items()}
    changed = True
    while changed:
        changed = False
        for m in graph:
            if m not in tainted and runs[m] & tainted:
                tainted.add(m)
                changed = True
    return tainted


@register
class ImportBoundaryPass(AnalysisPass):
    name = "import-boundary"
    codes = ("CIM101", "CIM102", "CIM103")
    description = ("host-plane modules (core/explore/trace/configs/"
                   "calibrate/analysis/obs and the package root) must not "
                   "reach torch, triton or the execution plane through "
                   "eager imports")

    def run(self, ctx: PassContext) -> List[Diagnostic]:
        graph = build_eager_graph(ctx)
        modules = set(graph)
        tainted = _torch_tainted(graph, modules)
        diags: List[Diagnostic] = []
        for module in sorted(graph):
            if not is_protected(module):
                continue
            path = ctx.module_path(module)
            rel = ctx.rel(path) if path else module
            seen: Set[Tuple[str, int, str]] = set()
            for site in graph[module]:
                root = site.target.split(".")[0]
                dep = _internal_target(site.target, modules)
                finding = None
                if root in FORBIDDEN_ROOTS:
                    finding = ("CIM101",
                               f"protected module {module} eagerly imports "
                               f"{site.target}",
                               "move the import inside the function that "
                               "needs it (lazy site), or relocate this code "
                               "to the execution plane")
                elif dep and _runs(dep, module, modules) & tainted:
                    finding = ("CIM102",
                               f"protected module {module} eagerly imports "
                               f"{dep}, which transitively imports torch or triton",
                               f"break the eager chain: make the torch "
                               f"import in {dep} (or below) lazy")
                elif dep and dep != module and not is_protected(dep):
                    finding = ("CIM103",
                               f"protected module {module} eagerly imports "
                               f"execution-plane module {dep}",
                               "import it lazily inside the consuming "
                               "function, or move the shared code into the "
                               "host plane")
                if finding is None:
                    continue
                code, msg, hint = finding
                key = (code, site.lineno, dep or site.target)
                if key in seen:       # one report per statement/edge
                    continue
                seen.add(key)
                diags.append(self.diag(code, Severity.ERROR, msg,
                                       file=rel, line=site.lineno,
                                       hint=hint))
        return diags
