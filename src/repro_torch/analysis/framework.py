"""Pass framework: source discovery, AST cache, registry, runner (copy of
``repro/analysis/framework.py`` over the port's package).

A pass is a named check over the repository *source tree* (never over
imported modules — every pass here must run on a box without torch,
triton or jax, and must not execute the code it inspects).  Passes
receive a :class:`PassContext` rooted at the repo (or at a temporary
mutated tree in tests), read ASTs through its cache, and return
:class:`~repro_torch.analysis.diagnostics.Diagnostic` lists.

Adding a pass: subclass :class:`AnalysisPass`, set ``name``/``codes``,
implement ``run``, and decorate with :func:`register`.  The CLI and
``run_passes`` pick it up automatically; document its codes in the
pass module's docstring.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Type

from .diagnostics import Diagnostic, apply_suppressions

__all__ = ["PassContext", "AnalysisPass", "register", "all_passes",
           "get_pass", "run_passes"]


def _find_repo_root(start: Optional[Path] = None) -> Path:
    """Locate the directory containing ``src/repro_torch`` (repo root).

    Works from an editable install (this file lives at
    ``<root>/src/repro_torch/analysis/framework.py``) and from any CWD.
    """
    here = (start or Path(__file__).resolve()).parent
    for cand in (here, *here.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    # fall back to the package's grandparent (src/..) even if layout moved
    return Path(__file__).resolve().parents[3]


class PassContext:
    """Shared state for one analysis run: root paths + parsed-AST cache."""

    def __init__(self, root: Optional[Path] = None,
                 package: str = "repro_torch") -> None:
        self.root = Path(root).resolve() if root else _find_repo_root()
        self.package = package
        self.src = self.root / "src" / package
        self._asts: Dict[str, Tuple[Path, ast.Module]] = {}
        self._sources: Dict[str, List[str]] = {}

    # -- discovery -----------------------------------------------------------

    def module_name(self, path: Path) -> str:
        """Dotted module name for a file under ``src/`` (pkg/__init__.py
        maps to the package itself)."""
        rel = path.relative_to(self.src.parent)
        parts = list(rel.with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    def iter_modules(self) -> Iterator[Tuple[str, Path]]:
        """All ``(module_name, path)`` pairs under ``src/<package>/``,
        sorted by name for deterministic diagnostic order."""
        pairs = [(self.module_name(p), p)
                 for p in sorted(self.src.rglob("*.py"))]
        return iter(sorted(pairs))

    # -- cached access --------------------------------------------------------

    def rel(self, path: Path) -> str:
        try:
            return str(path.relative_to(self.root))
        except ValueError:
            return str(path)

    def source_lines(self, path: Path) -> List[str]:
        key = self.rel(path)
        if key not in self._sources:
            self._sources[key] = path.read_text().splitlines()
        return self._sources[key]

    def tree(self, path: Path) -> ast.Module:
        key = self.rel(path)
        if key not in self._asts:
            text = "\n".join(self.source_lines(path))
            self._asts[key] = (path, ast.parse(text, filename=key))
        return self._asts[key][1]

    def module_tree(self, module: str) -> Optional[ast.Module]:
        path = self.module_path(module)
        return self.tree(path) if path else None

    def module_path(self, module: str) -> Optional[Path]:
        parts = module.split(".")
        if parts[0] != self.package:
            return None
        base = self.src.joinpath(*parts[1:])
        if (base / "__init__.py").is_file():
            return base / "__init__.py"
        if base.with_suffix(".py").is_file():
            return base.with_suffix(".py")
        return None

    @property
    def sources(self) -> Dict[str, List[str]]:
        return self._sources


class AnalysisPass:
    """Base class for one named check.  Subclasses set ``name``, the
    ``codes`` they can emit, and implement :meth:`run`."""

    name: str = ""
    codes: Tuple[str, ...] = ()
    description: str = ""

    def run(self, ctx: PassContext) -> List[Diagnostic]:
        raise NotImplementedError

    def diag(self, code: str, severity: str, message: str,
             **kw) -> Diagnostic:
        assert code in self.codes, f"{self.name} emitting undeclared {code}"
        return Diagnostic(code=code, severity=severity, message=message,
                          pass_name=self.name, **kw)


_REGISTRY: Dict[str, Type[AnalysisPass]] = {}


def register(cls: Type[AnalysisPass]) -> Type[AnalysisPass]:
    assert cls.name and cls.name not in _REGISTRY, cls
    _REGISTRY[cls.name] = cls
    return cls


def all_passes() -> Dict[str, Type[AnalysisPass]]:
    # import pass modules for side-effect registration (lazy so that
    # `import repro_torch.analysis` stays cheap and cycle-free)
    from . import (cachekey_pass, determinism_pass,  # noqa: F401
                   imports_pass, modelplane_pass)
    return dict(_REGISTRY)


def get_pass(name: str) -> AnalysisPass:
    passes = all_passes()
    if name not in passes:
        known = ", ".join(sorted(passes))
        raise KeyError(f"unknown pass {name!r} (known: {known})")
    return passes[name]()


def run_passes(names: Optional[List[str]] = None,
               root: Optional[Path] = None) -> List[Diagnostic]:
    """Run the named passes (default: all, in registration order) over
    the tree at ``root``, apply suppressions, and return diagnostics."""
    ctx = PassContext(root=root)
    passes = all_passes()
    selected = names if names is not None else list(passes)
    diags: List[Diagnostic] = []
    for name in selected:
        diags.extend(get_pass(name).run(ctx))
    return apply_suppressions(diags, ctx.sources)
