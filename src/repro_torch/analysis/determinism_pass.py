"""Pass 4 — determinism lint: the port's host plane must be a pure
function of its inputs (copy of ``repro/analysis/determinism_pass.py``
over the port's package).

Explore results are memoised under content keys and compared across
hosts and commits; any hidden source of nondeterminism — unseeded RNG,
wall-clock reads feeding results, per-process ``hash()`` salting,
filesystem-order iteration — silently breaks that contract (a mask
seed taken from ``hash()`` was exactly this class).  This pass
AST-scans the result-producing packages (``core``, ``explore``,
``trace``, ``analysis``, ``obs``) for the known shapes of the bug.

Codes
-----
* ``CIM401`` (error) — unseeded RNG: legacy ``numpy.random.*`` global
  state, argument-less ``default_rng()``, or stdlib ``random.*``.
  Seeded construction (``default_rng(content_seed)``) is fine.  Also
  torch's global generator, the random source the port can reach that
  jax cannot: a ``torch.rand*`` / ``randn*`` / ``randint*`` /
  ``randperm`` / ``normal`` / ``bernoulli`` / ``multinomial`` draw
  without ``generator=``, and ``torch.manual_seed`` / ``torch.seed``.
  A draw from a seeded ``torch.Generator`` passed as ``generator=`` is
  fine.
* ``CIM402`` (error) — wall-clock reads: ``time.time``,
  ``datetime.now``/``utcnow``/``today``.  Monotonic timers
  (``perf_counter`` etc.) are fine — they time work, they don't enter
  results.  **Sanctioned waiver:** modules under ``repro_torch.obs``
  may read the wall clock — the observability plane stamps run
  manifests and run ids (telemetry metadata), it never produces
  results, and its output is barred from cache keys by CIM205.  The
  waiver is exactly this prefix; wall-clock reads anywhere else in the
  scanned packages still fail.
* ``CIM403`` (error) — builtin ``hash()`` outside ``__hash__``/
  ``__eq__``: salted per process since PEP 456, so never content-stable.
  Use ``hashlib`` digests.
* ``CIM404`` (error) — filesystem enumeration (``os.listdir``,
  ``scandir``, ``glob``, ``Path.iterdir``/``glob``/``rglob``) not
  wrapped directly in ``sorted(...)``: directory order is
  filesystem-dependent.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .diagnostics import Diagnostic, Severity
from .framework import AnalysisPass, PassContext, register

__all__ = ["DeterminismPass", "SCANNED_PREFIXES",
           "WALL_CLOCK_WAIVED_PREFIXES"]

SCANNED_PREFIXES: Tuple[str, ...] = (
    "repro_torch.core", "repro_torch.explore", "repro_torch.trace",
    "repro_torch.analysis", "repro_torch.obs",
)

# Module prefixes where CIM402 (wall-clock reads) is sanctioned: the
# observability plane stamps manifests/run-ids with wall time but is
# observational-only (CIM205 keeps its output away from cache keys).
WALL_CLOCK_WAIVED_PREFIXES: Tuple[str, ...] = ("repro_torch.obs",)

# numpy.random attributes that are deterministic constructors, not
# legacy global-state draws
_NP_RANDOM_OK = frozenset({
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "MT19937", "Philox", "SFC64", "RandomState",
})

# draws from torch's global generator unless ``generator=`` is given
# (``rand``, ``rand_like``, ``randn``, ``randint_like``, ...)
_TORCH_DRAW_PREFIXES = ("rand", "randn", "randint")
_TORCH_DRAWS = frozenset({"randperm", "normal", "bernoulli", "multinomial"})
# calls that seed or reseed torch's global generator (``torch.*`` and
# ``torch.random.*``)
_TORCH_GLOBAL_SEED = frozenset({"manual_seed", "seed"})

_WALL_CLOCK = frozenset({
    "time.time", "time.time_ns", "datetime.datetime.now",
    "datetime.datetime.utcnow", "datetime.date.today", "datetime.now",
    "datetime.utcnow", "date.today",
})

_FS_ENUM_DOTTED = frozenset({"os.listdir", "os.scandir", "glob.glob",
                             "glob.iglob"})
_FS_ENUM_METHODS = frozenset({"iterdir", "glob", "rglob", "scandir",
                              "listdir"})


def _alias_map(tree: ast.Module) -> Dict[str, str]:
    """name-in-scope -> real dotted prefix, from every import in the
    module (function-local imports included — usage follows them)."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                aliases[alias.asname or alias.name.split(".")[0]] = (
                    alias.name if alias.asname else alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            base = node.module or ""
            for alias in node.names:
                if alias.name == "*":
                    continue
                aliases[alias.asname or alias.name] = f"{base}.{alias.name}"
    return aliases


def _dotted(func: ast.AST) -> Optional[str]:
    """'np.random.rand' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _resolve(dotted: str, aliases: Dict[str, str]) -> str:
    head, _, rest = dotted.partition(".")
    real = aliases.get(head, head)
    return f"{real}.{rest}" if rest else real


class _Scanner(ast.NodeVisitor):
    def __init__(self, aliases: Dict[str, str]):
        self.aliases = aliases
        self.findings: List[Tuple[str, int, str, str]] = []
        self._func_stack: List[str] = []
        self._sorted_args: set = set()   # id() of calls wrapped in sorted()

    def _flag(self, code: str, lineno: int, message: str,
              hint: str) -> None:
        self.findings.append((code, lineno, message, hint))

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Call(self, node: ast.Call) -> None:
        # record direct arguments of sorted(...) so fs-enumeration calls
        # wrapped in it aren't flagged
        dotted = _dotted(node.func)
        if isinstance(node.func, ast.Name) and node.func.id == "sorted":
            for a in node.args:
                self._sorted_args.add(id(a))
        if dotted is not None:
            self._check(node, _resolve(dotted, self.aliases))
        self.generic_visit(node)

    def _check(self, node: ast.Call, name: str) -> None:
        # CIM401 — RNG
        if name.startswith("numpy.random."):
            leaf = name.rsplit(".", 1)[1]
            if leaf not in _NP_RANDOM_OK:
                self._flag("CIM401", node.lineno,
                           f"legacy global-state RNG call {name}()",
                           "draw from a content-seeded "
                           "np.random.default_rng(seed) instead")
            elif leaf in ("default_rng", "RandomState") and not node.args:
                self._flag("CIM401", node.lineno,
                           f"{name}() without a seed is entropy-seeded",
                           "derive the seed from content (e.g. blake2b "
                           "of the inputs) so reruns reproduce")
        elif name.rpartition(".")[0] in ("torch", "torch.random"):
            mod, _, leaf = name.rpartition(".")
            if leaf in _TORCH_GLOBAL_SEED:
                self._flag("CIM401", node.lineno,
                           f"{name}() seeds torch's global generator",
                           "seed a torch.Generator from content and pass "
                           "it as generator=")
            elif (mod == "torch"
                  and (leaf.split("_")[0] in _TORCH_DRAW_PREFIXES
                       or leaf in _TORCH_DRAWS)
                  and not any(k.arg == "generator" for k in node.keywords)):
                self._flag("CIM401", node.lineno,
                           f"{name}() without generator= draws from torch's "
                           f"global generator",
                           "pass generator= a torch.Generator seeded from "
                           "content (manual_seed of a blake2b digest)")
        elif name.startswith("random.") and name.count(".") == 1:
            leaf = name.rsplit(".", 1)[1]
            if not (leaf in ("Random", "SystemRandom") and node.args):
                self._flag("CIM401", node.lineno,
                           f"stdlib RNG call {name}()",
                           "use a content-seeded np.random.default_rng "
                           "(or random.Random(seed))")
        # CIM402 — wall clock
        elif name in _WALL_CLOCK:
            self._flag("CIM402", node.lineno,
                       f"wall-clock read {name}()",
                       "use time.perf_counter() for timing; results "
                       "must not depend on the clock")
        # CIM403 — salted builtin hash
        elif name == "hash" and isinstance(node.func, ast.Name):
            if not self._func_stack or self._func_stack[-1] not in (
                    "__hash__", "__eq__"):
                self._flag("CIM403", node.lineno,
                           "builtin hash() is salted per process "
                           "(PEP 456) — not content-stable",
                           "use hashlib (sha256/blake2b) over a "
                           "canonical byte form")
        # CIM404 — unsorted filesystem enumeration
        elif (name in _FS_ENUM_DOTTED
              or (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _FS_ENUM_METHODS)):
            if id(node) not in self._sorted_args:
                self._flag("CIM404", node.lineno,
                           f"filesystem enumeration {name}() without "
                           f"sorted(...) — directory order is "
                           f"filesystem-dependent",
                           "wrap the call directly in sorted()")


@register
class DeterminismPass(AnalysisPass):
    name = "determinism"
    codes = ("CIM401", "CIM402", "CIM403", "CIM404")
    description = ("core/explore/trace/analysis/obs must not read entropy "
                   "(numpy, stdlib or torch's global generator), the wall "
                   "clock, salted hashes, or directory order")

    def run(self, ctx: PassContext) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        for module, path in ctx.iter_modules():
            if not any(module == p or module.startswith(p + ".")
                       for p in SCANNED_PREFIXES):
                continue
            wall_waived = any(module == p or module.startswith(p + ".")
                              for p in WALL_CLOCK_WAIVED_PREFIXES)
            tree = ctx.tree(path)
            scanner = _Scanner(_alias_map(tree))
            # visit sorted() wrappers before their arguments: NodeVisitor
            # already walks parents first, which is what _sorted_args needs
            scanner.visit(tree)
            rel = ctx.rel(path)
            for code, lineno, msg, hint in scanner.findings:
                if code == "CIM402" and wall_waived:
                    continue        # sanctioned: obs stamps telemetry only
                diags.append(self.diag(code, Severity.ERROR, msg,
                                       file=rel, line=lineno, hint=hint))
        return diags
