"""AST import-graph rules over ``repro_torch/`` (twin of ``repro.analysis.imports``).

The rules walk the parsed AST, not the source text: imports are
resolved through their aliases and calls through attribute chains, so
only real code can satisfy or violate a rule (a comment or a string
never does).  The walk covers the port's package alone, under
``PORT_ROOT / "repro_torch"``; it never enters ``src/``, which the
reference's own rules cover.
"""

from __future__ import annotations

import ast
import os
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.contracts import Violation

PACKAGE = "repro_torch"
# .../repro_torch/analysis/imports.py -> the repository root
PORT_ROOT = Path(__file__).resolve().parents[2]


def iter_modules(root: Optional[Path] = None) -> Iterator[Tuple[str, Path]]:
    """Yield (dotted module name, path) for every .py file of the port's package."""
    root = Path(root) if root is not None else PORT_ROOT
    for dirpath, _, files in sorted(os.walk(root / PACKAGE)):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = Path(dirpath) / fname
            parts = list(path.relative_to(root).with_suffix("").parts)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            yield ".".join(parts), path


def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _attr_chain(node: ast.AST) -> Optional[str]:
    """``repro_torch.core.dantzig.solve_dantzig`` -> that dotted string."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _module_aliases(tree: ast.Module, module: str) -> Dict[str, str]:
    """Local names bound to ``module`` (e.g. ``dantzig``, ``_dantzig``)."""
    aliases: Dict[str, str] = {}
    parent, _, leaf = module.rpartition(".")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                # `import a.b.c` binds `a`; the full dotted chain is matched apart
                if a.name == module and a.asname:
                    aliases[a.asname] = module
        elif isinstance(node, ast.ImportFrom) and node.module == parent:
            for a in node.names:
                if a.name == leaf:
                    aliases[a.asname or a.name] = module
    return aliases


def _site(path: Path, node: ast.AST) -> Tuple[str, ...]:
    return (f"{path}:{getattr(node, 'lineno', '?')}",)


def banned_import_violations(
    root: Optional[Path] = None,
    *,
    from_module: str = "repro_torch.core.dantzig",
    name_prefix: str = "solve_dantzig",
    allowed: Tuple[str, ...] = ("repro_torch.core.solver_dispatch", "repro_torch.core.dantzig"),
) -> List[Violation]:
    """Only the dispatch layer may reach ``from_module``'s solver entries.

    Flags ``from repro_torch.core.dantzig import solve_dantzig*`` and
    any attribute use ``<alias>.solve_dantzig*`` where the alias (or
    the full dotted chain) resolves to the banned module.
    """
    rule = f"imports[{from_module}.{name_prefix}* only via {allowed}]"
    violations: List[Violation] = []
    for mod, path in iter_modules(root):
        if mod in allowed:
            continue
        tree = _parse(path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == from_module:
                for a in node.names:
                    if a.name.startswith(name_prefix):
                        violations.append(Violation(
                            rule, f"{mod} imports {a.name} from {from_module}, bypassing the "
                            "dispatch layer", _site(path, node)))
        aliases = _module_aliases(tree, from_module)
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr.startswith(name_prefix):
                base = _attr_chain(node.value)
                if base in aliases or base == from_module:
                    violations.append(Violation(
                        rule, f"{mod} calls {base}.{node.attr}, bypassing the dispatch layer",
                        _site(path, node)))
    return violations


def exclusive_call_violations(
    root: Optional[Path] = None,
    *,
    func_names: Tuple[str, ...] = ("all_gather", "all_reduce"),
    allowed: Tuple[str, ...] = ("repro_torch.core.collectives",),
) -> List[Violation]:
    """Functions that may only be *called* from the allowed modules.

    Matches both ``name(...)`` and any attribute call ending in
    ``.name(...)`` (``dist.all_reduce``, ``torch.distributed.all_gather``).
    By default: the backend's collectives are called only in
    :mod:`repro_torch.core.collectives`, the one module that tallies and
    records them; :func:`gather_call_violations` moves the reference's
    gather rule down one layer.
    """
    rule = f"imports[{'/'.join(func_names)}() only in {allowed}]"
    violations: List[Violation] = []
    for mod, path in iter_modules(root):
        if mod in allowed:
            continue
        for node in ast.walk(_parse(path)):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None)
            if name in func_names:
                violations.append(Violation(
                    rule, f"{mod} calls {name}(); that call lives only in "
                    f"{', '.join(allowed)}", _site(path, node)))
    return violations


#: The modules that may gather over the mesh: the pipeline's intra-machine
#: CLIME reassembly, the compressed uplink's payload gather and the fault
#: layer's machine stack (feeding the trimmed mean); collectives defines them.
GATHER_SITES = ("repro_torch.core.collectives", "repro_torch.core.pipeline",
                "repro_torch.core.compression", "repro_torch.core.faults")


def gather_call_violations(root: Optional[Path] = None) -> List[Violation]:
    """The reference's ``all_gather`` rule on the port's gathers: every other module
    routes through one of :data:`GATHER_SITES`."""
    return exclusive_call_violations(root, func_names=("all_gather_stack", "all_gather_tiled"),
                                     allowed=GATHER_SITES)


def _imports_module(tree: ast.Module, module: str) -> bool:
    parent, _, leaf = module.rpartition(".")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name == module or a.name.startswith(module + ".") for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if node.module == module:
                return True
            if node.module == parent and any(a.name == leaf for a in node.names):
                return True
    return False


def _referenced_names(tree: ast.Module) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
            chain = _attr_chain(node)
            if chain:
                names.add(chain)
    return names


def pipeline_unification_violations(root: Optional[Path] = None) -> List[Violation]:
    """slda, distributed and multiclass all route through core/pipeline -- directly
    (worker_debiased / debias) or via the rounds core (worker_rounds /
    simulate_multi_round), which itself is thin over pipeline.worker_solves +
    pipeline.apply_correction."""
    rule = "imports[single pipeline implementation]"
    root = Path(root) if root is not None else PORT_ROOT
    violations: List[Violation] = []
    entry_names = {"worker_debiased", "debias", "worker_rounds", "simulate_multi_round"}
    for leaf in ("slda", "distributed", "multiclass"):
        mod = f"{PACKAGE}.core.{leaf}"
        path = root / PACKAGE / "core" / f"{leaf}.py"
        tree = _parse(path)
        if not (_imports_module(tree, f"{PACKAGE}.core.pipeline")
                or _imports_module(tree, f"{PACKAGE}.core.rounds")):
            violations.append(Violation(
                rule, f"{mod} does not import the pipeline/rounds core", (str(path),)))
        if not entry_names & _referenced_names(tree):
            violations.append(Violation(
                rule, f"{mod} never calls a pipeline entry point ({sorted(entry_names)})",
                (str(path),)))
    rounds_path = root / PACKAGE / "core" / "rounds.py"
    rounds_names = _referenced_names(_parse(rounds_path))
    for needed in ("pipeline.worker_solves", "pipeline.apply_correction"):
        if needed not in rounds_names:
            violations.append(Violation(
                rule, f"{PACKAGE}.core.rounds no longer routes through {needed}",
                (str(rounds_path),)))
    return violations


# ---------------------------------------------------------------------------
# reachability: no module may exist that the port's entry points cannot reach
# ---------------------------------------------------------------------------

#: The port's surfaces, each a ``python -m`` target.
ENTRY_POINTS: Tuple[str, ...] = (
    "repro_torch.quickstart",
    "repro_torch.mesh_distributed_lda",
    "repro_torch.launch.serve",
    "repro_torch.launch.dryrun_slda",
    "repro_torch.analysis.lint",
)

#: Scripts at the repository root whose imports seed reachability.
SCRIPTS: Tuple[str, ...] = ("chip_smoke.py",)

#: The one narrowing of the rule: modules the port's tests alone import.
#: ``interop`` carries the reference's state across to the port, which
#: only the parity tests do.
TEST_ONLY: Tuple[str, ...] = ("repro_torch.interop",)


def _port_imports(tree: ast.Module, mod: str, known: set) -> set:
    """Resolved ``repro_torch.*`` module names imported by ``tree``.

    ``from repro_torch.core import transport`` yields both
    ``repro_torch.core`` and ``repro_torch.core.transport`` (when the
    latter is a known module, not an attribute); relative imports
    resolve against ``mod``'s package.  Imports inside functions count.
    """
    out: set = set()
    pkg_parts = mod.split(".")[:-1] if mod else []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == PACKAGE or a.name.startswith(PACKAGE + "."):
                    out.add(a.name)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:  # relative: resolve against this package
                anchor = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                base = ".".join(anchor + ([base] if base else []))
            if not (base == PACKAGE or base.startswith(PACKAGE + ".")):
                continue
            out.add(base)
            for a in node.names:
                sub = f"{base}.{a.name}"
                if sub in known:
                    out.add(sub)
    return out


def unreachable_module_violations(
    root: Optional[Path] = None,
    *,
    entry_points: Tuple[str, ...] = ENTRY_POINTS,
    scripts: Tuple[str, ...] = SCRIPTS,
    test_only: Tuple[str, ...] = TEST_ONLY,
) -> List[Violation]:
    """Every port module must be import-reachable from an entry point.

    Roots are the :data:`ENTRY_POINTS`, the repo-root :data:`SCRIPTS`'
    imports and the :data:`TEST_ONLY` modules.  Importing
    ``repro_torch.core.dantzig`` also marks its ancestor packages
    reachable (their ``__init__`` executes).
    """
    rule = f"imports[reachable from {entry_points + scripts}]"
    root = Path(root) if root is not None else PORT_ROOT
    modules = dict(iter_modules(root))
    trees = {mod: _parse(path) for mod, path in modules.items()}
    known = set(trees)

    def expand(name: str) -> set:
        """A module plus every ancestor package that exists."""
        parts = name.split(".")
        return {".".join(parts[:i]) for i in range(1, len(parts) + 1)} & known

    roots: set = set()
    for name in entry_points + test_only:
        roots |= expand(name)
    for script in scripts:
        path = root / script
        if path.is_file():
            for imp in _port_imports(_parse(path), "", known):
                roots |= expand(imp)

    reachable: set = set()
    frontier = list(roots)
    while frontier:
        mod = frontier.pop()
        if mod in reachable:
            continue
        reachable.add(mod)
        for imp in _port_imports(trees[mod], mod, known):
            frontier.extend(expand(imp) - reachable)

    return [
        Violation(rule, f"{mod} is unreachable from every entry point "
                  f"({', '.join(entry_points)}) and script ({', '.join(scripts)}) -- dead code; "
                  "delete it or wire it to a surface", (str(modules[mod]),))
        for mod in sorted(known - reachable)
    ]


def structural_violations(root: Optional[Path] = None) -> List[Violation]:
    """All the port's import-graph rules."""
    return (banned_import_violations(root) + exclusive_call_violations(root)
            + gather_call_violations(root) + pipeline_unification_violations(root)
            + unreachable_module_violations(root))


__all__ = [
    "ENTRY_POINTS",
    "GATHER_SITES",
    "PORT_ROOT",
    "SCRIPTS",
    "TEST_ONLY",
    "banned_import_violations",
    "exclusive_call_violations",
    "gather_call_violations",
    "iter_modules",
    "pipeline_unification_violations",
    "structural_violations",
    "unreachable_module_violations",
]
