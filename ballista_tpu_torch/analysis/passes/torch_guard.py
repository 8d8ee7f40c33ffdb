"""torch-guard: CPU-side modules must not import torch or triton at module top level.

Counterpart of the JAX package's jax-guard. A scheduler, CPU executor,
Flight daemon, or client that transitively imports `torch` at import time
pays seconds of import (and can create a CUDA context on a card it was
never given) just to move bytes around. Worse, the executor heartbeat
keys its device gauges on
`sys.modules.get("ballista_tpu_torch.ops.cuda.stage_compiler")`: an
accidental eager import makes a CPU executor report device metrics. The
convention is function-level (lazy) torch imports everywhere outside the
device engine; this pass enforces it on every module reachable from the
CPU entry points via the MODULE-LEVEL import graph (a lazy import inside
a function is reachable only when the device engine actually runs, which
is the point).

`if TYPE_CHECKING:` imports are ignored; imports inside try/except at
module level still count (they execute at import time).
"""

from __future__ import annotations

import ast

from ballista_tpu_torch.analysis.core import AnalysisPass, Analyzer, Finding, SourceFile

ENTRY_POINTS = (
    "ballista_tpu_torch.scheduler.process",
    "ballista_tpu_torch.scheduler.server",
    "ballista_tpu_torch.scheduler.__main__",
    "ballista_tpu_torch.executor.executor_process",
    "ballista_tpu_torch.executor.standalone",
    "ballista_tpu_torch.executor.__main__",
    "ballista_tpu_torch.flight.server",
    "ballista_tpu_torch.flight.proxy",
    "ballista_tpu_torch.client.context",
    "ballista_tpu_torch.cli.main",
)

_BANNED = ("torch", "triton")


def _is_type_checking_if(stmt: ast.stmt) -> bool:
    if not isinstance(stmt, ast.If):
        return False
    t = stmt.test
    return (isinstance(t, ast.Name) and t.id == "TYPE_CHECKING") or (
        isinstance(t, ast.Attribute) and t.attr == "TYPE_CHECKING"
    )


def _module_level_imports(tree: ast.Module):
    """Yields (module_string, lineno) for imports that execute at module
    import time: top-level statements plus bodies of top-level if/try
    blocks (minus TYPE_CHECKING guards)."""
    stack: list[ast.stmt] = list(tree.body)
    while stack:
        stmt = stack.pop()
        if isinstance(stmt, ast.Import):
            for a in stmt.names:
                yield a.name, stmt.lineno
        elif isinstance(stmt, ast.ImportFrom):
            yield stmt.module or "", stmt.lineno, stmt.level, [a.name for a in stmt.names]
        elif isinstance(stmt, ast.If):
            if not _is_type_checking_if(stmt):
                stack.extend(stmt.body)
            stack.extend(stmt.orelse)
        elif isinstance(stmt, (ast.Try, ast.With)):
            stack.extend(stmt.body)
            if isinstance(stmt, ast.Try):
                for h in stmt.handlers:
                    stack.extend(h.body)
                stack.extend(stmt.orelse)
                stack.extend(stmt.finalbody)


def module_imports(src: SourceFile, known: set[str]) -> list[tuple[str, int]]:
    """Resolve this file's module-level imports to dotted names within the
    package (edges of the import graph) plus external roots like 'torch'."""
    tree = src.tree
    if tree is None or src.module_name is None:
        return []
    out: list[tuple[str, int]] = []
    pkg_parts = src.module_name.split(".")
    if not src.rel.endswith("/__init__.py"):
        pkg_parts = pkg_parts[:-1]  # containing package for relative imports
    for item in _module_level_imports(tree):
        if len(item) == 2:  # plain `import x.y`
            out.append((item[0], item[1]))
            continue
        mod, lineno, level, names = item
        if level:  # relative: resolve against the containing package
            base_parts = pkg_parts[: len(pkg_parts) - (level - 1)]
            base = ".".join(base_parts + ([mod] if mod else []))
        else:
            base = mod
        out.append((base, lineno))
        for n in names:  # `from pkg import submodule` edges
            cand = f"{base}.{n}" if base else n
            if cand in known:
                out.append((cand, lineno))
    return out


class TorchGuardPass(AnalysisPass):
    pass_id = "torch-guard"
    doc = "modules reachable from CPU entry points must not import torch or triton at module level"

    def run(self, analyzer: Analyzer) -> list[Finding]:
        files = analyzer.collect()
        by_mod: dict[str, SourceFile] = {}
        for f in files:
            if f.module_name:
                by_mod[f.module_name] = f
        known = set(by_mod)

        edges: dict[str, list[tuple[str, int]]] = {}
        for mod, src in by_mod.items():
            resolved: list[tuple[str, int]] = []
            for target, lineno in module_imports(src, known):
                # importing a module also imports its ancestor packages
                parts = target.split(".")
                for i in range(1, len(parts) + 1):
                    prefix = ".".join(parts[:i])
                    if prefix in known or prefix.split(".")[0] in _BANNED:
                        resolved.append((prefix, lineno))
            edges[mod] = resolved

        reachable: dict[str, str] = {}  # module -> entry point that reaches it
        stack = [(e, e) for e in ENTRY_POINTS if e in known]
        while stack:
            mod, entry = stack.pop()
            if mod in reachable:
                continue
            reachable[mod] = entry
            for target, _ in edges.get(mod, []):
                if target in known and target not in reachable:
                    stack.append((target, entry))

        findings: list[Finding] = []
        for mod, entry in sorted(reachable.items()):
            src = by_mod[mod]
            for target, lineno in edges.get(mod, []):
                if target.split(".")[0] in _BANNED:
                    findings.append(Finding(
                        self.pass_id, src.rel, lineno,
                        f"module-level import of '{target}' in a module reachable "
                        f"from CPU entry point {entry}; make the import lazy "
                        f"(function-level)",
                        symbol=target,
                    ))
        return findings
