"""bounded-cache: module-level mutable caches must be LruDict-bounded.

Four unbounded module dicts were once bounded by hand after they grew
without limit under sustained load. The invariant: a module-level
assignment of an EMPTY mutable container (`{}`, `[]`, `dict()`, `list()`,
`set()`, `OrderedDict()`, `defaultdict(...)`) is a cache until proven
otherwise — it must be an `LruDict` (ballista_tpu_torch.utils.lru) or carry an
`# analysis: ignore[bounded-cache] <reason>` suppression stating why it
cannot grow unbounded (e.g. keyed by fleet membership, an explicit
registration surface).

Non-empty literals are lookup tables, not caches, and are not flagged.
Names that are obviously not containers of unbounded growth (locks,
sentinel lists like __all__) are skipped by name.
"""

from __future__ import annotations

import ast

from ballista_tpu_torch.analysis.core import AnalysisPass, Analyzer, Finding

_EMPTY_CALLS = {"dict", "list", "set", "OrderedDict", "defaultdict", "deque"}
_SKIP_NAMES = {"__all__"}


def _is_empty_mutable(value: ast.expr) -> bool:
    if isinstance(value, ast.Dict) and not value.keys:
        return True
    if isinstance(value, ast.List) and not value.elts:
        return True
    if isinstance(value, ast.Call):
        fn = value.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else "")
        if name in _EMPTY_CALLS and not value.args and not value.keywords:
            return True
        if name == "defaultdict":  # defaultdict(list) etc. is still empty
            return True
    return False


class BoundedCachePass(AnalysisPass):
    pass_id = "bounded-cache"
    doc = "module-level mutable dict/list caches must be LruDict or carry a suppression"

    def run(self, analyzer: Analyzer) -> list[Finding]:
        findings: list[Finding] = []
        for src in analyzer.collect():
            tree = src.tree
            if tree is None:
                continue
            for stmt in tree.body:
                targets: list[ast.expr] = []
                value = None
                if isinstance(stmt, ast.Assign):
                    targets, value = stmt.targets, stmt.value
                elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                    targets, value = [stmt.target], stmt.value
                if value is None or not _is_empty_mutable(value):
                    continue
                for t in targets:
                    if not isinstance(t, ast.Name) or t.id in _SKIP_NAMES:
                        continue
                    findings.append(Finding(
                        self.pass_id, src.rel, stmt.lineno,
                        f"module-level mutable container '{t.id}' is unbounded; "
                        f"use ballista_tpu_torch.utils.lru.LruDict or suppress with a "
                        f"reason why it cannot grow without limit",
                        symbol=t.id,
                    ))
        return findings
