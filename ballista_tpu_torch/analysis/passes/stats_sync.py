"""stats-registry sync: RunStats keys emitted vs consumed vs documented.

The executor heartbeat (`_tpu_metrics`) forwards a fixed tuple of RunStats
keys as `tpu_*` gauges. Two drift modes have bitten:

- a consumer key nobody emits (gauge silently always absent — the
  `exchange_bytes_on_device` emission was nearly lost to a refactor and
  is invisible to grep because the `.set(` call spans lines), and
- an emitted key that is neither exported as a gauge nor documented in
  the RunStats docstring (diagnostics nobody can discover).

So: every key `_tpu_metrics` consumes must be emitted somewhere under
`ops/cuda/`, and every emitted key must be consumed by `_tpu_metrics` OR
named in the RunStats class docstring. Emission sites are found by AST —
`<anything>.set("key", ...)`-style calls where the receiver smells like a
stats sink (RUN_STATS / rec / stats / run-scope handles) and string
subscript stores on the same receivers.
"""

from __future__ import annotations

import ast

from ballista_tpu_torch.analysis.core import AnalysisPass, Analyzer, Finding

EXEC_REL = "ballista_tpu_torch/executor/executor_process.py"
STATS_REL = "ballista_tpu_torch/ops/cuda/stage_compiler.py"

_SINK_NAMES = {"RUN_STATS", "rec", "stats", "run_stats", "_rec", "srec"}


def _receiver_name(node: ast.expr) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def emitted_keys(analyzer: Analyzer) -> dict[str, tuple[str, int]]:
    """key -> (rel, lineno) across ops/cuda/ modules."""
    out: dict[str, tuple[str, int]] = {}
    for src in analyzer.collect():
        if not src.rel.startswith("ballista_tpu_torch/ops/cuda/"):
            continue
        tree = src.tree
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "set" and node.args:
                if _receiver_name(node.func.value) not in _SINK_NAMES:
                    continue
                k = node.args[0]
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    out.setdefault(k.value, (src.rel, node.lineno))
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Subscript) and \
                            _receiver_name(t.value) in _SINK_NAMES and \
                            isinstance(t.slice, ast.Constant) and \
                            isinstance(t.slice.value, str):
                        out.setdefault(t.slice.value, (src.rel, node.lineno))
    return out


def consumed_keys(analyzer: Analyzer) -> dict[str, int]:
    """key -> lineno consumed by _tpu_metrics: the gauge tuple iterated by
    its for-loop plus `"key" in stats` membership checks."""
    src = analyzer.file(EXEC_REL)
    out: dict[str, int] = {}
    if src is None or src.tree is None:
        return out
    fn = None
    for node in ast.walk(src.tree):
        if isinstance(node, ast.FunctionDef) and node.name == "_tpu_metrics":
            fn = node
            break
    if fn is None:
        return out
    for node in ast.walk(fn):
        if isinstance(node, ast.For) and isinstance(node.iter, (ast.Tuple, ast.List)):
            for elt in node.iter.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    out.setdefault(elt.value, elt.lineno)
        elif isinstance(node, ast.Compare) and len(node.ops) == 1 \
                and isinstance(node.ops[0], ast.In) \
                and isinstance(node.left, ast.Constant) \
                and isinstance(node.left.value, str) \
                and _receiver_name(node.comparators[0]) in ("stats",):
            out.setdefault(node.left.value, node.lineno)
    return out


def _runstats_docstring(analyzer: Analyzer) -> str:
    src = analyzer.file(STATS_REL)
    if src is None or src.tree is None:
        return ""
    for node in src.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "RunStats":
            return ast.get_docstring(node) or ""
    return ""


class StatsRegistrySyncPass(AnalysisPass):
    pass_id = "stats-sync"
    doc = "RunStats keys: heartbeat consumers must be emitted; emissions documented"

    def run(self, analyzer: Analyzer) -> list[Finding]:
        findings: list[Finding] = []
        emitted = emitted_keys(analyzer)
        consumed = consumed_keys(analyzer)
        doc = _runstats_docstring(analyzer)

        for key, lineno in sorted(consumed.items()):
            if key not in emitted:
                findings.append(Finding(
                    self.pass_id, EXEC_REL, lineno,
                    f"heartbeat gauge tpu_{key} consumes RunStats key '{key}' "
                    f"but nothing under ops/cuda/ emits it",
                    symbol=f"consumed:{key}",
                ))
        for key, (rel, lineno) in sorted(emitted.items()):
            if key in consumed or key in doc:
                continue
            findings.append(Finding(
                self.pass_id, rel, lineno,
                f"RunStats key '{key}' is emitted but neither exported by the "
                f"heartbeat nor documented in the RunStats docstring",
                symbol=f"emitted:{key}",
            ))
        return findings
