"""serde-completeness: plan nodes round-trip every constructor parameter.

This bug class has shipped before: a new `QueryStage.mesh` flag that the
graph proto round-trip silently dropped. The invariant has three legs:

1. ENCODE covers the constructor: for each `isinstance(plan, Cls)` branch
   of `serde.encode_plan`, every parameter of `Cls.__init__` must be read
   off `plan` somewhere in that branch (a parameter nobody reads cannot be
   on the wire).
2. DECODE reconstructs explicitly: every constructor call of a plan class
   inside `serde.decode_plan` must pass a value for EVERY `__init__`
   parameter. Defaulted parameters are precisely the dangerous ones — a
   new flag with a default decodes "successfully" while dropping state.
3. The stage-spec round-trip in `ExecutionGraph.from_proto` must supply
   every `QueryStage` dataclass field to the reconstructed `QueryStage`
   (this leg is what catches the mesh/broadcast class of bug).

Signatures come from runtime introspection (the classes are imported
anyway); branch structure comes from the AST of serde.py. Parameters whose
wire form is intentionally derived rather than stored verbatim are listed
in `ENCODE_ALIASES` with the attribute that carries them.
"""

from __future__ import annotations

import ast
import inspect

from ballista_tpu_torch.analysis.core import AnalysisPass, Analyzer, Finding

# encode branches read these attributes FOR the named parameter
# (param is on the wire, just under a transformed read)
ENCODE_ALIASES: dict[tuple[str, str], str] = {
    # MemoryScanExec(schema=..) stores the scan schema as .df_schema
    ("MemoryScanExec", "schema"): "df_schema",
}

SERDE_REL = "ballista_tpu_torch/serde.py"
GRAPH_REL = "ballista_tpu_torch/scheduler/state/execution_graph.py"


def _class_params(cls) -> list[str]:
    sig = inspect.signature(cls.__init__)
    return [p for p in list(sig.parameters)[1:]
            if sig.parameters[p].kind not in (inspect.Parameter.VAR_POSITIONAL,
                                              inspect.Parameter.VAR_KEYWORD)]


def _serde_classes() -> dict[str, type]:
    """Every plan-node class serde.py dispatches on, by name."""
    import ballista_tpu_torch.serde as serde
    from ballista_tpu_torch.ops.cpu.dynamic_join import DynamicJoinSelectionExec

    out: dict[str, type] = {}
    for name, obj in vars(serde).items():
        if inspect.isclass(obj) and name.endswith("Exec"):
            out[name] = obj
    out["DynamicJoinSelectionExec"] = DynamicJoinSelectionExec
    return out


def encode_branches(tree: ast.Module) -> list[tuple[str, ast.stmt, int]]:
    """(class_name, branch_body_container, lineno) for each isinstance
    branch of encode_plan. A branch testing `isinstance(p, A) or f(p)`
    yields only A — helper-dispatched classes (DynamicJoinSelectionExec)
    are checked through the explicit call-count leg instead."""
    fn = next((n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == "encode_plan"), None)
    if fn is None:
        return []
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        tests = [node.test]
        if isinstance(node.test, ast.BoolOp):
            tests = list(node.test.values)
        for t in tests:
            if (isinstance(t, ast.Call) and isinstance(t.func, ast.Name)
                    and t.func.id == "isinstance" and len(t.args) == 2
                    and isinstance(t.args[1], ast.Name)):
                out.append((t.args[1].id, node, node.lineno))
    return out


def _attr_reads(branch: ast.If, receiver: str = "plan") -> set[str]:
    reads: set[str] = set()
    for stmt in branch.body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and node.value.id == receiver:
                reads.add(node.attr)
    return reads


def decode_calls(tree: ast.Module, class_names: set[str]):
    """(class_name, n_explicit_args, has_star, lineno) for constructor
    calls inside decode_plan."""
    fn = next((n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == "decode_plan"), None)
    if fn is None:
        return
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in class_names:
            star = any(isinstance(a, ast.Starred) for a in node.args) or \
                any(k.arg is None for k in node.keywords)
            yield node.func.id, len(node.args) + len(node.keywords), star, node.lineno


class SerdeCompletenessPass(AnalysisPass):
    pass_id = "serde-sync"
    doc = "plan/stage node __init__ params must agree with encode/decode coverage"

    def run(self, analyzer: Analyzer) -> list[Finding]:
        findings: list[Finding] = []
        classes = _serde_classes()

        serde_src = analyzer.file(SERDE_REL)
        if serde_src is not None and serde_src.tree is not None:
            tree = serde_src.tree
            covered: set[str] = set()
            for cls_name, branch, lineno in encode_branches(tree):
                cls = classes.get(cls_name)
                if cls is None:
                    continue
                covered.add(cls_name)
                reads = _attr_reads(branch)
                for param in _class_params(cls):
                    attr = ENCODE_ALIASES.get((cls_name, param), param)
                    if attr not in reads:
                        findings.append(Finding(
                            self.pass_id, serde_src.rel, lineno,
                            f"encode_plan({cls_name}) never reads plan.{attr}: "
                            f"__init__ parameter '{param}' cannot reach the wire",
                            symbol=f"{cls_name}.{param}",
                        ))
            decoded: set[str] = set()
            for cls_name, n_args, star, lineno in decode_calls(tree, set(classes)):
                decoded.add(cls_name)
                if star:
                    continue
                params = _class_params(classes[cls_name])
                if n_args != len(params):
                    findings.append(Finding(
                        self.pass_id, serde_src.rel, lineno,
                        f"decode_plan builds {cls_name} with {n_args} of "
                        f"{len(params)} __init__ parameters; a defaulted "
                        f"parameter silently loses state on the wire",
                        symbol=f"{cls_name}.__call__",
                    ))
            # every encodable class must also be constructed somewhere in decode
            for cls_name in sorted(covered - decoded):
                findings.append(Finding(
                    self.pass_id, serde_src.rel, 1,
                    f"{cls_name} has an encode branch but decode_plan never "
                    f"constructs it",
                    symbol=f"{cls_name}.decode",
                ))

        # leg 3: QueryStage fields survive the ExecutionGraph proto round-trip
        findings.extend(self._check_query_stage(analyzer))
        return findings

    def _check_query_stage(self, analyzer: Analyzer) -> list[Finding]:
        import dataclasses

        from ballista_tpu_torch.scheduler.planner import QueryStage

        findings: list[Finding] = []
        fields = [f.name for f in dataclasses.fields(QueryStage)]
        src = analyzer.file(GRAPH_REL)
        if src is None or src.tree is None:
            return findings
        fn = None
        for node in ast.walk(src.tree):
            if isinstance(node, ast.FunctionDef) and node.name == "from_proto":
                fn = node
                break
        if fn is None:
            return findings
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id == "QueryStage":
                supplied = {k.arg for k in node.keywords if k.arg}
                # positional args cover leading fields in order
                supplied.update(fields[: len(node.args)])
                for f in fields:
                    if f not in supplied:
                        findings.append(Finding(
                            self.pass_id, src.rel, node.lineno,
                            f"ExecutionGraph.from_proto rebuilds QueryStage "
                            f"without '{f}': the flag is dropped on scheduler "
                            f"restart / graph hand-off",
                            symbol=f"QueryStage.{f}",
                        ))
        return findings
