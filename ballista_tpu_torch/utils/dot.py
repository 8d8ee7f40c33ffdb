"""Graphviz visualization of stage DAGs.

Rebuild of ExecutionGraphDot (scheduler/src/state/execution_graph_dot.rs:47)
and the core diagram helper (core/src/diagram.rs:43): render a job's stage
graph (and each stage's operator tree) as dot text for the REST API /
EXPLAIN tooling.
"""

from __future__ import annotations

_STATE_COLORS = {
    "unresolved": "lightgray",
    "resolved": "lightyellow",
    "running": "lightblue",
    "successful": "lightgreen",
    "failed": "lightcoral",
}


def _esc(s: str) -> str:
    return s.replace('"', '\\"').replace("\n", "\\l")


def graph_to_dot(graph) -> str:
    """graph: scheduler.state.execution_graph.ExecutionGraph"""
    lines = [
        "digraph G {",
        "  rankdir=BT;",
        f'  label="job {graph.job_id} [{graph.status.value}]";',
        "  node [shape=box, style=filled];",
    ]
    for sid in sorted(graph.stages):
        s = graph.stages[sid]
        color = _STATE_COLORS.get(s.state.value, "white")
        summary = s.spec.plan.node_str()
        lines.append(
            f'  stage_{sid} [label="stage {sid}\\n{_esc(summary)}\\n'
            f"{s.state.value} {len(s.completed)}/{s.spec.partitions} parts\", fillcolor={color}];"
        )
    for sid, outs in graph.output_links.items():
        for o in outs:
            lines.append(f"  stage_{sid} -> stage_{o};")
    lines.append("}")
    return "\n".join(lines)


def plan_to_dot(plan) -> str:
    """Operator-tree dot for one physical plan (diagram.rs analog)."""
    lines = ["digraph P {", "  node [shape=box];"]
    counter = [0]

    def walk(node) -> int:
        my = counter[0]
        counter[0] += 1
        lines.append(f'  n{my} [label="{_esc(node.node_str())}"];')
        for c in node.children():
            ci = walk(c)
            lines.append(f"  n{ci} -> n{my};")
        return my

    walk(plan)
    lines.append("}")
    return "\n".join(lines)
