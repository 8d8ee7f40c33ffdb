"""event-loop hygiene: no blocking calls in scheduler event-loop handlers.

Every graph mutation funnels through a scheduler shard's event loop →
`SchedulerServer._handle`; one blocking call there stalls task placement,
heartbeat application, and AQE resolution for every job the shard owns
(the admission controller even sheds on loop lag — a blocked loop
triggers exactly the overload it's meant to prevent). Planning already
runs on a spawned thread for this reason.

The pass roots its search at BOTH handler entry points — the per-shard
`SchedulerShard._handle` (ballista_tpu_torch/scheduler/shard.py) and
`SchedulerServer._handle` — building the call graph over `self.method()`
edges plus the shard's `self.server.method()` cross-class edges (nested
function defs are excluded — they are thread targets, not loop code),
and flags the blocking primitives: `time.sleep`, subprocess spawns, raw
socket dials, `urlopen`, `Event.wait`, `Thread.join` without a timeout,
and `Future.result()` without a timeout.
"""

from __future__ import annotations

import ast

from ballista_tpu_torch.analysis.core import AnalysisPass, Analyzer, Finding

SERVER_REL = "ballista_tpu_torch/scheduler/server.py"
SHARD_REL = "ballista_tpu_torch/scheduler/shard.py"
ROOT_METHODS = ("_handle",)

_BLOCKING_MODULE_CALLS = {
    ("time", "sleep"),
    ("subprocess", "run"),
    ("subprocess", "check_call"),
    ("subprocess", "check_output"),
    ("subprocess", "Popen"),
    ("socket", "create_connection"),
}
_TIMEOUT_REQUIRED_METHODS = {"result", "join", "wait"}


def _has_timeout(call: ast.Call) -> bool:
    if any(k.arg == "timeout" for k in call.keywords):
        return True
    return bool(call.args)  # positional timeout (Event.wait(5), join(5))


def _method_defs(cls: ast.ClassDef) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)}


def _own_statements(fn: ast.FunctionDef):
    """Walk fn's body, NOT descending into nested function defs (those run
    on other threads)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        for child in ast.iter_child_nodes(node):
            stack.append(child)


def _self_calls(fn: ast.FunctionDef) -> set[str]:
    out: set[str] = set()
    for node in _own_statements(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "self":
            out.add(node.func.attr)
    return out


def _server_calls(fn: ast.FunctionDef) -> set[str]:
    """Cross-class edges: `self.server.method()` calls from a shard method
    into SchedulerServer (the shard loop forwards its events there)."""
    out: set[str] = set()
    for node in _own_statements(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Attribute) \
                and isinstance(node.func.value.value, ast.Name) \
                and node.func.value.value.id == "self" \
                and node.func.value.attr == "server":
            out.add(node.func.attr)
    return out


def _class_def(src, name: str) -> ast.ClassDef | None:
    if src is None or src.tree is None:
        return None
    return next((n for n in src.tree.body
                 if isinstance(n, ast.ClassDef) and n.name == name), None)


def _reachable(methods: dict[str, ast.FunctionDef], roots) -> set[str]:
    seen: set[str] = set()
    stack = [m for m in roots if m in methods]
    while stack:
        name = stack.pop()
        if name in seen:
            continue
        seen.add(name)
        for callee in _self_calls(methods[name]):
            if callee in methods and callee not in seen:
                stack.append(callee)
    return seen


class EventLoopHygienePass(AnalysisPass):
    pass_id = "event-loop"
    doc = "no blocking sleeps/IO reachable from any scheduler shard's event-loop handlers"

    def run(self, analyzer: Analyzer) -> list[Finding]:
        findings: list[Finding] = []
        server_src = analyzer.file(SERVER_REL)
        server_cls = _class_def(server_src, "SchedulerServer")
        if server_cls is None:
            return findings
        server_methods = _method_defs(server_cls)

        # roots: SchedulerServer._handle, plus every SchedulerServer method
        # a shard's event loop reaches through self.server.X() edges
        server_roots = set(ROOT_METHODS)
        shard_src = analyzer.file(SHARD_REL)
        shard_cls = _class_def(shard_src, "SchedulerShard")
        if shard_cls is not None:
            shard_methods = _method_defs(shard_cls)
            shard_reachable = _reachable(shard_methods, ROOT_METHODS)
            for name in sorted(shard_reachable):
                server_roots |= _server_calls(shard_methods[name])
            self._flag(findings, shard_src, shard_methods, shard_reachable,
                       "SchedulerShard")

        server_reachable = _reachable(server_methods, server_roots)
        self._flag(findings, server_src, server_methods, server_reachable,
                   "SchedulerServer")
        return findings

    def _flag(self, findings: list[Finding], src, methods, reachable,
              cls_name: str) -> None:
        for name in sorted(reachable):
            for node in _own_statements(methods[name]):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
                    pair = (f.value.id, f.attr)
                    if pair in _BLOCKING_MODULE_CALLS:
                        findings.append(Finding(
                            self.pass_id, src.rel, node.lineno,
                            f"blocking call {pair[0]}.{pair[1]}() inside event-loop "
                            f"handler {cls_name}.{name}; post work to a thread "
                            f"or use the sweep timer",
                            symbol=f"{name}:{pair[0]}.{pair[1]}",
                        ))
                        continue
                if isinstance(f, ast.Name) and f.id == "urlopen":
                    findings.append(Finding(
                        self.pass_id, src.rel, node.lineno,
                        f"blocking urlopen() inside event-loop handler "
                        f"{cls_name}.{name}",
                        symbol=f"{name}:urlopen",
                    ))
                    continue
                if isinstance(f, ast.Attribute) and \
                        f.attr in _TIMEOUT_REQUIRED_METHODS and not _has_timeout(node):
                    findings.append(Finding(
                        self.pass_id, src.rel, node.lineno,
                        f".{f.attr}() without a timeout inside event-loop handler "
                        f"{cls_name}.{name}; an unbounded wait wedges the "
                        f"whole shard",
                        symbol=f"{name}:{f.attr}",
                    ))
