"""Pass framework for the engine invariant analyzer.

The moving parts:

- `SourceFile` — one parsed python file (text, lines, lazily-built AST,
  suppression comments). Passes share these parses; nothing re-reads disk.
- `Finding` — one violation. Its `key()` deliberately excludes the line
  number so baseline entries survive unrelated edits to the same file.
- suppression comments — `# analysis: ignore[pass-id] reason` on (or one
  line above) the offending line; `# analysis: skip-file[pass-id]` in the
  file header. A reason string is REQUIRED: a suppression is a reviewed
  decision, not an escape hatch.
- baseline — a checked-in JSON file (`ballista_tpu_torch/analysis/baseline.json`) of
  grandfathered findings, each with a reason. New findings fail; baselined
  ones are reported separately; baseline entries that no longer match any
  finding are flagged as stale so the file can only shrink.
- `Analyzer` — collects the scan set (the `ballista_tpu_torch` package +
  `chip_smoke.py`, minus generated protos), runs the passes, applies
  suppressions and the baseline, and returns an `AnalysisReport`.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field

# -- findings ---------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One invariant violation.

    `symbol` is the stable discriminator inside a file (a knob name, a
    cache variable, a class.param) — `key()` is built from it instead of
    the line number so baselines don't churn on unrelated edits."""

    pass_id: str
    path: str  # repo-relative, '/'-separated
    line: int
    message: str
    symbol: str = ""

    def key(self) -> str:
        return f"{self.pass_id}:{self.path}:{self.symbol or self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_id}] {self.message}"


# -- suppression comments ---------------------------------------------------

_IGNORE_RE = re.compile(r"#\s*analysis:\s*ignore\[([a-z0-9_,\- *]+)\]\s*(.*)")
_SKIP_FILE_RE = re.compile(r"#\s*analysis:\s*skip-file\[([a-z0-9_,\- *]+)\]\s*(.*)")


@dataclass
class Suppression:
    pass_ids: set[str]  # {"*"} = every pass
    reason: str
    line: int

    def covers(self, pass_id: str) -> bool:
        return "*" in self.pass_ids or pass_id in self.pass_ids


def _parse_suppressions(lines: list[str]) -> tuple[list[Suppression], list[Suppression]]:
    """Returns (line-level, file-level) suppressions. A line-level ignore
    covers its own line and the line below (so it can sit above a long
    statement)."""
    per_line: list[Suppression] = []
    per_file: list[Suppression] = []
    for i, text in enumerate(lines, start=1):
        m = _IGNORE_RE.search(text)
        if m:
            ids = {p.strip() for p in m.group(1).split(",") if p.strip()}
            per_line.append(Suppression(ids, m.group(2).strip(), i))
        m = _SKIP_FILE_RE.search(text)
        if m and i <= 15:
            ids = {p.strip() for p in m.group(1).split(",") if p.strip()}
            per_file.append(Suppression(ids, m.group(2).strip(), i))
    return per_line, per_file


# -- source files -----------------------------------------------------------


class SourceFile:
    """One python file of the scan set: text + lazy AST + suppressions."""

    def __init__(self, rel: str, text: str, abspath: str = ""):
        self.rel = rel.replace(os.sep, "/")
        self.text = text
        self.abspath = abspath or rel
        self.lines = text.splitlines()
        self._tree: ast.Module | None = None
        self._parse_error: str | None = None
        self.line_suppressions, self.file_suppressions = _parse_suppressions(self.lines)

    @classmethod
    def from_path(cls, abspath: str, rel: str) -> "SourceFile":
        with open(abspath, encoding="utf-8") as f:
            return cls(rel, f.read(), abspath)

    @property
    def tree(self) -> ast.Module | None:
        if self._tree is None and self._parse_error is None:
            try:
                self._tree = ast.parse(self.text, filename=self.rel)
            except SyntaxError as e:  # surfaced as a finding by the analyzer
                self._parse_error = str(e)
        return self._tree

    @property
    def parse_error(self) -> str | None:
        _ = self.tree
        return self._parse_error

    @property
    def module_name(self) -> str | None:
        """Dotted module name for files under the package root, else None."""
        if not self.rel.endswith(".py"):
            return None
        parts = self.rel[: -len(".py")].split("/")
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if parts and parts[0] == "ballista_tpu_torch":
            return ".".join(parts)
        return None

    def suppressed(self, finding: Finding) -> Suppression | None:
        for s in self.file_suppressions:
            if s.covers(finding.pass_id):
                return s
        for s in self.line_suppressions:
            if s.covers(finding.pass_id) and s.line in (finding.line, finding.line - 1):
                return s
        return None

    # -- shared AST helpers (used by several passes) -----------------------

    def walk_with_parents(self):
        """Yields (node, parent) over the whole tree."""
        tree = self.tree
        if tree is None:
            return
        stack = [(tree, None)]
        while stack:
            node, parent = stack.pop()
            yield node, parent
            for child in ast.iter_child_nodes(node):
                stack.append((child, node))

    def string_literals(self):
        """Yields (value, lineno) for every string constant that is NOT a
        statement-level string (docstrings and bare-string comments carry
        prose, not live keys)."""
        for node, parent in self.walk_with_parents():
            if (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and not isinstance(parent, ast.Expr)
            ):
                yield node.value, node.lineno


# -- baseline ---------------------------------------------------------------


def load_baseline(path: str) -> dict[str, str]:
    """key -> reason. Missing file = empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        text = f.read()
    if not text.strip():  # e.g. --baseline '' routes here via /dev/null
        return {}
    data = json.loads(text)
    out: dict[str, str] = {}
    for entry in data.get("findings", []):
        out[entry["key"]] = entry.get("reason", "")
    return out


def save_baseline(path: str, findings: list[Finding], reasons: dict[str, str] | None = None) -> None:
    reasons = reasons or {}
    entries = [
        {"key": f.key(), "reason": reasons.get(f.key(), "grandfathered; fix or justify"),
         "message": f.message}
        for f in sorted(findings, key=lambda f: f.key())
    ]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"comment": "Grandfathered analyzer findings. Entries may only be "
                              "removed (by fixing the violation); additions need a "
                              "written reason. See docs/static_analysis.md.",
                   "findings": entries}, f, indent=2)
        f.write("\n")


# -- analyzer ---------------------------------------------------------------

DEFAULT_BASELINE_REL = os.path.join("ballista_tpu_torch", "analysis", "baseline.json")

_EXCLUDE_PARTS = ("_pb2",)  # generated protobuf modules


def repo_root() -> str:
    """The directory holding the ballista_tpu_torch package (and docs/)."""
    here = os.path.dirname(os.path.abspath(__file__))  # .../ballista_tpu_torch/analysis
    return os.path.dirname(os.path.dirname(here))


@dataclass
class AnalysisReport:
    findings: list[Finding] = field(default_factory=list)  # actionable (new)
    suppressed: list[tuple[Finding, Suppression]] = field(default_factory=list)
    baselined: list[tuple[Finding, str]] = field(default_factory=list)
    stale_baseline: list[str] = field(default_factory=list)  # keys with no match
    files_scanned: int = 0
    passes_run: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings and not self.stale_baseline

    def render(self) -> str:
        out = []
        for f in sorted(self.findings, key=lambda f: (f.path, f.line)):
            out.append(f.render())
        for key in self.stale_baseline:
            out.append(f"(baseline) stale entry no longer matches any finding: {key}")
        out.append(
            f"{len(self.findings)} finding(s), {len(self.baselined)} baselined, "
            f"{len(self.suppressed)} suppressed, {len(self.stale_baseline)} stale "
            f"baseline entr(ies) over {self.files_scanned} files "
            f"[{', '.join(self.passes_run)}]"
        )
        return "\n".join(out)

    def to_json(self) -> str:
        return json.dumps(
            {
                "ok": self.ok,
                "files_scanned": self.files_scanned,
                "passes": self.passes_run,
                "findings": [
                    {"pass": f.pass_id, "path": f.path, "line": f.line,
                     "message": f.message, "key": f.key()}
                    for f in self.findings
                ],
                "baselined": [
                    {"key": f.key(), "reason": r} for f, r in self.baselined
                ],
                "suppressed": [
                    {"key": f.key(), "reason": s.reason} for f, s in self.suppressed
                ],
                "stale_baseline": self.stale_baseline,
            },
            indent=2,
        )


class Analyzer:
    """Collect the scan set, run passes, apply suppressions + baseline."""

    def __init__(self, root: str | None = None, passes=None,
                 baseline_path: str | None = None,
                 files: list[SourceFile] | None = None):
        self.root = os.path.abspath(root or repo_root())
        if passes is None:
            from ballista_tpu_torch.analysis.passes import ALL_PASSES

            passes = ALL_PASSES
        self.passes = list(passes)
        self.baseline_path = baseline_path if baseline_path is not None else os.path.join(
            self.root, DEFAULT_BASELINE_REL
        )
        self._files = files

    # -- scan set ----------------------------------------------------------

    def collect(self) -> list[SourceFile]:
        if self._files is not None:
            return self._files
        out: list[SourceFile] = []
        roots = [("ballista_tpu_torch", True)]
        for top, recurse in roots:
            base = os.path.join(self.root, top)
            if not os.path.isdir(base):
                continue
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in sorted(filenames):
                    if not fn.endswith(".py"):
                        continue
                    if any(p in fn for p in _EXCLUDE_PARTS):
                        continue
                    ap = os.path.join(dirpath, fn)
                    out.append(SourceFile.from_path(ap, os.path.relpath(ap, self.root)))
                if not recurse:
                    break
        for single in ("chip_smoke.py",):
            ap = os.path.join(self.root, single)
            if os.path.exists(ap):
                out.append(SourceFile.from_path(ap, single))
        self._files = out
        return out

    def file(self, rel: str) -> SourceFile | None:
        rel = rel.replace(os.sep, "/")
        for f in self.collect():
            if f.rel == rel:
                return f
        return None

    # -- run ---------------------------------------------------------------

    def run(self, pass_ids: list[str] | None = None) -> AnalysisReport:
        files = self.collect()
        by_rel = {f.rel: f for f in files}
        report = AnalysisReport(files_scanned=len(files))
        raw: list[Finding] = []
        for f in files:
            if f.parse_error:
                raw.append(Finding("parse", f.rel, 1, f"syntax error: {f.parse_error}"))
        for p in self.passes:
            if pass_ids is not None and p.pass_id not in pass_ids:
                continue
            report.passes_run.append(p.pass_id)
            raw.extend(p.run(self))
        baseline = load_baseline(self.baseline_path)
        matched_keys: set[str] = set()
        for f in raw:
            src = by_rel.get(f.path)
            sup = src.suppressed(f) if src is not None else None
            if sup is not None:
                if sup.reason:
                    report.suppressed.append((f, sup))
                    continue
                # a reasonless suppression is not a reviewed decision: the
                # finding stays actionable, annotated so the author sees why
                f = Finding(f.pass_id, f.path, f.line,
                            f.message + " [matching suppression lacks a reason]",
                            f.symbol)
            if f.key() in baseline:
                matched_keys.add(f.key())
                report.baselined.append((f, baseline[f.key()]))
                continue
            report.findings.append(f)
        report.stale_baseline = sorted(set(baseline) - matched_keys)
        return report


class AnalysisPass:
    """Base class: subclasses set `pass_id`/`doc` and implement run()."""

    pass_id = "base"
    doc = ""

    def run(self, analyzer: Analyzer) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError
