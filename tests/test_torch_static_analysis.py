"""The port's engine invariant analyzer (`ballista_tpu_torch.analysis`).

- the port is clean: 0 actionable findings and 0 stale baseline entries
  over the port's package and chip_smoke.py, every baseline entry with a
  written reason, and the baseline holding exactly the grandfathered
  findings its reasons name;
- the mechanics (suppression comments, the baseline) behave as the JAX
  package's analyzer: the same synthetic source through both analyzers
  gives the same findings, keys equal once the import root is renamed;
- torch-guard flags a module-level torch or triton import reachable from
  a CPU entry point, and nothing lazy or under TYPE_CHECKING;
- importing each CPU entry point of the port leaves torch unloaded (the
  scheduler once pulled in the whole CUDA engine through the serving
  tier's LruDict import, ROADMAP C24).
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from ballista_tpu_torch.analysis import Analyzer, SourceFile, load_baseline
from ballista_tpu_torch.analysis.core import DEFAULT_BASELINE_REL, repo_root
from ballista_tpu_torch.analysis.passes.torch_guard import ENTRY_POINTS, TorchGuardPass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the grandfathered findings: XLA cache knobs the port has no counterpart of
BASELINE_KEYS = {
    "knob-sync:ballista_tpu_torch/config.py:unused:BALLISTA_TPU_COMPILE_CACHE_ENTRIES",
    "knob-sync:ballista_tpu_torch/config.py:unused:BALLISTA_TPU_FINAL_CACHE_ENTRIES",
}


# -- the port-wide gate --------------------------------------------------------


def test_port_is_clean():
    report = Analyzer().run()
    assert report.files_scanned > 100, "scan set collapsed: collect() is broken"
    assert report.ok, "\n" + report.render()
    assert not report.findings and not report.stale_baseline
    assert {f.key() for f, _ in report.baselined} == BASELINE_KEYS
    rels = {f.path for f, _ in report.baselined} | {f.path for f, _ in report.suppressed}
    assert all(r.startswith("ballista_tpu_torch/") for r in rels), rels


def test_scan_set_is_the_port_and_chip_smoke():
    files = [f.rel for f in Analyzer().collect()]
    assert "chip_smoke.py" in files
    assert not any(r.startswith(("ballista_tpu/", "dev/")) or r == "bench.py" for r in files)
    assert not any("_pb2" in r for r in files)
    assert {r.split("/")[0] for r in files} == {"ballista_tpu_torch", "chip_smoke.py"}
    assert repo_root() == ROOT


def test_baseline_entries_are_justified():
    baseline = load_baseline(os.path.join(repo_root(), DEFAULT_BASELINE_REL))
    assert set(baseline) == BASELINE_KEYS
    for key, reason in baseline.items():
        assert reason.strip(), f"baseline entry {key!r} has no reason"
        assert reason != "grandfathered; fix or justify", key


def test_cli_json_smoke(capsys):
    from ballista_tpu_torch.analysis.__main__ import main

    assert main(["--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] and out["findings"] == [] and out["stale_baseline"] == []
    assert len(out["baselined"]) == len(BASELINE_KEYS)


def test_cli_as_a_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "ballista_tpu_torch.analysis"],
                         capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith("0 finding(s), 2 baselined")


def test_config_docs_are_generated():
    from ballista_tpu_torch.analysis.gen_configs import main

    assert main(["--check"]) == 0


# -- the mechanics, through both analyzers -------------------------------------

ROOTS = {"jax": "ballista_tpu", "port": "ballista_tpu_torch"}


def _analyzer(pkg, files, baseline="/dev/null", passes=None):
    if pkg == "jax":
        from ballista_tpu.analysis import Analyzer as A
        from ballista_tpu.analysis import SourceFile as S
        from ballista_tpu.analysis.passes.bounded_cache import BoundedCachePass as P
    else:
        A, S = Analyzer, SourceFile
        from ballista_tpu_torch.analysis.passes.bounded_cache import BoundedCachePass as P
    srcs = [S(f"{ROOTS[pkg]}/{rel}", text) for rel, text in files]
    return A(passes=[P()] if passes is None else passes, baseline_path=baseline,
             files=srcs), P


def _renamed(key: str) -> str:
    return key.replace("ballista_tpu/", "ballista_tpu_torch/").replace(
        "ballista_tpu.", "ballista_tpu_torch.")


MECHANICS = {
    "unsuppressed": ("_CACHE = {}\n", 1, 0),
    "line_suppression": ("# analysis: ignore[bounded-cache] bounded by protocol\n_CACHE = {}\n",
                         0, 1),
    "reasonless_suppression": ("# analysis: ignore[bounded-cache]\n_CACHE = {}\n", 1, 0),
    "skip_file": ("# analysis: skip-file[bounded-cache] generated registry module\n"
                  "_A = {}\n_B = []\n", 0, 2),
    "star": ("_CACHE = {}  # analysis: ignore[*] scratch module\n", 0, 1),
    "lookup_table": ("_TABLE = {'a': 1}\n__all__ = []\n", 0, 0),
}


@pytest.mark.parametrize("case", sorted(MECHANICS))
def test_mechanics_match_the_jax_package(case):
    text, n_findings, n_suppressed = MECHANICS[case]
    reports = {pkg: _analyzer(pkg, [("x.py", text)])[0].run() for pkg in ROOTS}
    port, ref = reports["port"], reports["jax"]
    assert len(port.findings) == n_findings
    assert len(port.suppressed) == n_suppressed
    assert [_renamed(f.key()) for f in ref.findings] == [f.key() for f in port.findings]
    assert [(f.line, f.message.replace("ballista_tpu.", "ballista_tpu_torch."))
            for f in ref.findings] == [(f.line, f.message) for f in port.findings]
    assert [(_renamed(f.key()), s.reason) for f, s in ref.suppressed] == \
        [(f.key(), s.reason) for f, s in port.suppressed]
    if case == "reasonless_suppression":
        assert "lacks a reason" in port.findings[0].message
    if case == "line_suppression":
        assert port.suppressed[0][1].reason == "bounded by protocol"


@pytest.mark.parametrize("pkg", sorted(ROOTS))
def test_baseline_grandfathers_and_goes_stale(pkg, tmp_path):
    analyzer, P = _analyzer(pkg, [("x.py", "_CACHE = {}\n")], passes=[])
    finding = P().run(analyzer)[0]
    assert finding.key() == f"bounded-cache:{ROOTS[pkg]}/x.py:_CACHE"
    gone = f"bounded-cache:{ROOTS[pkg]}/gone.py:_OLD"
    baseline = tmp_path / "b.json"
    baseline.write_text(json.dumps({"findings": [
        {"key": finding.key(), "reason": "pre-existing; tracked"},
        {"key": gone, "reason": "x"},
    ]}))
    report, _ = _analyzer(pkg, [("x.py", "_CACHE = {}\n")], baseline=str(baseline))
    report = report.run()
    assert not report.findings
    assert [f.key() for f, _ in report.baselined] == [finding.key()]
    assert report.stale_baseline == [gone]
    assert not report.ok


# -- torch-guard ---------------------------------------------------------------


def _guard(files):
    srcs = [SourceFile(f"ballista_tpu_torch/{rel}", text) for rel, text in files]
    return Analyzer(passes=[TorchGuardPass()], baseline_path="/dev/null", files=srcs).run()


ENTRY = ("cli/main.py", "from ballista_tpu_torch.ops.cuda import engine_bits\n")


@pytest.mark.parametrize("line", ["import torch\n", "import triton.language as tl\n",
                                  "from torch import nn\n",
                                  "try:\n    import torch\nexcept ImportError:\n    torch = None\n"])
def test_torch_guard_flags_a_module_level_import(line):
    report = _guard([ENTRY, ("ops/cuda/__init__.py", ""),
                     ("ops/cuda/engine_bits.py", line)])
    # `import triton.language` imports its package too: one finding each
    assert {(f.pass_id, f.path) for f in report.findings} == \
        {("torch-guard", "ballista_tpu_torch/ops/cuda/engine_bits.py")}
    assert "ballista_tpu_torch.cli.main" in report.findings[0].message


@pytest.mark.parametrize("text", [
    "def f():\n    import torch\n    return torch\n",
    "from typing import TYPE_CHECKING\nif TYPE_CHECKING:\n    import torch\n",
    "import typing\nif typing.TYPE_CHECKING:\n    import triton\n",
])
def test_torch_guard_passes_lazy_and_type_checking_imports(text):
    report = _guard([ENTRY, ("ops/cuda/__init__.py", ""), ("ops/cuda/engine_bits.py", text)])
    assert not report.findings


def test_torch_guard_ignores_modules_no_entry_point_reaches():
    report = _guard([("cli/main.py", "import os\n"), ("ops/cuda/kernels.py", "import torch\n")])
    assert not report.findings


def test_torch_guard_entry_points_exist():
    # a renamed entry point would make the guard silently check nothing
    assert len(ENTRY_POINTS) == 10
    for mod in ENTRY_POINTS:
        assert importlib.util.find_spec(mod) is not None, mod


# -- the CPU entry points load no torch (C24) ----------------------------------


def _importable(mod: str) -> list[str]:
    """The modules to import for `mod`: itself, or for a __main__ module
    (which runs a daemon when imported) the modules its own module-level
    imports name, read from its source."""
    if not mod.endswith(".__main__"):
        return [mod]
    spec = importlib.util.find_spec(mod)
    tree = ast.parse(open(spec.origin).read(), spec.origin)
    out = []
    for stmt in tree.body:
        if isinstance(stmt, ast.ImportFrom) and stmt.level == 0:
            out.append(stmt.module)
        elif isinstance(stmt, ast.Import):
            out.extend(a.name for a in stmt.names)
    assert out, mod
    return out


def test_cpu_entry_points_load_no_torch():
    plan = [(mod, _importable(mod)) for mod in ENTRY_POINTS]
    code = f"""
import importlib, sys
sys.path.insert(0, {ROOT!r})
for entry, mods in {plan!r}:
    for m in mods:
        importlib.import_module(m)
    loaded = sorted(k for k in ("torch", "triton") if k in sys.modules)
    print("ENTRY", entry, loaded)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=180, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("ENTRY")]
    assert lines == [f"ENTRY {mod} []" for mod in ENTRY_POINTS], out.stdout[-3000:]
