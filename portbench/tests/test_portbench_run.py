"""Whole runs of a cell on the CPU at SF0.01 (the port's CPU forms, the
harness's look for a card skipped), and the refusals."""

import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness import program, spec
from portbench.harness.data import data_dir
from portbench.harness.main import run

from .conftest import make_root

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, *args):
    out = io.StringIO()
    rc = run(list(args), root=root, need_card=False, out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.mark.parametrize("cell", ["tpch10_local_scanagg", "tpch10_local_mix6"])
def test_last_line_holds_the_end_to_end_metrics_and_the_checks(bench_root, cpu_port, cell):
    rc, res = _run(bench_root, "--workload", cell, "--seed", str(2**31 + 99), "--seconds", "2",
                   "--trace", "0")
    assert rc == 0
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    names = {m.name for m in spec.load_cell(cell, bench_root).end_to_end}
    assert set(res["metrics"]) == names == {"queries_per_s", "latency_p50_s", "setup_s"}
    assert res["metrics"]["queries_per_s"]["value"] > 0
    assert res["metrics"]["latency_p50_s"]["value"] > 0
    assert set(res["checks"]) == {"unanswered", "exact_mismatch", "float_gap"}
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_traced_run_prints_no_device_metric_without_a_card(bench_root, cpu_port):
    rc, res = _run(bench_root, "--workload", "tpch10_local_scanagg", "--seed", "5",
                   "--seconds", "2", "--trace", "1")
    assert rc == 0 and res["correct"] is True
    # what the benchmark's own spans and the port's counters give is there ...
    assert {"latency_p95_s.closed_loop", "sql_plan_ms", "table_fills_per_query"} <= set(res["metrics"])
    # ... and nothing read from a device trace, which a CPU run has not
    device_metrics = {m.name for m in spec.load_cell("tpch10_local_scanagg", bench_root).per_layer
                      if m.source == "device_trace"}
    assert device_metrics and not device_metrics & set(res["metrics"])
    assert "busy_s" not in res["device"] and "breakdown" not in res


def test_no_result_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    cmd = [sys.executable, "portbench/run.py", "--workload", "tpch10_local_scanagg", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "torch.cuda.is_available() is false" in out.stderr
    # a directory with the benchmark alone: no port, no result
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("data", "__pycache__"))
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_forbidden_modules_compares_whole_top_level_names():
    loaded = ["ballista_tpu_torch", "ballista_tpu_torch.ops", "jaxtyping", "numpy",
              "ballista_tpu.ops.tpu", "jax.numpy", "jaxlib", "flax.linen"]
    assert program.forbidden_modules(loaded) == ["ballista_tpu.ops.tpu", "flax.linen",
                                                 "jax.numpy", "jaxlib"]


def test_a_run_loads_nothing_of_jax_or_the_jax_package(bench_root):
    code = (
        "import io, sys; sys.path.insert(0, %r)\n"
        "from ballista_tpu_torch.ops.cuda import runtime; runtime.use_cpu()\n"
        "from portbench.harness.main import run\n"
        "from portbench.harness.program import forbidden_modules\n"
        "rc = run(['--workload', 'tpch10_local_mix6', '--seed', '8', '--seconds', '1',"
        " '--trace', '1'], root=%r, need_card=False, out=io.StringIO())\n"
        "print(rc, forbidden_modules())\n"
    ) % (spec.ROOT, bench_root)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "0 []"


def test_a_configuration_and_a_mix_added_as_files_alone(tmp_path, cpu_port):
    root = make_root(str(tmp_path))
    cfg_dir = os.path.join(root, "portbench", "configs")
    with open(os.path.join(cfg_dir, "tpch_sf10_local.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tpch_tiny_two_files", files_per_table=2)
    with open(os.path.join(cfg_dir, "tpch_tiny_two_files.json"), "w") as f:
        json.dump(cfg, f)
    mix = {"name": "two_reports", "loop": "closed", "streams": 2, "think_s": 0,
           "queries": ["q6", "q12"], "why": "two reports in two streams"}
    with open(os.path.join(root, "portbench", "traffic", "two_reports.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tpch_tiny_two_files", "source": "a test",
                             "file": "portbench/configs/tpch_tiny_two_files.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_two", "config": "tpch_tiny_two_files",
                               "traffic": "two_reports", "chips": 1, "why": "a test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    rc, res = _run(root, "--workload", "tiny_two", "--seed", "4", "--seconds", "1", "--trace", "0")
    assert rc == 0 and res["correct"] is True
    assert res["run"]["statements"] == 4 and res["metrics"]["latency_p50_s"]["value"] > 0
    # the added configuration's own tables (2 files a table), apart from the others'
    assert os.listdir(os.path.join(root, "portbench", "data")) == [
        os.path.basename(data_dir(cfg, os.path.join(root, "portbench")))]
    assert data_dir(cfg) != data_dir(spec.load_cell("tpch10_local_scanagg").config)
