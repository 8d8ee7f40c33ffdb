"""The port's SQL CLI (`python -m ballista_tpu_torch.cli`) against the JAX
package's, on the CPU.

- `Repl.run_command` over the port's default session (the standalone
  mode, engine=tpu: device stages in their plain CPU forms) prints the
  same text as the JAX package's `Repl` over its default session (the
  standalone mode, engine=cpu) for the dot-commands, `CREATE EXTERNAL
  TABLE`, `SET` and TPC-H q1, q3, q4, q5, q6 and q12 at SF0.01, and every
  answer matches the port's pandas oracle (`testing/reference.py`);
- `EXPLAIN ANALYZE` shows every device node run with no CPU fallback;
- the remote mode answers the same through `main(["--host", ...])`;
- as a process: with BALLISTA_TORCH_PLATFORM=cpu it answers; without it
  and without a card it prints the device error and no answer;
- the port's oracle equals the JAX package's on all 22 queries.
"""

import contextlib
import io
import os
import re
import subprocess
import sys

import pytest

from ballista_tpu_torch.ops.cuda import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = (1, 3, 4, 5, 6, 12)
TABLES = ("region", "nation", "supplier", "part", "partsupp", "customer", "orders",
          "lineitem")
ELAPSED = re.compile(r"^Elapsed \d+\.\d{3} seconds\.$")


def _sql(q: int) -> str:
    with open(os.path.join(ROOT, "benchmarks", "tpch", "queries", f"q{q}.sql")) as f:
        return f.read()


def _create(name: str, tpch_dir: str) -> str:
    return (f"CREATE EXTERNAL TABLE {name} STORED AS PARQUET "
            f"LOCATION '{os.path.join(tpch_dir, name)}';")


@pytest.fixture(scope="module", autouse=True)
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


@pytest.fixture(scope="module")
def repls():
    """Each package's Repl over the session its CLI builds by default."""
    from ballista_tpu.cli.main import Repl as RefRepl
    from ballista_tpu.client.context import SessionContext as RefContext
    from ballista_tpu.config import BallistaConfig as RefConfig

    from ballista_tpu_torch.cli.main import Repl
    from ballista_tpu_torch.client.context import SessionContext
    from ballista_tpu_torch.config import BallistaConfig

    port = SessionContext.standalone(BallistaConfig({"ballista.executor.engine": "tpu"}),
                                     num_executors=1, vcores=4)
    ref = RefContext.standalone(RefConfig({"ballista.executor.engine": "cpu"}),
                                num_executors=1, vcores=4)
    try:
        yield {"port": Repl(port), "jax": RefRepl(ref)}
    finally:
        port.shutdown()
        ref.shutdown()


def _run(repl, line: str) -> tuple[str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert repl.run_command(line) is True
    return out.getvalue(), err.getvalue()


def _both(repls, line: str) -> str:
    port_out, port_err = _run(repls["port"], line)
    ref_out, ref_err = _run(repls["jax"], line)
    assert port_err == ref_err == "", port_err[-2000:] + ref_err[-2000:]
    assert port_out == ref_out, f"{line}\n--- port\n{port_out}\n--- jax\n{ref_out}"
    return port_out


@pytest.fixture(scope="module")
def session(repls, tpch_dir):
    """The CLI statements that set both sessions up, each printed alike:
    timing off (the printed seconds differ), every table created, the final
    stage kept on the device (a few partial rows, under the row gate)."""
    lines = [".timing off"] + [_create(t, tpch_dir) for t in TABLES] + [
        "SET ballista.tpu.min.rows = 0;"]
    return {pkg: [_run(repl, line) for line in lines] for pkg, repl in repls.items()}


def test_setup_statements_print_alike(session):
    port, ref = session["port"], session["jax"]
    assert port == ref
    assert port[0] == ("timing off\n", "")
    assert port[1][0].splitlines()[1].strip() == "created table region"


def test_dot_commands_print_alike(repls, session):
    tables = _both(repls, ".tables")
    assert sorted(tables.split()) == sorted(TABLES)
    schema = _both(repls, ".schema lineitem")
    assert "  l_orderkey: int64" in schema.splitlines()
    assert _both(repls, ".schema nope") == "table not found: nope\n"
    assert _both(repls, ".timing on") == "timing on\n"
    assert _both(repls, ".timing off") == "timing off\n"
    assert repls["port"].run_command(".quit") is False


def test_set_prints_alike(repls, session):
    out = _both(repls, "SET ballista.tpu.min.rows = 0;")
    assert out.strip()


@pytest.fixture(scope="module")
def oracle_tables(tpch_dir):
    from ballista_tpu_torch.testing.reference import load_tables

    return load_tables(tpch_dir)


@pytest.mark.parametrize("q", QUERIES)
def test_query_prints_alike_and_matches_the_oracle(q, repls, session, oracle_tables,
                                                   monkeypatch):
    from ballista_tpu_torch.cli import main as cli_main
    from ballista_tpu_torch.testing.reference import compare_results, run_reference

    tables = []
    fmt = cli_main.format_table

    def keep(tbl, *a, **k):
        tables.append(tbl)
        return fmt(tbl, *a, **k)

    monkeypatch.setattr(cli_main, "format_table", keep)
    out = _both(repls, _sql(q))
    assert out.splitlines()[-1].endswith(" rows)")
    assert len(tables) == 1
    assert compare_results(tables[0], run_reference(q, oracle_tables), q) == []


def test_explain_analyze_runs_every_device_node(repls, session):
    out, err = _run(repls["port"], "EXPLAIN ANALYZE " + _sql(4))
    assert err == ""
    nodes = re.findall(r"(Tpu\w+Exec): .*? device_runs=(\d+) cpu_fallbacks=(\d+)", out)
    assert {n for n, _r, _f in nodes} == {"TpuStageExec", "TpuFinalStageExec"}
    assert all(int(r) >= 1 and int(f) == 0 for _n, r, f in nodes), nodes


def test_error_is_printed_and_the_repl_goes_on(repls, session):
    out, err = _run(repls["port"], "SELECT nope FROM lineitem;")
    assert out == "" and err.startswith("Error: ")
    out, err = _run(repls["port"], "SELECT count(*) AS n FROM region;")
    assert err == "" and out.split() == ["n", "5", "(1", "rows)"]


def test_remote_mode_through_main(tpch_dir, tmp_path, capsys):
    # `--host/--port` against the port's scheduler and one executor on the
    # device engine: the same text as the standalone session's
    from ballista_tpu_torch.cli.main import main
    from ballista_tpu_torch.executor.executor_process import ExecutorProcess
    from ballista_tpu_torch.scheduler.process import SchedulerProcess

    script = tmp_path / "q.sql"
    script.write_text("\n".join([_create(t, tpch_dir) for t in ("lineitem", "orders")]
                                + ["SET ballista.tpu.min.rows = 0;", _sql(4)]))
    sched = SchedulerProcess(bind_host="127.0.0.1", port=0, rest_port=-1,
                             flight_proxy_port=-1)
    sched.start()
    ex = ExecutorProcess(f"127.0.0.1:{sched.port}", bind_host="127.0.0.1",
                         external_host="127.0.0.1", engine="tpu", device_ordinal=0,
                         flight_impl="python")
    ex.start()
    try:
        capsys.readouterr()
        main(["--host", "127.0.0.1", "--port", str(sched.port), "-f", str(script)])
        out, err = capsys.readouterr()
    finally:
        ex.shutdown()
        sched.shutdown()
    assert "Error" not in err, err[-3000:]
    blocks = [b for b in out.split("Elapsed") if "o_orderpriority" in b]
    assert len(blocks) == 1
    rows = [ln.split() for ln in blocks[0].splitlines() if ln.strip().startswith("1-URGENT")]
    assert len(rows) == 1 and int(rows[0][1]) > 0


def _cli_process(args, tpch_dir, env_extra, tmp_path):
    script = tmp_path / "q6.sql"
    script.write_text(_create("lineitem", tpch_dir) + "\n" + _sql(6))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", runtime.PLATFORM_ENV)}
    env.update(env_extra)
    return subprocess.run([sys.executable, "-m", "ballista_tpu_torch.cli", *args,
                           "-f", str(script)], capture_output=True, text=True,
                          timeout=180, env=env, cwd=ROOT)


def test_cli_process_on_the_cpu_forms(tpch_dir, tmp_path, repls, session):
    out = _cli_process([], tpch_dir, {runtime.PLATFORM_ENV: "cpu"}, tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Error" not in out.stderr, out.stderr[-3000:]
    answer = [ln for ln in out.stdout.splitlines() if not ELAPSED.match(ln)]
    in_process = _both(repls, _sql(6)).splitlines()
    assert answer[-len(in_process):] == in_process
    assert "revenue" in in_process[0]


def test_cli_process_without_a_card_prints_the_device_error(tpch_dir, tmp_path):
    # no card visible and no request for the CPU: the device stage raises,
    # the REPL prints it and no answer
    out = _cli_process(["--engine", "tpu"], tpch_dir, {"CUDA_VISIBLE_DEVICES": ""}, tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    errors = [ln for ln in out.stderr.splitlines() if ln.startswith("Error: ")]
    assert len(errors) == 1 and "no CUDA device is available" in errors[0], out.stderr[-3000:]
    assert runtime.PLATFORM_ENV in errors[0]
    assert "revenue" not in out.stdout
    assert "created table lineitem" in out.stdout


# -- the oracle ------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_oracle_tables(tpch_dir):
    from ballista_tpu.testing.reference import load_tables

    return load_tables(tpch_dir)


@pytest.mark.parametrize("q", range(1, 23))
def test_oracle_matches_the_jax_package(q, oracle_tables, ref_oracle_tables):
    import pandas as pd

    from ballista_tpu.testing.reference import run_reference as ref_run
    from ballista_tpu_torch.testing.reference import run_reference

    got = run_reference(q, oracle_tables)
    want = ref_run(q, ref_oracle_tables)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
