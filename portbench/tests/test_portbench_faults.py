"""`correct` has to come out false: for the control (the reference in
float32 put in the program's place) and for a run whose timed path is
broken underneath, once for each fault the cells can have."""

import io
import json

import pyarrow as pa
import pytest

from portbench.harness import spec
from portbench.harness.control import readings
from portbench.harness.data import ensure
from portbench.harness.main import run


def _run(root, cell, seed=6):
    out = io.StringIO()
    rc = run(["--workload", cell, "--seed", str(seed), "--seconds", "1", "--trace", "0"],
             root=root, need_card=False, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


CELLS = ["tpch10_local_scanagg", "tpch10_local_mix6"]


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_refused(bench_root, seed, cell_name):
    cell = spec.load_cell(cell_name, bench_root)
    data_dir, _ = ensure(cell.config, f"{bench_root}/portbench")
    out = readings(cell, data_dir, seed, bench_root)
    assert out["correct"] is False
    gap = out["checks"]["float_gap"]
    assert gap["value"] > gap["limit"] or out["checks"]["exact_mismatch"]["value"] > 0


def _altered(table: pa.Table) -> pa.Table:
    """The first float cell of the answer, moved in its last digits."""
    for i, f in enumerate(table.schema):
        if pa.types.is_floating(f.type) and table.num_rows:
            col = table.column(i).combine_chunks()
            vals = col.to_numpy(zero_copy_only=False).copy()
            vals[0] = vals[0] * (1 + 1e-7)
            return table.set_column(i, f, pa.array(vals, f.type))
    return table


def _drop_half_of_every_table(monkeypatch):
    from ballista_tpu_torch.plan import provider

    init = provider.ParquetTable.__init__

    def half(self, *a, **k):
        init(self, *a, **k)
        if len(self.files) > 1:
            self.files = self.files[::2]
    monkeypatch.setattr(provider.ParquetTable, "__init__", half)


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced(bench_root, cpu_port, monkeypatch, cell):
    from ballista_tpu_torch.client import context

    orig = context.SessionContext.execute_collect
    monkeypatch.setattr(context.SessionContext, "execute_collect",
                        lambda self, p: _altered(orig(self, p)))
    res = _run(bench_root, cell)
    assert res["correct"] is False
    assert res["checks"]["float_gap"]["value"] > res["checks"]["float_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_the_rows_left_out(bench_root, cpu_port, monkeypatch, cell):
    _drop_half_of_every_table(monkeypatch)
    res = _run(bench_root, cell)
    assert res["correct"] is False and res["checks"]["exact_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_a_statement_that_fails(bench_root, cpu_port, monkeypatch, cell):
    from ballista_tpu_torch.client import context

    orig = context.SessionContext.execute_collect
    calls = {"n": 0}

    def sometimes(self, p):
        calls["n"] += 1
        if calls["n"] % 7 == 0:
            raise RuntimeError("injected")
        return orig(self, p)
    monkeypatch.setattr(context.SessionContext, "execute_collect", sometimes)
    res = _run(bench_root, cell)
    assert res["correct"] is False and res["failed"] > 0
    assert res["checks"]["unanswered"]["value"] >= res["failed"]  # the warm-up's too
