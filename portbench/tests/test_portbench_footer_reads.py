"""The reader of the port's footer_reads counter (`metrics/
footer_reads_per_query.py`): footers parsed since the spans turned on, per
statement recorded since then; nothing where the port has no spans or no
such counter (a port from before the planner kept row-group sizes by
file stamp)."""

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from portbench.harness import spans, spec
from portbench.harness.reading import Query, Traced

VIEW = Traced(start=0.0, stop=1.0, queries=[Query(0, "q1", 0, 0, 0)] * 2, events=None)
TWO = [(1, 1, 0, "collect", 1, 0, 1), (2, 2, 0, "collect", 1, 2, 3), (2, 3, 2, "plan.physical", 1, 2, 3)]


def _read():
    return spec.metric_reader("footer_reads_per_query").read(VIEW)


@pytest.mark.parametrize("reads,want", [(0, 0.0), (64, 32.0)])
def test_reads_per_statement(monkeypatch, reads, want):
    counters = {"host_syncs": 0, "footer_reads": reads, "spans_dropped": 0}
    monkeypatch.setattr(spans, "port_spans", lambda: (TWO, counters))
    assert _read() == pytest.approx(want)


def test_nothing_without_the_counter_or_the_spans(monkeypatch):
    monkeypatch.setattr(spans, "port_spans", lambda: (TWO, {"host_syncs": 3, "spans_dropped": 0}))
    assert _read() is None
    monkeypatch.setattr(spans, "port_spans", lambda: None)
    assert _read() is None


def test_counts_the_ports_footer_reads_since_the_spans_turned_on(monkeypatch, tmp_path):
    from ballista_tpu_torch.plan.provider import ParquetTable
    from ballista_tpu_torch.utils.run_stats import RUN_STATS

    path = tmp_path / "t.parquet"
    pq.write_table(pa.table({"k": list(range(100))}), path, row_group_size=10)
    table = ParquetTable(str(path))  # registration reads its footer, before the window
    monkeypatch.setattr(RUN_STATS, "spans", lambda: TWO)
    RUN_STATS.trace(True)
    try:
        table.scan_partitions(4)
        assert _read() == 0.0
        ParquetTable(str(path)).scan_partitions(4)
        assert _read() == pytest.approx(0.5)
    finally:
        RUN_STATS.trace(False)
