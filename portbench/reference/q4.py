"""TPC-H q4, the order priority checking report: orders of one quarter
with at least one line received after its commit date, by priority."""

import numpy as np

from portbench.reference.common import date, group_sums

COLUMNS = {"orders": ["o_orderkey", "o_orderdate", "o_orderpriority"],
           "lineitem": ["l_orderkey", "l_commitdate", "l_receiptdate"]}


def answer(db, p):
    ok = db.col("orders", "o_orderkey")
    if "q4" not in db.memo:  # which orders have a line received after its commit date
        late = db.col("lineitem", "l_commitdate") < db.col("lineitem", "l_receiptdate")
        has = np.zeros(int(max(ok.max(), db.col("lineitem", "l_orderkey").max())) + 1, dtype=bool)
        has[db.col("lineitem", "l_orderkey")[late]] = True
        db.memo["q4"] = has
    has = db.memo["q4"]
    od = db.col("orders", "o_orderdate")
    m = (od >= date(p["DATE"])) & (od < date(p["DATE_END"])) & has[ok]
    prio = db.col("orders", "o_orderpriority")
    names = sorted(prio.values)
    rank = np.array([names.index(v) for v in prio.values], dtype=np.int64)
    gid = np.where(m, rank[prio.codes], -1)
    (n,) = group_sums(gid, len(names), np.ones(len(gid), dtype=np.int64))
    keep = np.flatnonzero(n > 0)
    return {"o_orderpriority": [names[g] for g in keep], "order_count": n[keep]}
