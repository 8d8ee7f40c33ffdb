"""TPC-H q12, the shipping modes and order priority report: late lines
received in one year by two ship modes, split by order priority."""

import numpy as np

from portbench.reference.common import date, dense, group_sums

COLUMNS = {"orders": ["o_orderkey", "o_orderpriority"],
           "lineitem": ["l_orderkey", "l_shipmode", "l_commitdate", "l_receiptdate",
                        "l_shipdate"]}


def answer(db, p):
    mode = db.col("lineitem", "l_shipmode")
    receipt = db.col("lineitem", "l_receiptdate")
    if "q12" not in db.memo:  # late lines, and each line's order priority
        commit, ship = db.col("lineitem", "l_commitdate"), db.col("lineitem", "l_shipdate")
        prio = db.col("orders", "o_orderpriority")
        high_of = dense(db.col("orders", "o_orderkey"), prio.isin(["1-URGENT", "2-HIGH"]), False)
        late = np.flatnonzero((commit < receipt) & (ship < commit))
        db.memo["q12"] = (late, high_of[db.col("lineitem", "l_orderkey")[late]])
    late, late_high = db.memo["q12"]
    modes = [p["SHIPMODE1"], p["SHIPMODE2"]]
    r = receipt[late]
    keep = (mode.isin(modes)[late] & (r >= date(p["DATE"])) & (r < date(p["DATE_END"])))
    idx = late[keep]
    high = late_high[keep]
    names = sorted(modes)
    gid = np.full(len(idx), -1, dtype=np.int64)
    for g, name in enumerate(names):
        gid[mode.codes[idx] == mode.code(name)] = g
    hi_n, lo_n = group_sums(gid, len(names), high.astype(np.int64), (~high).astype(np.int64))
    keep = np.flatnonzero(hi_n + lo_n > 0)
    return {"l_shipmode": [names[g] for g in keep], "high_line_count": hi_n[keep],
            "low_line_count": lo_n[keep]}
