"""TPC-H q3, the shipping priority report: the ten unshipped orders of
one market segment with the largest revenue."""

import numpy as np

from portbench.reference.common import by_key_sums, date, dense

COLUMNS = {"customer": ["c_custkey", "c_mktsegment"],
           "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
           "lineitem": ["l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"]}


def answer(db, p):
    d = date(p["DATE"])
    seg = db.col("customer", "c_mktsegment")
    in_seg = dense(db.col("customer", "c_custkey"), seg.codes == seg.code(p["SEGMENT"]), False)
    ok, ocust = db.col("orders", "o_orderkey"), db.col("orders", "o_custkey")
    odate = db.col("orders", "o_orderdate")
    o_sel = (odate < d) & in_seg[ocust]
    sel_of = dense(ok, o_sel, False)
    lk = db.col("lineitem", "l_orderkey")
    ship = db.col("lineitem", "l_shipdate")
    m = (ship > d) & sel_of[lk]
    idx = np.flatnonzero(m)
    rev = db.f("lineitem", "l_extendedprice")[idx] * (1 - db.f("lineitem", "l_discount")[idx])
    keys, revenue = by_key_sums(lk[idx], rev)
    row_of = dense(ok, np.arange(len(ok)), -1)
    rows = row_of[keys]
    dates = odate[rows]
    # revenue descending, then order date, then the key: the first ten
    top = np.lexsort((keys, dates, -revenue))[:10]
    return {"l_orderkey": keys[top], "revenue": revenue[top], "o_orderdate": dates[top],
            "o_shippriority": db.col("orders", "o_shippriority")[rows[top]]}
