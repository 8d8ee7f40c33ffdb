"""TPC-H q5, the local supplier volume report: one year's revenue of one
region's nations, from lines whose customer and supplier share a nation."""

import numpy as np

from portbench.reference.common import date, dense

COLUMNS = {"region": ["r_regionkey", "r_name"],
           "nation": ["n_nationkey", "n_name", "n_regionkey"],
           "customer": ["c_custkey", "c_nationkey"],
           "supplier": ["s_suppkey", "s_nationkey"],
           "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
           "lineitem": ["l_orderkey", "l_suppkey", "l_extendedprice", "l_discount"]}


def answer(db, p):
    r_name = db.col("region", "r_name")
    regions = db.col("region", "r_regionkey")[r_name.codes == r_name.code(p["REGION"])]
    nk, n_region = db.col("nation", "n_nationkey"), db.col("nation", "n_regionkey")
    n_name = db.col("nation", "n_name")
    in_region = dense(nk, np.isin(n_region, regions), False)
    if "q5" not in db.memo:
        # each line's order row, its customer's nation and its supplier's nation
        cust_nation = dense(db.col("customer", "c_custkey"), db.col("customer", "c_nationkey"), -1)
        ok = db.col("orders", "o_orderkey")
        order_row = dense(ok, np.arange(len(ok), dtype=np.int64), -1)[db.col("lineitem", "l_orderkey")]
        ln = cust_nation[db.col("orders", "o_custkey")][order_row]
        supp_nation = dense(db.col("supplier", "s_suppkey"), db.col("supplier", "s_nationkey"), -1)
        sn = supp_nation[db.col("lineitem", "l_suppkey")]
        same = np.flatnonzero(ln == sn)
        db.memo["q5"] = (same, order_row[same], sn[same])
    same, rows, sn = db.memo["q5"]
    odate = db.col("orders", "o_orderdate")[rows]
    m = (odate >= date(p["DATE"])) & (odate < date(p["DATE_END"])) & in_region[sn]
    idx = same[m]
    rev = db.f("lineitem", "l_extendedprice")[idx] * (1 - db.f("lineitem", "l_discount")[idx])
    nations = sn[m]
    out_n, out_r = [], []
    for k in np.unique(nations):
        out_n.append(n_name.values[n_name.codes[np.flatnonzero(nk == k)[0]]])
        out_r.append(rev[nations == k].sum(dtype=db.dtype))
    order = np.argsort(-np.array(out_r, dtype=db.dtype), kind="stable")
    return {"n_name": [out_n[i] for i in order],
            "revenue": np.array(out_r, dtype=db.dtype)[order]}
