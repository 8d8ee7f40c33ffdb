"""TPC-H q1, the pricing summary report: lineitem shipped by SHIPDATE,
grouped by return flag and line status."""

import numpy as np

from portbench.reference.common import date, group_sums

COLUMNS = {"lineitem": ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
                        "l_discount", "l_tax", "l_shipdate"]}


def _shared(db):
    """What every statement of q1 shares: the groups in (returnflag,
    linestatus) string order, each row's group, and the products."""
    if "q1" not in db.memo:
        rf, ls = db.col("lineitem", "l_returnflag"), db.col("lineitem", "l_linestatus")
        pairs = sorted((a, b) for a in rf.values for b in ls.values)
        gid_of = np.empty((len(rf.values), len(ls.values)), dtype=np.int8)
        for g, (a, b) in enumerate(pairs):
            gid_of[rf.code(a), ls.code(b)] = g
        price, disc = db.f("lineitem", "l_extendedprice"), db.f("lineitem", "l_discount")
        disc_price = price * (1 - disc)
        db.memo["q1"] = (pairs, gid_of[rf.codes, ls.codes], disc_price,
                         disc_price * (1 + db.f("lineitem", "l_tax")))
    return db.memo["q1"]


def answer(db, p):
    pairs, row_gid, disc_price, charge = _shared(db)
    m = db.col("lineitem", "l_shipdate") <= date(p["SHIPDATE"])
    gid = np.where(m, row_gid, -1)
    s_qty, s_price, s_disc_price, s_charge, s_disc, n = group_sums(
        gid, len(pairs), db.f("lineitem", "l_quantity"), db.f("lineitem", "l_extendedprice"),
        disc_price, charge, db.f("lineitem", "l_discount"), np.ones(len(gid), dtype=np.int64))
    keep = np.flatnonzero(n > 0)
    n_f = n[keep].astype(db.dtype)
    return {
        "l_returnflag": [pairs[g][0] for g in keep],
        "l_linestatus": [pairs[g][1] for g in keep],
        "sum_qty": s_qty[keep],
        "sum_base_price": s_price[keep],
        "sum_disc_price": s_disc_price[keep],
        "sum_charge": s_charge[keep],
        "avg_qty": s_qty[keep] / n_f,
        "avg_price": s_price[keep] / n_f,
        "avg_disc": s_disc[keep] / n_f,
        "count_order": n[keep],
    }
