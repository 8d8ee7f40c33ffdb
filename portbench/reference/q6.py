"""TPC-H q6, the forecasting revenue change report: the revenue a
discount band would have added over one year."""

import numpy as np

from portbench.reference.common import date

COLUMNS = {"lineitem": ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]}


def answer(db, p):
    ship = db.col("lineitem", "l_shipdate")
    disc, qty = db.f("lineitem", "l_discount"), db.f("lineitem", "l_quantity")
    m = ((ship >= date(p["DATE"])) & (ship < date(p["DATE_END"]))
         & (disc >= db.num(p["DISCOUNT_LO"])) & (disc <= db.num(p["DISCOUNT_HI"]))
         & (qty < db.num(p["QUANTITY"])))
    idx = np.flatnonzero(m)
    revenue = (db.f("lineitem", "l_extendedprice")[idx] * disc[idx]).sum(dtype=db.dtype)
    # SQL's sum over no rows is NULL
    return {"revenue": np.array([revenue if len(idx) else np.nan], dtype=db.dtype)}
