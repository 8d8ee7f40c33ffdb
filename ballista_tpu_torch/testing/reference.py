"""Pandas reference implementations of the 22 TPC-H queries.

The correctness oracle: every query hand-written directly against pandas,
sharing NO code with the engine (parser/planner/operators), so a bug in the
engine cannot hide in the oracle. Plays the role of the reference's
expected-results verification (benchmarks/src/bin/tpch.rs `verify` +
.github/workflows/rust.yml "verify that benchmark queries return expected
results").

`run_reference(qnum, tables)` returns a pandas DataFrame whose columns are
ordered like the SQL SELECT list.
"""

from __future__ import annotations

import datetime as dt

import numpy as np
import pandas as pd


def load_tables(data_dir: str,
                columns: dict[str, list[str]] | None = None) -> dict[str, pd.DataFrame]:
    """Load the 8 TPC-H tables into pandas. `columns` optionally restricts
    each table to a projection — at SF10 the full tables cost ~40 GB
    (object-dtype comment strings dominate) and per-query merge
    intermediates stack on top, so large-scale gates must pass the union
    of columns their queries actually reference."""
    import glob
    import os

    import pyarrow.parquet as pq

    out = {}
    for t in ("region", "nation", "supplier", "part", "partsupp", "customer", "orders", "lineitem"):
        files = sorted(glob.glob(os.path.join(data_dir, t, "*.parquet")))
        cols = (columns or {}).get(t)
        df = pd.concat(
            [pq.read_table(f, columns=cols).to_pandas(date_as_object=False) for f in files],
            ignore_index=True)
        out[t] = df
    return out


def _d(s: str):
    return pd.Timestamp(s)


def run_reference(q: int, t: dict[str, pd.DataFrame]) -> pd.DataFrame:
    return _QUERIES[q](t)


def q1(t):
    li = t["lineitem"]
    df = li[li.l_shipdate <= _d("1998-09-02")].copy()
    df["disc_price"] = df.l_extendedprice * (1 - df.l_discount)
    df["charge"] = df.disc_price * (1 + df.l_tax)
    g = df.groupby(["l_returnflag", "l_linestatus"], as_index=False).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"),
        sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"),
        avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"),
        count_order=("l_quantity", "size"),
    )
    return g.sort_values(["l_returnflag", "l_linestatus"]).reset_index(drop=True)


def q2(t):
    part, supp, ps, nat, reg = t["part"], t["supplier"], t["partsupp"], t["nation"], t["region"]
    eu = reg[reg.r_name == "EUROPE"]
    n = nat.merge(eu, left_on="n_regionkey", right_on="r_regionkey")
    s = supp.merge(n, left_on="s_nationkey", right_on="n_nationkey")
    x = ps.merge(s, left_on="ps_suppkey", right_on="s_suppkey")
    mins = x.groupby("ps_partkey")["ps_supplycost"].min().rename("min_cost").reset_index()
    p = part[(part.p_size == 15) & part.p_type.str.endswith("BRASS")]
    y = x.merge(p, left_on="ps_partkey", right_on="p_partkey")
    y = y.merge(mins, on="ps_partkey")
    y = y[y.ps_supplycost == y.min_cost]
    out = y[["s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr", "s_address", "s_phone", "s_comment"]]
    out = out.sort_values(["s_acctbal", "n_name", "s_name", "p_partkey"],
                          ascending=[False, True, True, True]).head(100)
    return out.reset_index(drop=True)


def q3(t):
    c = t["customer"][t["customer"].c_mktsegment == "BUILDING"]
    o = t["orders"][t["orders"].o_orderdate < _d("1995-03-15")]
    l = t["lineitem"][t["lineitem"].l_shipdate > _d("1995-03-15")].copy()
    x = c.merge(o, left_on="c_custkey", right_on="o_custkey").merge(
        l, left_on="o_orderkey", right_on="l_orderkey"
    )
    x["revenue"] = x.l_extendedprice * (1 - x.l_discount)
    g = x.groupby(["l_orderkey", "o_orderdate", "o_shippriority"], as_index=False)["revenue"].sum()
    g = g[["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]]
    return g.sort_values(["revenue", "o_orderdate"], ascending=[False, True]).head(10).reset_index(drop=True)


def q4(t):
    o = t["orders"]
    o = o[(o.o_orderdate >= _d("1993-07-01")) & (o.o_orderdate < _d("1993-10-01"))]
    l = t["lineitem"]
    l = l[l.l_commitdate < l.l_receiptdate]
    ok = o[o.o_orderkey.isin(l.l_orderkey)]
    g = ok.groupby("o_orderpriority", as_index=False).size().rename(columns={"size": "order_count"})
    return g.sort_values("o_orderpriority").reset_index(drop=True)


def q5(t):
    r = t["region"][t["region"].r_name == "ASIA"]
    n = t["nation"].merge(r, left_on="n_regionkey", right_on="r_regionkey")
    o = t["orders"]
    o = o[(o.o_orderdate >= _d("1994-01-01")) & (o.o_orderdate < _d("1995-01-01"))]
    x = (
        t["customer"]
        .merge(o, left_on="c_custkey", right_on="o_custkey")
        .merge(t["lineitem"], left_on="o_orderkey", right_on="l_orderkey")
        .merge(t["supplier"], left_on="l_suppkey", right_on="s_suppkey")
    )
    x = x[x.c_nationkey == x.s_nationkey]
    x = x.merge(n, left_on="s_nationkey", right_on="n_nationkey")
    x["revenue"] = x.l_extendedprice * (1 - x.l_discount)
    g = x.groupby("n_name", as_index=False)["revenue"].sum()
    return g.sort_values("revenue", ascending=False).reset_index(drop=True)


def q6(t):
    l = t["lineitem"]
    m = (
        (l.l_shipdate >= _d("1994-01-01"))
        & (l.l_shipdate < _d("1995-01-01"))
        & (l.l_discount >= 0.05)
        & (l.l_discount <= 0.07)
        & (l.l_quantity < 24)
    )
    return pd.DataFrame({"revenue": [(l[m].l_extendedprice * l[m].l_discount).sum()]})


def q7(t):
    n1 = t["nation"].rename(columns=lambda c: c + "_1")
    n2 = t["nation"].rename(columns=lambda c: c + "_2")
    x = (
        t["supplier"]
        .merge(t["lineitem"], left_on="s_suppkey", right_on="l_suppkey")
        .merge(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
        .merge(t["customer"], left_on="o_custkey", right_on="c_custkey")
        .merge(n1, left_on="s_nationkey", right_on="n_nationkey_1")
        .merge(n2, left_on="c_nationkey", right_on="n_nationkey_2")
    )
    x = x[
        ((x.n_name_1 == "FRANCE") & (x.n_name_2 == "GERMANY"))
        | ((x.n_name_1 == "GERMANY") & (x.n_name_2 == "FRANCE"))
    ]
    x = x[(x.l_shipdate >= _d("1995-01-01")) & (x.l_shipdate <= _d("1996-12-31"))].copy()
    x["l_year"] = x.l_shipdate.dt.year
    x["volume"] = x.l_extendedprice * (1 - x.l_discount)
    g = x.groupby(["n_name_1", "n_name_2", "l_year"], as_index=False)["volume"].sum()
    g.columns = ["supp_nation", "cust_nation", "l_year", "revenue"]
    return g.sort_values(["supp_nation", "cust_nation", "l_year"]).reset_index(drop=True)


def q8(t):
    r = t["region"][t["region"].r_name == "AMERICA"]
    n1 = t["nation"].merge(r, left_on="n_regionkey", right_on="r_regionkey")
    p = t["part"][t["part"].p_type == "ECONOMY ANODIZED STEEL"]
    o = t["orders"]
    o = o[(o.o_orderdate >= _d("1995-01-01")) & (o.o_orderdate <= _d("1996-12-31"))]
    x = (
        p.merge(t["lineitem"], left_on="p_partkey", right_on="l_partkey")
        .merge(t["supplier"], left_on="l_suppkey", right_on="s_suppkey")
        .merge(o, left_on="l_orderkey", right_on="o_orderkey")
        .merge(t["customer"], left_on="o_custkey", right_on="c_custkey")
        .merge(n1[["n_nationkey"]], left_on="c_nationkey", right_on="n_nationkey")
        .merge(t["nation"][["n_nationkey", "n_name"]].rename(columns={"n_nationkey": "nk2", "n_name": "nation"}),
               left_on="s_nationkey", right_on="nk2")
    )
    x["o_year"] = x.o_orderdate.dt.year
    x["volume"] = x.l_extendedprice * (1 - x.l_discount)
    x["brazil_volume"] = np.where(x.nation == "BRAZIL", x.volume, 0.0)
    g = x.groupby("o_year", as_index=False).agg(bv=("brazil_volume", "sum"), v=("volume", "sum"))
    g["mkt_share"] = g.bv / g.v
    return g[["o_year", "mkt_share"]].sort_values("o_year").reset_index(drop=True)


def q9(t):
    p = t["part"][t["part"].p_name.str.contains("green")]
    x = (
        p.merge(t["lineitem"], left_on="p_partkey", right_on="l_partkey")
        .merge(t["supplier"], left_on="l_suppkey", right_on="s_suppkey")
        .merge(t["partsupp"], left_on=["l_suppkey", "l_partkey"], right_on=["ps_suppkey", "ps_partkey"])
        .merge(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
        .merge(t["nation"], left_on="s_nationkey", right_on="n_nationkey")
    )
    x["o_year"] = x.o_orderdate.dt.year
    x["amount"] = x.l_extendedprice * (1 - x.l_discount) - x.ps_supplycost * x.l_quantity
    g = x.groupby(["n_name", "o_year"], as_index=False)["amount"].sum()
    g.columns = ["nation", "o_year", "sum_profit"]
    return g.sort_values(["nation", "o_year"], ascending=[True, False]).reset_index(drop=True)


def q10(t):
    o = t["orders"]
    o = o[(o.o_orderdate >= _d("1993-10-01")) & (o.o_orderdate < _d("1994-01-01"))]
    l = t["lineitem"][t["lineitem"].l_returnflag == "R"]
    x = (
        t["customer"]
        .merge(o, left_on="c_custkey", right_on="o_custkey")
        .merge(l, left_on="o_orderkey", right_on="l_orderkey")
        .merge(t["nation"], left_on="c_nationkey", right_on="n_nationkey")
    )
    x["revenue"] = x.l_extendedprice * (1 - x.l_discount)
    g = x.groupby(
        ["c_custkey", "c_name", "c_acctbal", "c_phone", "n_name", "c_address", "c_comment"],
        as_index=False,
    )["revenue"].sum()
    g = g[["c_custkey", "c_name", "revenue", "c_acctbal", "n_name", "c_address", "c_phone", "c_comment"]]
    return g.sort_values("revenue", ascending=False).head(20).reset_index(drop=True)


def q11(t):
    n = t["nation"][t["nation"].n_name == "GERMANY"]
    x = (
        t["partsupp"]
        .merge(t["supplier"], left_on="ps_suppkey", right_on="s_suppkey")
        .merge(n, left_on="s_nationkey", right_on="n_nationkey")
    )
    x["value"] = x.ps_supplycost * x.ps_availqty
    total = x.value.sum() * 0.0001
    g = x.groupby("ps_partkey", as_index=False)["value"].sum()
    g = g[g.value > total]
    return g.sort_values("value", ascending=False).reset_index(drop=True)


def q12(t):
    l = t["lineitem"]
    l = l[
        l.l_shipmode.isin(["MAIL", "SHIP"])
        & (l.l_commitdate < l.l_receiptdate)
        & (l.l_shipdate < l.l_commitdate)
        & (l.l_receiptdate >= _d("1994-01-01"))
        & (l.l_receiptdate < _d("1995-01-01"))
    ]
    x = t["orders"].merge(l, left_on="o_orderkey", right_on="l_orderkey")
    hi = x.o_orderpriority.isin(["1-URGENT", "2-HIGH"])
    x = x.assign(high_line=np.where(hi, 1, 0), low_line=np.where(~hi, 1, 0))
    g = x.groupby("l_shipmode", as_index=False).agg(
        high_line_count=("high_line", "sum"), low_line_count=("low_line", "sum")
    )
    return g.sort_values("l_shipmode").reset_index(drop=True)


def q13(t):
    o = t["orders"][~t["orders"].o_comment.str.contains("special.*requests", regex=True)]
    merged = t["customer"].merge(o, left_on="c_custkey", right_on="o_custkey", how="left")
    g = merged.groupby("c_custkey")["o_orderkey"].count().rename("c_count").reset_index()
    d = g.groupby("c_count", as_index=False).size().rename(columns={"size": "custdist"})
    d = d[["c_count", "custdist"]]
    return d.sort_values(["custdist", "c_count"], ascending=[False, False]).reset_index(drop=True)


def q14(t):
    l = t["lineitem"]
    l = l[(l.l_shipdate >= _d("1995-09-01")) & (l.l_shipdate < _d("1995-10-01"))]
    x = l.merge(t["part"], left_on="l_partkey", right_on="p_partkey")
    x["rev"] = x.l_extendedprice * (1 - x.l_discount)
    promo = x[x.p_type.str.startswith("PROMO")].rev.sum()
    return pd.DataFrame({"promo_revenue": [100.0 * promo / x.rev.sum()]})


def q15(t):
    l = t["lineitem"]
    l = l[(l.l_shipdate >= _d("1996-01-01")) & (l.l_shipdate < _d("1996-04-01"))].copy()
    l["rev"] = l.l_extendedprice * (1 - l.l_discount)
    rev = l.groupby("l_suppkey", as_index=False)["rev"].sum()
    rev.columns = ["supplier_no", "total_revenue"]
    mx = rev.total_revenue.max()
    x = t["supplier"].merge(rev[rev.total_revenue == mx], left_on="s_suppkey", right_on="supplier_no")
    out = x[["s_suppkey", "s_name", "s_address", "s_phone", "total_revenue"]]
    return out.sort_values("s_suppkey").reset_index(drop=True)


def q16(t):
    bad_supp = t["supplier"][t["supplier"].s_comment.str.contains("Customer.*Complaints", regex=True)].s_suppkey
    p = t["part"]
    p = p[(p.p_brand != "Brand#45") & ~p.p_type.str.startswith("MEDIUM POLISHED")
          & p.p_size.isin([49, 14, 23, 45, 19, 3, 36, 9])]
    x = t["partsupp"].merge(p, left_on="ps_partkey", right_on="p_partkey")
    x = x[~x.ps_suppkey.isin(bad_supp)]
    g = (
        x.groupby(["p_brand", "p_type", "p_size"])["ps_suppkey"]
        .nunique()
        .rename("supplier_cnt")
        .reset_index()
    )
    g = g[["p_brand", "p_type", "p_size", "supplier_cnt"]]
    return g.sort_values(
        ["supplier_cnt", "p_brand", "p_type", "p_size"], ascending=[False, True, True, True]
    ).reset_index(drop=True)


def q17(t):
    p = t["part"][(t["part"].p_brand == "Brand#23") & (t["part"].p_container == "MED BOX")]
    l = t["lineitem"]
    avg_qty = l.groupby("l_partkey")["l_quantity"].mean().rename("avg_q").reset_index()
    x = l.merge(p, left_on="l_partkey", right_on="p_partkey").merge(avg_qty, on="l_partkey")
    x = x[x.l_quantity < 0.2 * x.avg_q]
    return pd.DataFrame({"avg_yearly": [x.l_extendedprice.sum() / 7.0]})


def q18(t):
    l = t["lineitem"]
    big = l.groupby("l_orderkey")["l_quantity"].sum()
    big = big[big > 300].index
    o = t["orders"][t["orders"].o_orderkey.isin(big)]
    x = t["customer"].merge(o, left_on="c_custkey", right_on="o_custkey").merge(
        l, left_on="o_orderkey", right_on="l_orderkey"
    )
    g = x.groupby(
        ["c_name", "c_custkey", "o_orderkey", "o_orderdate", "o_totalprice"], as_index=False
    )["l_quantity"].sum()
    g.columns = ["c_name", "c_custkey", "o_orderkey", "o_orderdate", "o_totalprice", "total_quantity"]
    return g.sort_values(["o_totalprice", "o_orderdate"], ascending=[False, True]).head(100).reset_index(drop=True)


def q19(t):
    x = t["lineitem"].merge(t["part"], left_on="l_partkey", right_on="p_partkey")
    x = x[x.l_shipmode.isin(["AIR", "AIR REG"]) & (x.l_shipinstruct == "DELIVER IN PERSON")]
    b1 = (
        (x.p_brand == "Brand#12")
        & x.p_container.isin(["SM CASE", "SM BOX", "SM PACK", "SM PKG"])
        & (x.l_quantity >= 1) & (x.l_quantity <= 11)
        & (x.p_size >= 1) & (x.p_size <= 5)
    )
    b2 = (
        (x.p_brand == "Brand#23")
        & x.p_container.isin(["MED BAG", "MED BOX", "MED PKG", "MED PACK"])
        & (x.l_quantity >= 10) & (x.l_quantity <= 20)
        & (x.p_size >= 1) & (x.p_size <= 10)
    )
    b3 = (
        (x.p_brand == "Brand#34")
        & x.p_container.isin(["LG CASE", "LG BOX", "LG PACK", "LG PKG"])
        & (x.l_quantity >= 20) & (x.l_quantity <= 30)
        & (x.p_size >= 1) & (x.p_size <= 15)
    )
    sel = x[b1 | b2 | b3]
    return pd.DataFrame({"revenue": [(sel.l_extendedprice * (1 - sel.l_discount)).sum()]})


def q20(t):
    forest = t["part"][t["part"].p_name.str.startswith("forest")].p_partkey
    l = t["lineitem"]
    l = l[(l.l_shipdate >= _d("1994-01-01")) & (l.l_shipdate < _d("1995-01-01"))]
    half = (
        l.groupby(["l_partkey", "l_suppkey"])["l_quantity"].sum().rename("qty").reset_index()
    )
    ps = t["partsupp"][t["partsupp"].ps_partkey.isin(forest)]
    x = ps.merge(half, left_on=["ps_partkey", "ps_suppkey"], right_on=["l_partkey", "l_suppkey"])
    x = x[x.ps_availqty > 0.5 * x.qty]
    n = t["nation"][t["nation"].n_name == "CANADA"]
    s = t["supplier"][t["supplier"].s_suppkey.isin(x.ps_suppkey)]
    s = s.merge(n, left_on="s_nationkey", right_on="n_nationkey")
    return s[["s_name", "s_address"]].sort_values("s_name").reset_index(drop=True)


def q21(t):
    l = t["lineitem"]
    n = t["nation"][t["nation"].n_name == "SAUDI ARABIA"]
    o = t["orders"][t["orders"].o_orderstatus == "F"]
    l1 = l[l.l_receiptdate > l.l_commitdate]
    x = (
        t["supplier"]
        .merge(n, left_on="s_nationkey", right_on="n_nationkey")
        .merge(l1, left_on="s_suppkey", right_on="l_suppkey")
        .merge(o, left_on="l_orderkey", right_on="o_orderkey")
    )
    # exists: another supplier on the same order
    sup_per_order = l.groupby("l_orderkey")["l_suppkey"].nunique().rename("nsupp")
    x = x.join(sup_per_order, on="l_orderkey")
    x = x[x.nsupp > 1]
    # not exists: no OTHER supplier was late on the order
    late = l[l.l_receiptdate > l.l_commitdate]
    late_sup_per_order = late.groupby("l_orderkey")["l_suppkey"].nunique().rename("nlate")
    x = x.join(late_sup_per_order, on="l_orderkey")
    x = x[x.nlate == 1]  # only this supplier late
    g = x.groupby("s_name", as_index=False).size().rename(columns={"size": "numwait"})
    return g.sort_values(["numwait", "s_name"], ascending=[False, True]).head(100).reset_index(drop=True)


def q22(t):
    c = t["customer"].copy()
    c["cntrycode"] = c.c_phone.str[:2]
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    c = c[c.cntrycode.isin(codes)]
    avg_bal = c[c.c_acctbal > 0.0].c_acctbal.mean()
    c = c[c.c_acctbal > avg_bal]
    c = c[~c.c_custkey.isin(t["orders"].o_custkey)]
    g = c.groupby("cntrycode", as_index=False).agg(
        numcust=("c_acctbal", "size"), totacctbal=("c_acctbal", "sum")
    )
    return g.sort_values("cntrycode").reset_index(drop=True)


_QUERIES = {
    1: q1, 2: q2, 3: q3, 4: q4, 5: q5, 6: q6, 7: q7, 8: q8, 9: q9, 10: q10,
    11: q11, 12: q12, 13: q13, 14: q14, 15: q15, 16: q16, 17: q17, 18: q18,
    19: q19, 20: q20, 21: q21, 22: q22,
}


def compare_results(engine_table, ref_df: pd.DataFrame, q: int, sort_insensitive_tail: bool = True,
                    rtol: float = 1e-6) -> list[str]:
    """Compare engine output (pa.Table) with the oracle. Returns a list of
    mismatch descriptions (empty = pass). Column names are compared
    positionally; floats with relative tolerance; fully-sorted queries
    compare row-for-row, ties broken by sorting both sides identically."""
    problems: list[str] = []
    eng = engine_table.to_pandas(date_as_object=False)
    if len(eng) != len(ref_df):
        problems.append(f"q{q}: row count {len(eng)} != expected {len(ref_df)}")
        return problems
    if len(eng.columns) != len(ref_df.columns):
        problems.append(f"q{q}: column count {len(eng.columns)} != {len(ref_df.columns)}")
        return problems
    eng = eng.copy()
    eng.columns = list(ref_df.columns)
    # canonical order: sort both by all columns (stable for ties/limit-less)
    def canon(df):
        cols = list(df.columns)
        try:
            return df.sort_values(cols, kind="mergesort").reset_index(drop=True)
        except Exception:
            return df.reset_index(drop=True)

    a, b = canon(eng), canon(ref_df)
    for col in ref_df.columns:
        av, bv = a[col], b[col]
        if pd.api.types.is_float_dtype(bv) or pd.api.types.is_float_dtype(av):
            av = av.astype(float)
            bv = bv.astype(float)
            bad = ~np.isclose(av, bv, rtol=rtol, equal_nan=True)
            if bad.any():
                i = int(np.argmax(bad))
                problems.append(f"q{q}: col {col} mismatch at row {i}: {av[i]} != {bv[i]}")
        else:
            if pd.api.types.is_datetime64_any_dtype(bv) or pd.api.types.is_datetime64_any_dtype(av):
                av = pd.to_datetime(av)
                bv = pd.to_datetime(bv)
            bad = av.astype(object) != bv.astype(object)
            if bad.any():
                i = int(np.argmax(bad.values))
                problems.append(f"q{q}: col {col} mismatch at row {i}: {av.iloc[i]!r} != {bv.iloc[i]!r}")
    return problems
