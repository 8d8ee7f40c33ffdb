"""pandas oracle for the TPC-DS query subset (benchmarks/tpcds/queries).

Mirrors testing/reference.py's role for TPC-H: an independent computation
of each query used by --verify and the test suite. Sort-prefix comparison
semantics: rows are compared on the ORDER BY prefix columns; full-row sets
must match.
"""

from __future__ import annotations

import datetime as dt
import os

import numpy as np
import pandas as pd
import pyarrow.parquet as pq

from ballista_tpu_torch.testing.tpcdsgen import TPCDS_TABLES


def _rollup(m: pd.DataFrame, cols: list, valcol, how: str) -> pd.DataFrame:
    """GROUP BY ROLLUP(cols): one frame per prefix level (full detail down
    to grand total), grouped-out keys padded with None. `valcol` may be a
    single column name or a list. Adds a `lochierarchy` column (= number
    of grouped-out keys, the grouping()-sum the rollup queries select)."""
    vals = [valcol] if isinstance(valcol, str) else list(valcol)
    frames = []
    for k in range(len(cols), -1, -1):
        keys = cols[:k]
        if keys:
            g = getattr(m.groupby(keys, as_index=False)[vals], how)()
        else:
            g = pd.DataFrame({v: [getattr(m[v], how)()] for v in vals})
        for c in cols[k:]:
            g[c] = None
        g["lochierarchy"] = len(cols) - k
        frames.append(g[cols + vals + ["lochierarchy"]])
    return pd.concat(frames, ignore_index=True)


def load_tables(data_dir: str) -> dict[str, pd.DataFrame]:
    out = {}
    for t in TPCDS_TABLES:
        out[t] = pq.read_table(os.path.join(data_dir, t)).to_pandas()
    return out


def run_reference(q: int, t: dict[str, pd.DataFrame]) -> pd.DataFrame:
    ss, dd, it = t["store_sales"], t["date_dim"], t["item"]
    if q == 3:
        m = ss.merge(dd, left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(it[it.i_manufact_id == 128], left_on="ss_item_sk", right_on="i_item_sk")
        m = m[m.d_moy == 11]
        g = m.groupby(["d_year", "i_brand_id", "i_brand"], as_index=False).agg(
            sum_agg=("ss_ext_sales_price", "sum"))
        g = g.rename(columns={"i_brand_id": "brand_id", "i_brand": "brand"})
        return g.sort_values(["d_year", "sum_agg", "brand_id"],
                             ascending=[True, False, True]).head(100).reset_index(drop=True)
    if q == 7:
        cd, pr = t["customer_demographics"], t["promotion"]
        m = ss.merge(dd[dd.d_year == 2000], left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
        cdf = cd[(cd.cd_gender == "M") & (cd.cd_marital_status == "S")
                 & (cd.cd_education_status == "College")]
        m = m.merge(cdf, left_on="ss_cdemo_sk", right_on="cd_demo_sk")
        prf = pr[(pr.p_channel_email == "N") | (pr.p_channel_event == "N")]
        m = m.merge(prf, left_on="ss_promo_sk", right_on="p_promo_sk")
        g = m.groupby("i_item_id", as_index=False).agg(
            agg1=("ss_quantity", "mean"), agg2=("ss_list_price", "mean"),
            agg3=("ss_coupon_amt", "mean"), agg4=("ss_sales_price", "mean"))
        return g.sort_values("i_item_id").head(100).reset_index(drop=True)
    if q == 19:
        cu, ca, st = t["customer"], t["customer_address"], t["store"]
        m = ss.merge(dd[(dd.d_moy == 11) & (dd.d_year == 1998)],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(it[it.i_manager_id == 8], left_on="ss_item_sk", right_on="i_item_sk")
        m = m.merge(cu, left_on="ss_customer_sk", right_on="c_customer_sk")
        m = m.merge(ca, left_on="c_current_addr_sk", right_on="ca_address_sk")
        m = m.merge(st, left_on="ss_store_sk", right_on="s_store_sk")
        m = m[m.ca_state != m.s_state]
        g = m.groupby(["i_brand_id", "i_brand", "i_manufact_id"], as_index=False).agg(
            ext_price=("ss_ext_sales_price", "sum"))
        g = g.rename(columns={"i_brand_id": "brand_id", "i_brand": "brand"})
        return g.sort_values(["ext_price", "brand_id", "i_manufact_id"],
                             ascending=[False, True, True]).head(100).reset_index(drop=True)
    if q in (42, 52, 55):
        mgr = {42: 1, 52: 1, 55: 28}[q]
        year = {42: 2000, 52: 2000, 55: 1999}[q]
        m = ss.merge(dd[(dd.d_moy == 11) & (dd.d_year == year)],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(it[it.i_manager_id == mgr], left_on="ss_item_sk", right_on="i_item_sk")
        if q == 42:
            g = m.groupby(["d_year", "i_category_id", "i_category"], as_index=False).agg(
                total=("ss_ext_sales_price", "sum"))
            return g.sort_values(["total", "d_year", "i_category_id", "i_category"],
                                 ascending=[False, True, True, True]).head(100).reset_index(drop=True)
        g = m.groupby((["d_year"] if q == 52 else []) + ["i_brand_id", "i_brand"],
                      as_index=False).agg(ext_price=("ss_ext_sales_price", "sum"))
        g = g.rename(columns={"i_brand_id": "brand_id", "i_brand": "brand"})
        if q == 52:
            return g.sort_values(["d_year", "ext_price", "brand_id"],
                                 ascending=[True, False, True]).head(100).reset_index(drop=True)
        return g.sort_values(["ext_price", "brand_id"],
                             ascending=[False, True]).head(100).reset_index(drop=True)
    if q == 68:
        cu, ca, st, hd = t["customer"], t["customer_address"], t["store"], t["household_demographics"]
        m = ss.merge(dd[(dd.d_dom.between(1, 2)) & (dd.d_year.isin([1999, 2000, 2001]))],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(st[st.s_city.isin(["Midway", "Fairview"])],
                    left_on="ss_store_sk", right_on="s_store_sk")
        m = m.merge(hd[(hd.hd_dep_count == 4) | (hd.hd_vehicle_count == 3)],
                    left_on="ss_hdemo_sk", right_on="hd_demo_sk")
        m = m.merge(ca, left_on="ss_addr_sk", right_on="ca_address_sk")
        dn = m.groupby(["ss_ticket_number", "ss_customer_sk", "ss_addr_sk", "ca_city"],
                       as_index=False).agg(extended_price=("ss_ext_sales_price", "sum"),
                                           list_price=("ss_ext_list_price", "sum"),
                                           extended_tax=("ss_ext_tax", "sum"))
        dn = dn.rename(columns={"ca_city": "bought_city"})
        dn = dn.merge(cu, left_on="ss_customer_sk", right_on="c_customer_sk")
        dn = dn.merge(ca, left_on="c_current_addr_sk", right_on="ca_address_sk")
        dn = dn[dn.ca_city != dn.bought_city]
        out = dn[["c_last_name", "c_first_name", "ca_city", "bought_city", "ss_ticket_number",
                  "extended_price", "extended_tax", "list_price"]]
        return out.sort_values(["c_last_name", "ss_ticket_number"]).head(100).reset_index(drop=True)
    if q == 73:
        cu, st, hd = t["customer"], t["store"], t["household_demographics"]
        m = ss.merge(dd[(dd.d_dom.between(1, 2)) & (dd.d_year.isin([1999, 2000, 2001]))],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(st[st.s_county.isin(["Williamson County", "Walker County"])],
                    left_on="ss_store_sk", right_on="s_store_sk")
        m = m.merge(hd[((hd.hd_buy_potential == ">10000") | (hd.hd_buy_potential == "Unknown"))
                       & (hd.hd_vehicle_count > 0)],
                    left_on="ss_hdemo_sk", right_on="hd_demo_sk")
        dj = m.groupby(["ss_ticket_number", "ss_customer_sk"], as_index=False).agg(
            cnt=("ss_ticket_number", "size"))
        dj = dj[dj.cnt.between(1, 5)]
        dj = dj.merge(cu, left_on="ss_customer_sk", right_on="c_customer_sk")
        out = dj[["c_last_name", "c_first_name", "c_customer_sk", "ss_ticket_number", "cnt"]]
        out = out.rename(columns={"c_customer_sk": "c_salutation"})
        return out.sort_values(["cnt", "c_last_name"],
                               ascending=[False, True]).head(100).reset_index(drop=True)
    if q == 96:
        td, st, hd = t["time_dim"], t["store"], t["household_demographics"]
        m = ss.merge(td[(td.t_hour == 20) & (td.t_minute >= 30)],
                     left_on="ss_sold_time_sk", right_on="t_time_sk")
        m = m.merge(hd[hd.hd_dep_count == 7], left_on="ss_hdemo_sk", right_on="hd_demo_sk")
        m = m.merge(st[st.s_store_name == "store 1"], left_on="ss_store_sk", right_on="s_store_sk")
        return pd.DataFrame({"cnt": [len(m)]})
    if q == 98:
        m = ss.merge(it[it.i_category.isin(["Sports", "Books", "Home"])],
                     left_on="ss_item_sk", right_on="i_item_sk")
        lo, hi = dt.date(1999, 2, 22), dt.date(1999, 3, 24)
        dsel = dd[(dd.d_date >= lo) & (dd.d_date <= hi)]
        m = m.merge(dsel, left_on="ss_sold_date_sk", right_on="d_date_sk")
        g = m.groupby(["i_item_id", "i_item_desc", "i_category", "i_class", "i_current_price"],
                      as_index=False).agg(itemrevenue=("ss_ext_sales_price", "sum"))
        class_tot = g.groupby("i_class")["itemrevenue"].transform("sum")
        g["revenueratio"] = g.itemrevenue * 100.0 / class_tot
        return g.sort_values(["i_category", "i_class", "i_item_id", "i_item_desc", "revenueratio"]
                             ).head(100).reset_index(drop=True)
    if q == 36:
        st = t["store"]
        m = ss.merge(dd[dd.d_year == 2001], left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
        m = m.merge(st[st.s_state.isin(["TN", "TX", "SD", "IN", "GA", "OH", "MI", "MT"])],
                    left_on="ss_store_sk", right_on="s_store_sk")

        def gm(g):
            return g.ss_net_profit.sum() / g.ss_ext_sales_price.sum()

        rows = []
        full = m.groupby(["i_category", "i_class"])
        for (cat, cls), g in full:
            rows.append((gm(g), cat, cls, 0))
        for cat, g in m.groupby("i_category"):
            rows.append((gm(g), cat, None, 1))
        rows.append((gm(m), None, None, 2))
        out = pd.DataFrame(rows, columns=["gross_margin", "i_category", "i_class", "lochierarchy"])
        out["rank_within_parent"] = (
            out.groupby("lochierarchy")["gross_margin"].rank(method="min").astype(int)
        )
        out = out.sort_values(
            ["lochierarchy", "i_category", "i_class"],
            ascending=[False, True, True], na_position="first",
        ).head(100).reset_index(drop=True)
        return out
    if q == 33:
        ca = t["customer_address"]
        out_frames = []
        for fact, date_col, item_col, addr_col, price_col in (
            (t["store_sales"], "ss_sold_date_sk", "ss_item_sk", "ss_addr_sk", "ss_ext_sales_price"),
            (t["catalog_sales"], "cs_sold_date_sk", "cs_item_sk", "cs_bill_addr_sk", "cs_ext_sales_price"),
            (t["web_sales"], "ws_sold_date_sk", "ws_item_sk", "ws_bill_addr_sk", "ws_ext_sales_price"),
        ):
            m = fact.merge(dd[(dd.d_year == 1999) & (dd.d_moy == 3)],
                           left_on=date_col, right_on="d_date_sk")
            m = m.merge(it[it.i_category == "Books"], left_on=item_col, right_on="i_item_sk")
            m = m.merge(ca[ca.ca_gmt_offset == -5.0], left_on=addr_col, right_on="ca_address_sk")
            g = m.groupby("i_manufact_id", as_index=False).agg(total_sales=(price_col, "sum"))
            out_frames.append(g)
        allc = pd.concat(out_frames, ignore_index=True)
        g = allc.groupby("i_manufact_id", as_index=False).agg(total_sales=("total_sales", "sum"))
        return g.sort_values(["total_sales", "i_manufact_id"]).head(100).reset_index(drop=True)
    if q == 6:
        cu, ca = t["customer"], t["customer_address"]
        cat_avg = it.groupby("i_category")["i_current_price"].transform("mean")
        hot = it[it.i_current_price > 1.2 * cat_avg]
        m = ss.merge(dd[(dd.d_year == 2001) & (dd.d_moy == 1)],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(hot, left_on="ss_item_sk", right_on="i_item_sk")
        m = m.merge(cu, left_on="ss_customer_sk", right_on="c_customer_sk")
        m = m.merge(ca, left_on="c_current_addr_sk", right_on="ca_address_sk")
        g = m.groupby("ca_state", as_index=False).agg(cnt=("ca_state", "size"))
        g = g[g.cnt >= 10].rename(columns={"ca_state": "state"})
        return g.sort_values(["cnt", "state"]).head(100).reset_index(drop=True)
    if q in (12, 20):
        fact, pfx = (t["web_sales"], "ws") if q == 12 else (t["catalog_sales"], "cs")
        m = fact.merge(it[it.i_category.isin(["Sports", "Books", "Home"])],
                       left_on=f"{pfx}_item_sk", right_on="i_item_sk")
        lo, hi = dt.date(1999, 2, 22), dt.date(1999, 3, 24)
        m = m.merge(dd[(dd.d_date >= lo) & (dd.d_date <= hi)],
                    left_on=f"{pfx}_sold_date_sk", right_on="d_date_sk")
        g = m.groupby(["i_item_id", "i_item_desc", "i_category", "i_class", "i_current_price"],
                      as_index=False).agg(itemrevenue=(f"{pfx}_ext_sales_price", "sum"))
        g["revenueratio"] = g.itemrevenue * 100.0 / g.groupby("i_class")["itemrevenue"].transform("sum")
        return g.sort_values(["i_category", "i_class", "i_item_id", "i_item_desc", "revenueratio"]
                             ).head(100).reset_index(drop=True)
    if q == 13:
        cd, hd, ca, st = (t["customer_demographics"], t["household_demographics"],
                          t["customer_address"], t["store"])
        m = ss.merge(st, left_on="ss_store_sk", right_on="s_store_sk")
        m = m.merge(dd[dd.d_year == 2001], left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk")
        m = m.merge(cd, left_on="ss_cdemo_sk", right_on="cd_demo_sk")
        m = m.merge(ca[ca.ca_country == "United States"],
                    left_on="ss_addr_sk", right_on="ca_address_sk")
        c1 = ((m.cd_marital_status == "M") & (m.cd_education_status == "College")
              & m.ss_sales_price.between(100, 150) & (m.hd_dep_count == 3))
        c2 = ((m.cd_marital_status == "S") & (m.cd_education_status == "Primary")
              & m.ss_sales_price.between(50, 100) & (m.hd_dep_count == 1))
        c3 = ((m.cd_marital_status == "W") & (m.cd_education_status == "2 yr Degree")
              & m.ss_sales_price.between(150, 200) & (m.hd_dep_count == 1))
        g1 = (m.ca_state.isin(["TX", "OH"]) & m.ss_net_profit.between(100, 200))
        g2 = (m.ca_state.isin(["OR", "NM", "KY"]) & m.ss_net_profit.between(150, 300))
        g3 = (m.ca_state.isin(["VA", "TX", "MS"]) & m.ss_net_profit.between(50, 250))
        m = m[(c1 | c2 | c3) & (g1 | g2 | g3)]
        return pd.DataFrame({
            "avg_q": [m.ss_quantity.mean()], "avg_esp": [m.ss_ext_sales_price.mean()],
            "avg_ewc": [m.ss_ext_wholesale_cost.mean()],
            "sum_ewc": [m.ss_ext_wholesale_cost.sum() if len(m) else None],
        })
    if q == 15:
        cs, cu, ca = t["catalog_sales"], t["customer"], t["customer_address"]
        m = cs.merge(cu, left_on="cs_bill_customer_sk", right_on="c_customer_sk")
        m = m.merge(ca, left_on="c_current_addr_sk", right_on="ca_address_sk")
        m = m.merge(dd[(dd.d_qoy == 2) & (dd.d_year == 2001)],
                    left_on="cs_sold_date_sk", right_on="d_date_sk")
        zips = {"85669", "86197", "88274", "83405", "86475", "85392", "85460",
                "80348", "81792"}
        m = m[m.ca_zip.str[:5].isin(zips) | m.ca_state.isin(["CA", "WA", "GA"])
              | (m.cs_sales_price > 500)]
        g = m.groupby("ca_zip", as_index=False).agg(s=("cs_sales_price", "sum"))
        return g.sort_values("ca_zip").head(100).reset_index(drop=True)
    if q in (25, 29):
        sr, cs, st = t["store_returns"], t["catalog_sales"], t["store"]
        if q == 25:
            d1 = dd[(dd.d_moy == 4) & (dd.d_year == 2001)]
            d2 = dd[(dd.d_moy.between(4, 10)) & (dd.d_year == 2001)]
            d3 = d2
        else:
            d1 = dd[(dd.d_moy == 9) & (dd.d_year == 1999)]
            d2 = dd[(dd.d_moy.between(9, 12)) & (dd.d_year == 1999)]
            d3 = dd[dd.d_year.isin([1999, 2000, 2001])]
        m = ss.merge(d1[["d_date_sk"]], left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
        m = m.merge(st, left_on="ss_store_sk", right_on="s_store_sk")
        m = m.merge(sr, left_on=["ss_customer_sk", "ss_item_sk", "ss_ticket_number"],
                    right_on=["sr_customer_sk", "sr_item_sk", "sr_ticket_number"])
        m = m.merge(d2[["d_date_sk"]].rename(columns={"d_date_sk": "_d2sk"}),
                    left_on="sr_returned_date_sk", right_on="_d2sk")
        m = m.merge(cs, left_on=["sr_customer_sk", "sr_item_sk"],
                    right_on=["cs_bill_customer_sk", "cs_item_sk"])
        m = m.merge(d3[["d_date_sk"]].rename(columns={"d_date_sk": "_d3sk"}),
                    left_on="cs_sold_date_sk", right_on="_d3sk")
        if q == 25:
            g = m.groupby(["i_item_id", "i_item_desc", "s_store_id", "s_store_name"],
                          as_index=False).agg(a=("ss_net_profit", "sum"),
                                              b=("sr_net_loss", "sum"),
                                              c=("cs_net_profit", "sum"))
        else:
            g = m.groupby(["i_item_id", "i_item_desc", "s_store_id", "s_store_name"],
                          as_index=False).agg(a=("ss_quantity", "sum"),
                                              b=("sr_return_quantity", "sum"),
                                              c=("cs_quantity", "sum"))
        return g.sort_values(["i_item_id", "i_item_desc", "s_store_id", "s_store_name"]
                             ).head(100).reset_index(drop=True)
    if q == 26:
        cs, cd, pr = t["catalog_sales"], t["customer_demographics"], t["promotion"]
        m = cs.merge(dd[dd.d_year == 2000], left_on="cs_sold_date_sk", right_on="d_date_sk")
        m = m.merge(it, left_on="cs_item_sk", right_on="i_item_sk")
        cdf = cd[(cd.cd_gender == "M") & (cd.cd_marital_status == "S")
                 & (cd.cd_education_status == "College")]
        m = m.merge(cdf, left_on="cs_bill_cdemo_sk", right_on="cd_demo_sk")
        prf = pr[(pr.p_channel_email == "N") | (pr.p_channel_event == "N")]
        m = m.merge(prf, left_on="cs_promo_sk", right_on="p_promo_sk")
        g = m.groupby("i_item_id", as_index=False).agg(
            agg1=("cs_quantity", "mean"), agg2=("cs_list_price", "mean"),
            agg3=("cs_coupon_amt", "mean"), agg4=("cs_sales_price", "mean"))
        return g.sort_values("i_item_id").head(100).reset_index(drop=True)
    if q in (32, 92):
        fact, pfx, mid = ((t["catalog_sales"], "cs", 77) if q == 32
                          else (t["web_sales"], "ws", 53))
        lo, hi = dt.date(2000, 1, 27), dt.date(2000, 4, 26)
        dsel = dd[(dd.d_date >= lo) & (dd.d_date <= hi)][["d_date_sk"]]
        win = fact.merge(dsel, left_on=f"{pfx}_sold_date_sk", right_on="d_date_sk")
        thresh = win.groupby(f"{pfx}_item_sk")[f"{pfx}_ext_discount_amt"].transform("mean") * 1.3
        hot = win[win[f"{pfx}_ext_discount_amt"] > thresh]
        hot = hot.merge(it[it.i_manufact_id == mid], left_on=f"{pfx}_item_sk",
                        right_on="i_item_sk")
        total = hot[f"{pfx}_ext_discount_amt"].sum() if len(hot) else None
        return pd.DataFrame({"excess_discount_amount": [total]})
    if q == 34:
        cu, st, hd = t["customer"], t["store"], t["household_demographics"]
        m = ss.merge(dd[(dd.d_dom.between(1, 3) | dd.d_dom.between(25, 28))
                        & dd.d_year.isin([1999, 2000, 2001])],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(st[st.s_county.isin(["Williamson County", "Walker County"])],
                    left_on="ss_store_sk", right_on="s_store_sk")
        m = m.merge(hd[((hd.hd_buy_potential == ">10000") | (hd.hd_buy_potential == "Unknown"))
                       & (hd.hd_vehicle_count > 0)],
                    left_on="ss_hdemo_sk", right_on="hd_demo_sk")
        dn = m.groupby(["ss_ticket_number", "ss_customer_sk"], as_index=False).agg(
            cnt=("ss_ticket_number", "size"))
        dn = dn[dn.cnt.between(5, 10)]
        dn = dn.merge(cu, left_on="ss_customer_sk", right_on="c_customer_sk")
        out = dn[["c_last_name", "c_first_name", "c_salutation", "c_preferred_cust_flag",
                  "ss_ticket_number", "cnt"]]
        return out.sort_values(
            ["c_last_name", "c_first_name", "c_salutation", "c_preferred_cust_flag",
             "ss_ticket_number"], ascending=[True, True, True, False, True],
        ).reset_index(drop=True)
    if q == 37 or q == 82:
        inv, fact = t["inventory"], t["catalog_sales"] if q == 37 else t["store_sales"]
        item_col = "cs_item_sk" if q == 37 else "ss_item_sk"
        price_lo, price_hi = (10, 150) if q == 37 else (10, 150)
        mids = [67, 96, 91, 84] if q == 37 else [43, 12, 72, 66]
        lo, hi = ((dt.date(2000, 2, 1), dt.date(2000, 4, 1)) if q == 37
                  else (dt.date(2002, 5, 30), dt.date(2002, 7, 30)))
        itf = it[it.i_current_price.between(price_lo, price_hi)
                 & it.i_manufact_id.isin(mids)]
        m = itf.merge(inv, left_on="i_item_sk", right_on="inv_item_sk")
        m = m.merge(dd[(dd.d_date >= lo) & (dd.d_date <= hi)][["d_date_sk"]],
                    left_on="inv_date_sk", right_on="d_date_sk")
        m = m[m.inv_quantity_on_hand.between(100, 500)]
        m = m.merge(fact[[item_col]], left_on="i_item_sk", right_on=item_col)
        g = m[["i_item_id", "i_item_desc", "i_current_price"]].drop_duplicates()
        return g.sort_values("i_item_id").head(100).reset_index(drop=True)
    if q == 40:
        cs, wh = t["catalog_sales"], t["warehouse"]
        lo, hi = dt.date(2000, 2, 10), dt.date(2000, 4, 10)
        cut = dt.date(2000, 3, 11)
        m = cs.merge(it[it.i_current_price.between(0.99, 110.99)],
                     left_on="cs_item_sk", right_on="i_item_sk")
        m = m.merge(wh, left_on="cs_warehouse_sk", right_on="w_warehouse_sk")
        m = m.merge(dd[(dd.d_date >= lo) & (dd.d_date <= hi)],
                    left_on="cs_sold_date_sk", right_on="d_date_sk")
        m["sales_before"] = np.where(m.d_date < cut, m.cs_sales_price, 0.0)
        m["sales_after"] = np.where(m.d_date >= cut, m.cs_sales_price, 0.0)
        g = m.groupby(["w_state", "i_item_id"], as_index=False).agg(
            sales_before=("sales_before", "sum"), sales_after=("sales_after", "sum"))
        return g.sort_values(["w_state", "i_item_id"]).head(100).reset_index(drop=True)
    if q == 43:
        st = t["store"]
        m = ss.merge(dd[dd.d_year == 2000], left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(st[st.s_gmt_offset == -5.0], left_on="ss_store_sk", right_on="s_store_sk")
        g = m.groupby(["s_store_name", "s_store_id"], as_index=False).apply(
            lambda x: pd.Series({
                d: x.loc[x.d_day_name == n, "ss_sales_price"].sum()
                if (x.d_day_name == n).any() else np.nan
                for d, n in zip(
                    ["sun_sales", "mon_sales", "tue_sales", "wed_sales",
                     "thu_sales", "fri_sales", "sat_sales"],
                    ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
                     "Friday", "Saturday"])
            }), include_groups=False).reset_index()
        g = g.drop(columns=[c for c in g.columns
                            if str(c).startswith("level") or str(c) == "index"],
                   errors="ignore")
        return g.sort_values(["s_store_name", "s_store_id"]).head(100).reset_index(drop=True)
    if q == 45:
        ws, cu, ca = t["web_sales"], t["customer"], t["customer_address"]
        m = ws.merge(cu, left_on="ws_bill_customer_sk", right_on="c_customer_sk")
        m = m.merge(ca, left_on="c_current_addr_sk", right_on="ca_address_sk")
        m = m.merge(it, left_on="ws_item_sk", right_on="i_item_sk")
        m = m.merge(dd[(dd.d_qoy == 2) & (dd.d_year == 2001)][["d_date_sk"]],
                    left_on="ws_sold_date_sk", right_on="d_date_sk")
        zips = {"85669", "86197", "88274", "83405", "86475", "85392", "85460",
                "80348", "81792"}
        hot_ids = set(it[it.i_item_sk.isin([2, 3, 5, 7, 11, 13, 17, 19, 23, 29])].i_item_id)
        m = m[m.ca_zip.str[:5].isin(zips) | m.i_item_id.isin(hot_ids)]
        g = m.groupby(["ca_zip", "ca_city"], as_index=False).agg(s=("ws_sales_price", "sum"))
        return g.sort_values(["ca_zip", "ca_city"]).head(100).reset_index(drop=True)
    if q == 46:
        cu, ca, st, hd = (t["customer"], t["customer_address"], t["store"],
                          t["household_demographics"])
        m = ss.merge(dd[dd.d_dow.isin([6, 0]) & dd.d_year.isin([1999, 2000, 2001])],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(st[st.s_city.isin(["Fairview", "Midway"])],
                    left_on="ss_store_sk", right_on="s_store_sk")
        m = m.merge(hd[(hd.hd_dep_count == 4) | (hd.hd_vehicle_count == 3)],
                    left_on="ss_hdemo_sk", right_on="hd_demo_sk")
        m = m.merge(ca, left_on="ss_addr_sk", right_on="ca_address_sk")
        dn = m.groupby(["ss_ticket_number", "ss_customer_sk", "ss_addr_sk", "ca_city"],
                       as_index=False).agg(amt=("ss_coupon_amt", "sum"),
                                           profit=("ss_net_profit", "sum"))
        dn = dn.rename(columns={"ca_city": "bought_city"})
        dn = dn.merge(cu, left_on="ss_customer_sk", right_on="c_customer_sk")
        dn = dn.merge(ca, left_on="c_current_addr_sk", right_on="ca_address_sk")
        dn = dn[dn.ca_city != dn.bought_city]
        out = dn[["c_last_name", "c_first_name", "ca_city", "bought_city",
                  "ss_ticket_number", "amt", "profit"]]
        return out.sort_values(["c_last_name", "c_first_name", "ca_city", "bought_city",
                                "ss_ticket_number"]).head(100).reset_index(drop=True)
    if q == 48:
        cd, ca, st = t["customer_demographics"], t["customer_address"], t["store"]
        m = ss.merge(st, left_on="ss_store_sk", right_on="s_store_sk")
        m = m.merge(dd[dd.d_year == 2000], left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(cd, left_on="ss_cdemo_sk", right_on="cd_demo_sk")
        m = m.merge(ca[ca.ca_country == "United States"],
                    left_on="ss_addr_sk", right_on="ca_address_sk")
        c1 = ((m.cd_marital_status == "M") & (m.cd_education_status == "4 yr Degree")
              & m.ss_sales_price.between(100, 150))
        c2 = ((m.cd_marital_status == "D") & (m.cd_education_status == "2 yr Degree")
              & m.ss_sales_price.between(50, 100))
        c3 = ((m.cd_marital_status == "S") & (m.cd_education_status == "College")
              & m.ss_sales_price.between(150, 200))
        g1 = (m.ca_state.isin(["CO", "OH", "TX"]) & m.ss_net_profit.between(0, 2000))
        g2 = (m.ca_state.isin(["OR", "MN", "KY"]) & m.ss_net_profit.between(150, 3000))
        g3 = (m.ca_state.isin(["VA", "CA", "MS"]) & m.ss_net_profit.between(50, 25000))
        m = m[(c1 | c2 | c3) & (g1 | g2 | g3)]
        return pd.DataFrame({"sq": [m.ss_quantity.sum() if len(m) else None]})
    if q == 50:
        sr, st = t["store_returns"], t["store"]
        m = ss.merge(sr, left_on=["ss_ticket_number", "ss_item_sk", "ss_customer_sk"],
                     right_on=["sr_ticket_number", "sr_item_sk", "sr_customer_sk"])
        m = m.merge(dd[(dd.d_year == 2001) & (dd.d_moy == 8)][["d_date_sk"]],
                    left_on="sr_returned_date_sk", right_on="d_date_sk")
        m = m.merge(st, left_on="ss_store_sk", right_on="s_store_sk")
        lag = m.sr_returned_date_sk - m.ss_sold_date_sk
        m["d30"] = (lag <= 30).astype(int)
        m["d31_60"] = ((lag > 30) & (lag <= 60)).astype(int)
        m["d_gt_60"] = (lag > 60).astype(int)
        g = m.groupby(["s_store_name", "s_county"], as_index=False).agg(
            d30=("d30", "sum"), d31_60=("d31_60", "sum"), d_gt_60=("d_gt_60", "sum"))
        return g.sort_values(["s_store_name", "s_county"]).head(100).reset_index(drop=True)
    if q == 61:
        st, pr, cu, ca = t["store"], t["promotion"], t["customer"], t["customer_address"]
        base = ss.merge(dd[(dd.d_year == 1998) & (dd.d_moy == 11)],
                        left_on="ss_sold_date_sk", right_on="d_date_sk")
        base = base.merge(st[st.s_gmt_offset == -5.0], left_on="ss_store_sk",
                          right_on="s_store_sk")
        base = base.merge(cu, left_on="ss_customer_sk", right_on="c_customer_sk")
        base = base.merge(ca[ca.ca_gmt_offset == -5.0], left_on="c_current_addr_sk",
                          right_on="ca_address_sk")
        base = base.merge(it[it.i_category == "Jewelry"], left_on="ss_item_sk",
                          right_on="i_item_sk")
        prf = pr[(pr.p_channel_email == "Y") | (pr.p_channel_event == "Y")]
        promo = base.merge(prf, left_on="ss_promo_sk", right_on="p_promo_sk")
        p_sum = promo.ss_ext_sales_price.sum()
        t_sum = base.ss_ext_sales_price.sum()
        return pd.DataFrame({"promotions": [p_sum], "total": [t_sum],
                             "ratio": [p_sum / t_sum * 100 if t_sum else None]})
    if q == 65:
        st = t["store"]
        m = ss.merge(dd[dd.d_year == 2000][["d_date_sk"]],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
        sc = m.groupby(["ss_store_sk", "ss_item_sk"], as_index=False).agg(
            revenue=("ss_sales_price", "sum"))
        sb = sc.groupby("ss_store_sk", as_index=False).agg(ave=("revenue", "mean"))
        j = sc.merge(sb, on="ss_store_sk")
        j = j[j.revenue <= 0.1 * j.ave]
        j = j.merge(st, left_on="ss_store_sk", right_on="s_store_sk")
        j = j.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
        out = j[["s_store_name", "i_item_desc", "revenue", "i_current_price",
                 "i_wholesale_cost", "i_brand"]]
        return out.sort_values(["s_store_name", "i_item_desc", "revenue"]
                               ).head(100).reset_index(drop=True)
    if q == 79:
        cu, st, hd = t["customer"], t["store"], t["household_demographics"]
        m = ss.merge(dd[(dd.d_dow == 1) & dd.d_year.isin([1999, 2000, 2001])],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(st[st.s_number_employees.between(200, 295)],
                    left_on="ss_store_sk", right_on="s_store_sk")
        m = m.merge(hd[(hd.hd_dep_count == 6) | (hd.hd_vehicle_count > 2)],
                    left_on="ss_hdemo_sk", right_on="hd_demo_sk")
        ms = m.groupby(["ss_ticket_number", "ss_customer_sk", "ss_addr_sk", "s_city"],
                       as_index=False, dropna=False).agg(amt=("ss_coupon_amt", "sum"),
                                                         profit=("ss_net_profit", "sum"))
        ms = ms.merge(cu, left_on="ss_customer_sk", right_on="c_customer_sk")
        ms["city30"] = ms.s_city.str[:30]
        out = ms[["c_last_name", "c_first_name", "city30", "ss_ticket_number",
                  "amt", "profit"]]
        return out.sort_values(["c_last_name", "c_first_name", "city30", "profit",
                                "ss_ticket_number"]).head(100).reset_index(drop=True)
    if q == 88:
        td, st, hd = t["time_dim"], t["store"], t["household_demographics"]
        hdf = hd[((hd.hd_dep_count == 4) & (hd.hd_vehicle_count <= 6))
                 | ((hd.hd_dep_count == 2) & (hd.hd_vehicle_count <= 4))
                 | ((hd.hd_dep_count == 0) & (hd.hd_vehicle_count <= 2))]
        stf = st[st.s_store_name == "store 1"]

        def bucket(hour, half):
            m = ss.merge(td[(td.t_hour == hour)
                            & ((td.t_minute >= 30) if half else (td.t_minute < 30))],
                         left_on="ss_sold_time_sk", right_on="t_time_sk")
            m = m.merge(hdf, left_on="ss_hdemo_sk", right_on="hd_demo_sk")
            m = m.merge(stf, left_on="ss_store_sk", right_on="s_store_sk")
            return len(m)

        return pd.DataFrame({
            "h8_30_to_9": [bucket(8, True)], "h9_to_9_30": [bucket(9, False)],
            "h9_30_to_10": [bucket(9, True)], "h10_to_10_30": [bucket(10, False)],
        })
    if q == 90:
        ws, td, hd, wp = (t["web_sales"], t["time_dim"], t["household_demographics"],
                          t["web_page"])
        hdf = hd[hd.hd_dep_count == 6]
        wpf = wp[wp.wp_char_count.between(5000, 5200)]

        def cnt(h_lo, h_hi):
            m = ws.merge(td[td.t_hour.between(h_lo, h_hi)],
                         left_on="ws_sold_time_sk", right_on="t_time_sk")
            m = m.merge(hdf, left_on="ws_ship_hdemo_sk", right_on="hd_demo_sk")
            m = m.merge(wpf, left_on="ws_web_page_sk", right_on="wp_web_page_sk")
            return len(m)

        amc, pmc = cnt(8, 9), cnt(19, 20)
        return pd.DataFrame({"am_pm_ratio": [amc / pmc if pmc else None]})
    if q == 93:
        sr, rs = t["store_returns"], t["reason"]
        srf = sr.merge(rs[rs.r_reason_desc == "reason 28"],
                       left_on="sr_reason_sk", right_on="r_reason_sk")
        m = ss.merge(srf, left_on=["ss_item_sk", "ss_ticket_number"],
                     right_on=["sr_item_sk", "sr_ticket_number"])
        m["act_sales"] = np.where(m.sr_return_quantity.notna(),
                                  (m.ss_quantity - m.sr_return_quantity) * m.ss_sales_price,
                                  m.ss_quantity * m.ss_sales_price)
        g = m.groupby("ss_customer_sk", as_index=False).agg(sumsales=("act_sales", "sum"))
        return g.sort_values(["sumsales", "ss_customer_sk"]).head(100).reset_index(drop=True)
    if q == 99:
        cs, wh, sm, cc = (t["catalog_sales"], t["warehouse"], t["ship_mode"],
                          t["call_center"])
        m = cs.merge(dd[dd.d_year == 2001][["d_date_sk"]],
                     left_on="cs_ship_date_sk", right_on="d_date_sk")
        m = m.merge(wh, left_on="cs_warehouse_sk", right_on="w_warehouse_sk")
        m = m.merge(sm, left_on="cs_ship_mode_sk", right_on="sm_ship_mode_sk")
        m = m.merge(cc, left_on="cs_call_center_sk", right_on="cc_call_center_sk")
        lag = m.cs_ship_date_sk - m.cs_sold_date_sk
        m["d30"] = (lag <= 30).astype(int)
        m["d31_60"] = ((lag > 30) & (lag <= 60)).astype(int)
        m["d_gt_60"] = (lag > 60).astype(int)
        m["wname"] = m.w_warehouse_name.str[:20]
        g = m.groupby(["wname", "sm_type", "cc_name"], as_index=False).agg(
            d30=("d30", "sum"), d31_60=("d31_60", "sum"), d_gt_60=("d_gt_60", "sum"))
        return g.sort_values(["wname", "sm_type", "cc_name"]).head(100).reset_index(drop=True)
    if q in (1, 30, 81):
        # customer_total_return shape: per-customer returns vs 1.2x the
        # state/store average (correlated scalar subquery over a CTE)
        cu, ca = t["customer"], t["customer_address"]
        if q == 1:
            sr, st = t["store_returns"], t["store"]
            m = sr.merge(dd[dd.d_year == 2000][["d_date_sk"]],
                         left_on="sr_returned_date_sk", right_on="d_date_sk")
            ctr = m.groupby(["sr_customer_sk", "sr_store_sk"], as_index=False).agg(
                ctr_total_return=("sr_return_amt", "sum"))
            avg_grp = ctr.groupby("sr_store_sk")["ctr_total_return"].transform("mean")
            hot = ctr[ctr.ctr_total_return > avg_grp * 1.2]
            hot = hot.merge(st[st.s_state == "TN"][["s_store_sk"]],
                            left_on="sr_store_sk", right_on="s_store_sk")
            hot = hot.merge(cu, left_on="sr_customer_sk", right_on="c_customer_sk")
            return hot[["c_customer_id"]].sort_values("c_customer_id").head(100).reset_index(drop=True)
        if q == 30:
            wr = t["web_returns"]
            m = wr.merge(dd[dd.d_year == 2002][["d_date_sk"]],
                         left_on="wr_returned_date_sk", right_on="d_date_sk")
            m = m.merge(ca[["ca_address_sk", "ca_state"]],
                        left_on="wr_refunded_addr_sk", right_on="ca_address_sk")
            ctr = m.groupby(["wr_returning_customer_sk", "ca_state"], as_index=False).agg(
                ctr_total_return=("wr_return_amt", "sum"))
            cust_col = "wr_returning_customer_sk"
        else:
            cr = t["catalog_returns"]
            m = cr.merge(dd[dd.d_year == 2000][["d_date_sk"]],
                         left_on="cr_returned_date_sk", right_on="d_date_sk")
            m = m.merge(ca[["ca_address_sk", "ca_state"]],
                        left_on="cr_returning_addr_sk", right_on="ca_address_sk")
            ctr = m.groupby(["cr_returning_customer_sk", "ca_state"], as_index=False).agg(
                ctr_total_return=("cr_return_amt", "sum"))
            cust_col = "cr_returning_customer_sk"
        avg_grp = ctr.groupby("ca_state")["ctr_total_return"].transform("mean")
        hot = ctr[ctr.ctr_total_return > avg_grp * 1.2]
        hot = hot.merge(cu, left_on=cust_col, right_on="c_customer_sk")
        hot = hot.merge(ca.add_suffix("_cur"), left_on="c_current_addr_sk",
                        right_on="ca_address_sk_cur")
        hot = hot[hot.ca_state_cur == "GA"]
        if q == 30:
            cols = ["c_customer_id", "c_salutation", "c_first_name", "c_last_name",
                    "c_preferred_cust_flag", "c_birth_day", "c_birth_month",
                    "c_birth_year", "c_birth_country", "c_login", "c_email_address",
                    "ctr_total_return"]
            out = hot[cols]
        else:
            out = pd.DataFrame({
                "c_customer_id": hot.c_customer_id, "c_salutation": hot.c_salutation,
                "c_first_name": hot.c_first_name, "c_last_name": hot.c_last_name,
                "ca_street_number": hot.ca_street_number_cur,
                "ca_street_name": hot.ca_street_name_cur,
                "ca_street_type": hot.ca_street_type_cur,
                "ca_suite_number": hot.ca_suite_number_cur,
                "ca_city": hot.ca_city_cur, "ca_county": hot.ca_county_cur,
                "ca_state": hot.ca_state_cur, "ca_zip": hot.ca_zip_cur,
                "ca_country": hot.ca_country_cur,
                "ca_gmt_offset": hot.ca_gmt_offset_cur,
                "ca_location_type": hot.ca_location_type_cur,
                "ctr_total_return": hot.ctr_total_return})
        return out.sort_values(list(out.columns)).head(100).reset_index(drop=True)
    if q == 17:
        sr, cs, st = t["store_returns"], t["catalog_sales"], t["store"]
        d1 = dd[dd.d_quarter_name == "2001Q1"][["d_date_sk"]]
        d23 = dd[dd.d_quarter_name.isin(["2001Q1", "2001Q2", "2001Q3"])][["d_date_sk"]]
        m = ss.merge(d1, left_on="ss_sold_date_sk", right_on="d_date_sk")
        srx = sr.merge(d23, left_on="sr_returned_date_sk", right_on="d_date_sk")
        m = m.merge(srx, left_on=["ss_customer_sk", "ss_item_sk", "ss_ticket_number"],
                    right_on=["sr_customer_sk", "sr_item_sk", "sr_ticket_number"])
        csx = cs.merge(d23, left_on="cs_sold_date_sk", right_on="d_date_sk")
        m = m.merge(csx, left_on=["sr_customer_sk", "sr_item_sk"],
                    right_on=["cs_bill_customer_sk", "cs_item_sk"])
        m = m.merge(st[["s_store_sk", "s_state"]], left_on="ss_store_sk", right_on="s_store_sk")
        m = m.merge(it[["i_item_sk", "i_item_id", "i_item_desc"]],
                    left_on="ss_item_sk", right_on="i_item_sk")
        g = m.groupby(["i_item_id", "i_item_desc", "s_state"], as_index=False).agg(
            c1=("ss_quantity", "count"), a1=("ss_quantity", "mean"), s1=("ss_quantity", "std"),
            c2=("sr_return_quantity", "count"), a2=("sr_return_quantity", "mean"),
            s2=("sr_return_quantity", "std"),
            c3=("cs_quantity", "count"), a3=("cs_quantity", "mean"), s3=("cs_quantity", "std"))
        for i in (1, 2, 3):
            g[f"cov{i}"] = g[f"s{i}"] / g[f"a{i}"]
        out = g[["i_item_id", "i_item_desc", "s_state", "c1", "a1", "s1", "cov1",
                 "c2", "a2", "s2", "cov2", "c3", "a3", "s3", "cov3"]]
        return out.sort_values(["i_item_id", "i_item_desc", "s_state"]).head(100).reset_index(drop=True)
    if q == 21:
        inv, wh = t["inventory"], t["warehouse"]
        dsel = dd[(dd.d_date >= dt.date(2000, 2, 10)) & (dd.d_date <= dt.date(2000, 4, 10))]
        m = inv.merge(dsel[["d_date_sk", "d_date"]], left_on="inv_date_sk", right_on="d_date_sk")
        m = m.merge(it[(it.i_current_price >= 0.99) & (it.i_current_price <= 29.49)][
            ["i_item_sk", "i_item_id"]], left_on="inv_item_sk", right_on="i_item_sk")
        m = m.merge(wh[["w_warehouse_sk", "w_warehouse_name"]],
                    left_on="inv_warehouse_sk", right_on="w_warehouse_sk")
        pivot = dt.date(2000, 3, 11)
        m["before"] = np.where([d < pivot for d in m.d_date], m.inv_quantity_on_hand, 0)
        m["after"] = np.where([d >= pivot for d in m.d_date], m.inv_quantity_on_hand, 0)
        g = m.groupby(["w_warehouse_name", "i_item_id"], as_index=False).agg(
            inv_before=("before", "sum"), inv_after=("after", "sum"))
        ratio = np.where(g.inv_before > 0,
                         g.inv_after / np.where(g.inv_before > 0, g.inv_before, 1), np.nan)
        g = g[(ratio >= 2.0 / 3.0) & (ratio <= 1.5)]
        return g.sort_values(["w_warehouse_name", "i_item_id"]).head(100).reset_index(drop=True)
    if q == 22:
        inv = t["inventory"]
        dsel = dd[(dd.d_month_seq >= 1200) & (dd.d_month_seq <= 1211)][["d_date_sk"]]
        m = inv.merge(dsel, left_on="inv_date_sk", right_on="d_date_sk")
        m = m.merge(it, left_on="inv_item_sk", right_on="i_item_sk")
        cols = ["i_product_name", "i_brand", "i_class", "i_category"]
        out = _rollup(m, cols, "inv_quantity_on_hand", "mean").drop(
            columns=["lochierarchy"]).rename(columns={"inv_quantity_on_hand": "qoh"})
        out = out[cols + ["qoh"]]
        return out.sort_values(["qoh"] + cols, na_position="last").head(100).reset_index(drop=True)
    if q == 39:
        inv, wh = t["inventory"], t["warehouse"]
        m = inv.merge(dd[dd.d_year == 2001][["d_date_sk", "d_moy"]],
                      left_on="inv_date_sk", right_on="d_date_sk")
        m = m.merge(it[["i_item_sk"]], left_on="inv_item_sk", right_on="i_item_sk")
        m = m.merge(wh[["w_warehouse_sk", "w_warehouse_name"]],
                    left_on="inv_warehouse_sk", right_on="w_warehouse_sk")
        g = m.groupby(["w_warehouse_name", "w_warehouse_sk", "i_item_sk", "d_moy"],
                      as_index=False).agg(stdev=("inv_quantity_on_hand", "std"),
                                          mean=("inv_quantity_on_hand", "mean"))
        sel = np.where(g["mean"] == 0, 0.0, g.stdev / g["mean"]) > 1
        g = g[sel].copy()
        g["cov"] = np.where(g["mean"] == 0, np.nan, g.stdev / g["mean"])
        j = g[g.d_moy == 1].merge(g[g.d_moy == 2], on=["i_item_sk", "w_warehouse_sk"],
                                  suffixes=("_1", "_2"))
        out = pd.DataFrame({
            "wsk1": j.w_warehouse_sk, "isk1": j.i_item_sk, "moy1": j.d_moy_1,
            "mean1": j.mean_1, "cov1": j.cov_1,
            "wsk2": j.w_warehouse_sk, "isk2": j.i_item_sk, "moy2": j.d_moy_2,
            "mean2": j.mean_2, "cov2": j.cov_2})
        return out.sort_values(list(out.columns)).reset_index(drop=True)
    if q == 62:
        ws, wh, sm, web = t["web_sales"], t["warehouse"], t["ship_mode"], t["web_site"]
        m = ws.merge(dd[dd.d_year == 2001][["d_date_sk"]],
                     left_on="ws_ship_date_sk", right_on="d_date_sk")
        m = m.merge(wh, left_on="ws_warehouse_sk", right_on="w_warehouse_sk")
        m = m.merge(sm, left_on="ws_ship_mode_sk", right_on="sm_ship_mode_sk")
        m = m.merge(web, left_on="ws_web_site_sk", right_on="web_site_sk")
        lag = m.ws_ship_date_sk - m.ws_sold_date_sk
        m["d30"] = (lag <= 30).astype(int)
        m["d31_60"] = ((lag > 30) & (lag <= 60)).astype(int)
        m["d_gt_60"] = (lag > 60).astype(int)
        m["wname"] = m.w_warehouse_name.str[:20]
        g = m.groupby(["wname", "sm_type", "web_name"], as_index=False).agg(
            d30=("d30", "sum"), d31_60=("d31_60", "sum"), d_gt_60=("d_gt_60", "sum"))
        return g.sort_values(["wname", "sm_type", "web_name"]).head(100).reset_index(drop=True)
    if q == 86:
        ws = t["web_sales"]
        dsel = dd[(dd.d_month_seq >= 1200) & (dd.d_month_seq <= 1211)][["d_date_sk"]]
        m = ws.merge(dsel, left_on="ws_sold_date_sk", right_on="d_date_sk")
        m = m.merge(it, left_on="ws_item_sk", right_on="i_item_sk")
        out = _rollup(m, ["i_category", "i_class"], "ws_net_paid", "sum").rename(
            columns={"ws_net_paid": "total_sum"})
        out["rank_within_parent"] = out.groupby("lochierarchy")["total_sum"].rank(
            method="min", ascending=False).astype(int)
        out = out.sort_values(["lochierarchy", "i_category", "i_class"],
                              ascending=[False, True, True], na_position="last")
        return out[["total_sum", "i_category", "i_class", "lochierarchy",
                    "rank_within_parent"]].head(100).reset_index(drop=True)
    if q == 91:
        cc, cr, cu = t["call_center"], t["catalog_returns"], t["customer"]
        ca, cd, hd = t["customer_address"], t["customer_demographics"], t["household_demographics"]
        m = cr.merge(cc, left_on="cr_call_center_sk", right_on="cc_call_center_sk")
        m = m.merge(dd[dd.d_year == 1998][["d_date_sk"]],
                    left_on="cr_returned_date_sk", right_on="d_date_sk")
        m = m.merge(cu, left_on="cr_returning_customer_sk", right_on="c_customer_sk")
        cdf = cd[((cd.cd_marital_status == "M") & (cd.cd_education_status == "Unknown"))
                 | ((cd.cd_marital_status == "W") & (cd.cd_education_status == "Advanced Degree"))]
        m = m.merge(cdf, left_on="c_current_cdemo_sk", right_on="cd_demo_sk")
        m = m.merge(hd[hd.hd_buy_potential.str.startswith("Unknown")],
                    left_on="c_current_hdemo_sk", right_on="hd_demo_sk")
        m = m.merge(ca[ca.ca_gmt_offset == -7], left_on="c_current_addr_sk",
                    right_on="ca_address_sk")
        g = m.groupby(["cc_call_center_id", "cc_name", "cc_manager",
                       "cd_marital_status", "cd_education_status"], as_index=False).agg(
            returns_loss=("cr_net_loss", "sum"))
        out = g[["cc_call_center_id", "cc_name", "cc_manager", "returns_loss"]]
        return out.sort_values("returns_loss", ascending=False).reset_index(drop=True)
    if q in (47, 57):
        # month-over-month outliers: windowed year-avg + lag/lead via rank
        # self-joins on a CTE
        dsel = dd[(dd.d_year == 1999) | ((dd.d_year == 1998) & (dd.d_moy == 12))
                  | ((dd.d_year == 2000) & (dd.d_moy == 1))][["d_date_sk", "d_year", "d_moy"]]
        if q == 47:
            st = t["store"]
            m = ss.merge(dsel, left_on="ss_sold_date_sk", right_on="d_date_sk")
            m = m.merge(it[["i_item_sk", "i_category", "i_brand"]],
                        left_on="ss_item_sk", right_on="i_item_sk")
            m = m.merge(st[["s_store_sk", "s_store_name", "s_company_name"]],
                        left_on="ss_store_sk", right_on="s_store_sk")
            keys, val = ["i_category", "i_brand", "s_store_name", "s_company_name"], "ss_sales_price"
            tie = ["s_store_name", "i_category", "i_brand", "s_company_name", "d_year", "d_moy"]
        else:
            cc = t["call_center"]
            m = t["catalog_sales"].merge(dsel, left_on="cs_sold_date_sk", right_on="d_date_sk")
            m = m.merge(it[["i_item_sk", "i_category", "i_brand"]],
                        left_on="cs_item_sk", right_on="i_item_sk")
            m = m.merge(cc[["cc_call_center_sk", "cc_name"]],
                        left_on="cs_call_center_sk", right_on="cc_call_center_sk")
            keys, val = ["i_category", "i_brand", "cc_name"], "cs_sales_price"
            tie = ["cc_name", "i_category", "i_brand", "d_year", "d_moy"]
        g = m.groupby(keys + ["d_year", "d_moy"], as_index=False).agg(sum_sales=(val, "sum"))
        g["avg_monthly_sales"] = g.groupby(keys + ["d_year"])["sum_sales"].transform("mean")
        g = g.sort_values(keys + ["d_year", "d_moy"]).reset_index(drop=True)
        g["rn"] = g.groupby(keys).cumcount() + 1
        lagd = g[keys + ["rn", "sum_sales"]].rename(columns={"sum_sales": "psum"})
        lagd = lagd.assign(rn=lagd.rn + 1)
        leadd = g[keys + ["rn", "sum_sales"]].rename(columns={"sum_sales": "nsum"})
        leadd = leadd.assign(rn=leadd.rn - 1)
        j = g.merge(lagd, on=keys + ["rn"]).merge(leadd, on=keys + ["rn"])
        j = j[(j.d_year == 1999) & (j.avg_monthly_sales > 0)]
        rel = np.abs(j.sum_sales - j.avg_monthly_sales) / j.avg_monthly_sales
        j = j[rel > 0.1].copy()
        j["_diff"] = j.sum_sales - j.avg_monthly_sales
        cols = keys + ["d_year", "d_moy", "avg_monthly_sales", "sum_sales", "psum", "nsum"]
        return j.sort_values(["_diff"] + tie).head(100)[cols].reset_index(drop=True)
    if q in (53, 63):
        st = t["store"]
        key, per = ("i_manufact_id", "d_qoy") if q == 53 else ("i_manager_id", "d_moy")
        m = ss.merge(dd[(dd.d_month_seq >= 1200) & (dd.d_month_seq <= 1211)][
            ["d_date_sk", per]], left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(st[["s_store_sk"]], left_on="ss_store_sk", right_on="s_store_sk")
        m = m.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
        sel = ((m.i_category.isin(["Books", "Children", "Electronics"])
                & m.i_class.isin(["class#1", "class#2", "class#3"]))
               | (m.i_category.isin(["Women", "Music", "Men"])
                  & m.i_class.isin(["class#4", "class#5", "class#6"])))
        m = m[sel]
        g = m.groupby([key, per], as_index=False).agg(sum_sales=("ss_sales_price", "sum"))
        g["avg_s"] = g.groupby(key)["sum_sales"].transform("mean")
        g = g[np.where(g.avg_s > 0, np.abs(g.sum_sales - g.avg_s) / g.avg_s, np.nan) > 0.1]
        out = g[[key, "sum_sales", "avg_s"]]
        order = (["avg_s", "sum_sales", key] if q == 53 else [key, "avg_s", "sum_sales"])
        return out.sort_values(order).head(100).reset_index(drop=True)
    if q == 89:
        st = t["store"]
        m = ss.merge(dd[dd.d_year == 1999][["d_date_sk", "d_moy"]],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(st[["s_store_sk", "s_store_name", "s_company_name"]],
                    left_on="ss_store_sk", right_on="s_store_sk")
        m = m.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
        sel = ((m.i_category.isin(["Books", "Electronics", "Sports"])
                & m.i_class.isin(["class#1", "class#2", "class#3"]))
               | (m.i_category.isin(["Men", "Jewelry", "Women"])
                  & m.i_class.isin(["class#4", "class#5", "class#6"])))
        m = m[sel]
        keys = ["i_category", "i_class", "i_brand", "s_store_name", "s_company_name"]
        g = m.groupby(keys + ["d_moy"], as_index=False).agg(sum_sales=("ss_sales_price", "sum"))
        # the window partition deliberately OMITS i_class (official shape):
        # a brand's average spans its classes
        g["avg_monthly_sales"] = g.groupby(
            ["i_category", "i_brand", "s_store_name", "s_company_name"]
        )["sum_sales"].transform("mean")
        g = g[np.where(g.avg_monthly_sales != 0,
                       np.abs(g.sum_sales - g.avg_monthly_sales) / g.avg_monthly_sales,
                       np.nan) > 0.1].copy()
        g["_diff"] = g.sum_sales - g.avg_monthly_sales
        out = g.sort_values(["_diff", "s_store_name", "i_category", "i_class",
                             "i_brand", "s_company_name", "d_moy"]).head(100)
        return out[["i_category", "i_class", "i_brand", "s_store_name",
                    "s_company_name", "d_moy", "sum_sales",
                    "avg_monthly_sales"]].reset_index(drop=True)
    if q == 59:
        st = t["store"]
        m = ss.merge(dd[["d_date_sk", "d_week_seq", "d_day_name"]],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
        days = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday"]
        dcols = ["sun", "mon", "tue", "wed", "thu", "fri", "sat"]
        for day, c in zip(days, dcols):
            m[c] = np.where(m.d_day_name == day, m.ss_sales_price, np.nan)
        wss = m.groupby(["d_week_seq", "ss_store_sk"], as_index=False)[dcols].sum(min_count=1)

        def leg(lo, hi):
            weeks = dd[(dd.d_month_seq >= lo) & (dd.d_month_seq <= hi)][["d_week_seq"]]
            x = wss.merge(weeks, on="d_week_seq")  # replicated per matching day, like the SQL
            return x.merge(st[["s_store_sk", "s_store_name", "s_store_id"]],
                           left_on="ss_store_sk", right_on="s_store_sk")

        y = leg(1188, 1199).copy()
        x2 = leg(1200, 1211).copy()
        x2["wk_minus_52"] = x2.d_week_seq - 52
        j = y.merge(x2, left_on=["s_store_id", "d_week_seq"],
                    right_on=["s_store_id", "wk_minus_52"], suffixes=("_1", "_2"))
        out = pd.DataFrame({
            "s_store_name1": j.s_store_name_1, "s_store_id1": j.s_store_id,
            "d_week_seq1": j.d_week_seq_1,
            **{f"r_{c}": j[f"{c}_1"] / j[f"{c}_2"] for c in dcols}})
        return out.sort_values(["s_store_name1", "s_store_id1", "d_week_seq1"]
                               ).head(100).reset_index(drop=True)
    if q == 67:
        st = t["store"]
        m = ss.merge(dd[(dd.d_month_seq >= 1200) & (dd.d_month_seq <= 1211)][
            ["d_date_sk", "d_year", "d_qoy", "d_moy"]],
            left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(st[["s_store_sk", "s_store_id"]], left_on="ss_store_sk",
                    right_on="s_store_sk")
        m = m.merge(it[["i_item_sk", "i_category", "i_class", "i_brand", "i_product_name"]],
                    left_on="ss_item_sk", right_on="i_item_sk")
        m["val"] = (m.ss_sales_price * m.ss_quantity).fillna(0)
        cols = ["i_category", "i_class", "i_brand", "i_product_name", "d_year",
                "d_qoy", "d_moy", "s_store_id"]
        outp = _rollup(m, cols, "val", "sum").drop(columns=["lochierarchy"]).rename(
            columns={"val": "sumsales"})
        outp["rk"] = outp.groupby(outp.i_category.fillna("\x00null"))["sumsales"].rank(
            method="min", ascending=False).astype(int)
        outp = outp[outp.rk <= 100]
        return outp.sort_values(cols + ["sumsales", "rk"], na_position="last"
                                ).head(100).reset_index(drop=True)
    if q == 70:
        st = t["store"]
        m = ss.merge(dd[(dd.d_month_seq >= 1200) & (dd.d_month_seq <= 1211)][["d_date_sk"]],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(st[["s_store_sk", "s_state", "s_county"]],
                    left_on="ss_store_sk", right_on="s_store_sk")
        # inner ranking partitions by its own group key, so every state ranks 1
        out = _rollup(m, ["s_state", "s_county"], "ss_net_profit", "sum").rename(
            columns={"ss_net_profit": "total_sum"})
        out["rank_within_parent"] = out.groupby("lochierarchy")["total_sum"].rank(
            method="min", ascending=False).astype(int)
        out = out.sort_values(["lochierarchy", "s_state", "s_county"],
                              ascending=[False, True, True], na_position="last")
        return out[["total_sum", "s_state", "s_county", "lochierarchy",
                    "rank_within_parent"]].head(100).reset_index(drop=True)
    if q == 71:
        td = t["time_dim"]
        frames = []
        for fact, pfx in ((t["web_sales"], "ws"), (t["catalog_sales"], "cs"), (ss, "ss")):
            mm = fact.merge(dd[(dd.d_moy == 11) & (dd.d_year == 1999)][["d_date_sk"]],
                            left_on=f"{pfx}_sold_date_sk", right_on="d_date_sk")
            frames.append(pd.DataFrame({
                "ext_price": mm[f"{pfx}_ext_sales_price"],
                "sold_item_sk": mm[f"{pfx}_item_sk"],
                "time_sk": mm[f"{pfx}_sold_time_sk"]}))
        u = pd.concat(frames, ignore_index=True)
        u = u.merge(it[it.i_manager_id == 1][["i_item_sk", "i_brand_id", "i_brand"]],
                    left_on="sold_item_sk", right_on="i_item_sk")
        u = u.merge(td[td.t_meal_time.isin(["breakfast", "dinner"])][
            ["t_time_sk", "t_hour", "t_minute"]], left_on="time_sk", right_on="t_time_sk")
        g = u.groupby(["i_brand", "i_brand_id", "t_hour", "t_minute"], as_index=False).agg(
            ext_price=("ext_price", "sum"))
        out = g[["i_brand_id", "i_brand", "t_hour", "t_minute", "ext_price"]]
        return out.sort_values(["ext_price", "i_brand_id", "t_hour", "t_minute"],
                               ascending=[False, True, True, True]).reset_index(drop=True)
    if q == 8:
        ca, cu, st = t["customer_address"], t["customer"], t["store"]
        zips = {"24000", "24050", "24100", "24150", "24200", "24250", "24300",
                "24350", "24400", "24450", "24500", "24550", "24010", "24060",
                "24110", "24160", "24210", "24260", "24310", "24360", "24410",
                "24460", "24510", "24560"}
        s1 = set(ca.ca_zip.str[:5][ca.ca_zip.str[:5].isin(zips)])
        pref = ca.merge(cu[cu.c_preferred_cust_flag == "Y"],
                        left_on="ca_address_sk", right_on="c_current_addr_sk")
        cnt = pref.groupby(pref.ca_zip.str[:5]).size()
        sel = sorted(s1 & set(cnt[cnt > 10].index))
        vz = pd.DataFrame({"ca_zip": sel})
        vz["p2"] = vz.ca_zip.str[:2]
        m = ss.merge(dd[(dd.d_qoy == 2) & (dd.d_year == 1998)][["d_date_sk"]],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(st[["s_store_sk", "s_store_name", "s_zip"]],
                    left_on="ss_store_sk", right_on="s_store_sk")
        m["p2"] = m.s_zip.str[:2]
        m = m.merge(vz, on="p2")  # row multiplication per matching zip, like the SQL
        g = m.groupby("s_store_name", as_index=False)["ss_net_profit"].sum()
        return g.sort_values("s_store_name").head(100).reset_index(drop=True)
    if q in (10, 35, 69):
        cu, ca, cd = t["customer"], t["customer_address"], t["customer_demographics"]
        if q == 10:
            dfilt = (dd.d_year == 2002) & dd.d_moy.between(1, 4)
        elif q == 35:
            dfilt = (dd.d_year == 2002) & (dd.d_qoy < 4)
        else:
            dfilt = (dd.d_year == 2001) & dd.d_moy.between(4, 6)
        dsel = dd[dfilt][["d_date_sk"]]

        def bought(fact, dkey, ckey):
            mm = fact.merge(dsel, left_on=dkey, right_on="d_date_sk")
            return set(mm[ckey].dropna())

        sset = bought(ss, "ss_sold_date_sk", "ss_customer_sk")
        wset = bought(t["web_sales"], "ws_sold_date_sk", "ws_bill_customer_sk")
        cset = bought(t["catalog_sales"], "cs_sold_date_sk", "cs_bill_customer_sk")
        m = cu.merge(ca, left_on="c_current_addr_sk", right_on="ca_address_sk")
        m = m.merge(cd, left_on="c_current_cdemo_sk", right_on="cd_demo_sk")
        if q == 10:
            m = m[m.ca_county.isin(["Williamson County", "Walker County",
                                    "Ziebach County", "Daviess County", "Barrow County"])]
        if q == 69:
            m = m[m.ca_state.isin(["TN", "TX", "SD"])]
            keep = (m.c_customer_sk.isin(sset) & ~m.c_customer_sk.isin(wset)
                    & ~m.c_customer_sk.isin(cset))
        else:
            keep = m.c_customer_sk.isin(sset) & (m.c_customer_sk.isin(wset)
                                                 | m.c_customer_sk.isin(cset))
        m = m[keep]
        if q == 35:
            keys = ["ca_state", "cd_gender", "cd_marital_status", "cd_dep_count",
                    "cd_dep_employed_count", "cd_dep_college_count"]
            g = m.groupby(keys, as_index=False).size().rename(columns={"size": "cnt"})
            out = pd.DataFrame({
                "ca_state": g.ca_state, "cd_gender": g.cd_gender,
                "cd_marital_status": g.cd_marital_status,
                "cd_dep_count": g.cd_dep_count, "cnt1": g.cnt,
                "avg1": g.cd_dep_count.astype(float), "max1": g.cd_dep_count,
                "sum1": g.cd_dep_count * g.cnt,
                "cd_dep_employed_count": g.cd_dep_employed_count, "cnt2": g.cnt,
                "avg2": g.cd_dep_employed_count.astype(float),
                "max2": g.cd_dep_employed_count,
                "sum2": g.cd_dep_employed_count * g.cnt,
                "cd_dep_college_count": g.cd_dep_college_count, "cnt3": g.cnt,
                "avg3": g.cd_dep_college_count.astype(float),
                "max3": g.cd_dep_college_count,
                "sum3": g.cd_dep_college_count * g.cnt})
            return out.sort_values(keys).head(100).reset_index(drop=True)
        if q == 10:
            keys = ["cd_gender", "cd_marital_status", "cd_education_status",
                    "cd_purchase_estimate", "cd_credit_rating", "cd_dep_count",
                    "cd_dep_employed_count", "cd_dep_college_count"]
            g = m.groupby(keys, as_index=False).size().rename(columns={"size": "cnt"})
            out = pd.DataFrame({
                "cd_gender": g.cd_gender, "cd_marital_status": g.cd_marital_status,
                "cd_education_status": g.cd_education_status, "cnt1": g.cnt,
                "cd_purchase_estimate": g.cd_purchase_estimate, "cnt2": g.cnt,
                "cd_credit_rating": g.cd_credit_rating, "cnt3": g.cnt,
                "cd_dep_count": g.cd_dep_count, "cnt4": g.cnt,
                "cd_dep_employed_count": g.cd_dep_employed_count, "cnt5": g.cnt,
                "cd_dep_college_count": g.cd_dep_college_count, "cnt6": g.cnt})
            return out.sort_values(keys).head(100).reset_index(drop=True)
        keys = ["cd_gender", "cd_marital_status", "cd_education_status",
                "cd_purchase_estimate", "cd_credit_rating"]
        g = m.groupby(keys, as_index=False).size().rename(columns={"size": "cnt"})
        out = pd.DataFrame({
            "cd_gender": g.cd_gender, "cd_marital_status": g.cd_marital_status,
            "cd_education_status": g.cd_education_status, "cnt1": g.cnt,
            "cd_purchase_estimate": g.cd_purchase_estimate, "cnt2": g.cnt,
            "cd_credit_rating": g.cd_credit_rating, "cnt3": g.cnt})
        return out.sort_values(keys).head(100).reset_index(drop=True)
    if q == 23:
        cu = t["customer"]
        years = [1999, 2000, 2001, 2002]
        m = ss.merge(dd[dd.d_year.isin(years)][["d_date_sk", "d_date"]],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(it[["i_item_sk", "i_item_desc"]], left_on="ss_item_sk",
                    right_on="i_item_sk")
        m["itemdesc"] = m.i_item_desc.str[:30]
        fcnt = m.groupby(["itemdesc", "i_item_sk", "d_date"]).size()
        freq_items = set(fcnt[fcnt > 4].reset_index().i_item_sk)
        m2 = ss.merge(dd[dd.d_year.isin(years)][["d_date_sk"]],
                      left_on="ss_sold_date_sk", right_on="d_date_sk")
        m2 = m2.merge(cu[["c_customer_sk"]], left_on="ss_customer_sk",
                      right_on="c_customer_sk")
        m2["v"] = m2.ss_quantity * m2.ss_sales_price
        cmax = m2.groupby("c_customer_sk")["v"].sum().max()
        allm = ss.merge(cu[["c_customer_sk"]], left_on="ss_customer_sk",
                        right_on="c_customer_sk")
        allm["v"] = allm.ss_quantity * allm.ss_sales_price
        ssales = allm.groupby("c_customer_sk")["v"].sum()
        best = set(ssales[ssales > 0.5 * cmax].index)
        dsel = dd[(dd.d_year == 2000) & (dd.d_moy == 2)][["d_date_sk"]]
        total, n = 0.0, 0
        for fact, pfx in ((t["catalog_sales"], "cs"), (t["web_sales"], "ws")):
            mm = fact.merge(dsel, left_on=f"{pfx}_sold_date_sk", right_on="d_date_sk")
            mm = mm[mm[f"{pfx}_item_sk"].isin(freq_items)
                    & mm[f"{pfx}_bill_customer_sk"].isin(best)]
            total += (mm[f"{pfx}_quantity"] * mm[f"{pfx}_list_price"]).sum()
            n += len(mm)
        return pd.DataFrame({"sum_sales": [total if n else None]})
    if q in (38, 87):
        cu = t["customer"]
        dsel = dd[(dd.d_month_seq >= 1200) & (dd.d_month_seq <= 1211)][
            ["d_date_sk", "d_date"]]

        def chan(fact, dkey, ckey):
            mm = fact.merge(dsel, left_on=dkey, right_on="d_date_sk")
            mm = mm.merge(cu[["c_customer_sk", "c_last_name", "c_first_name"]],
                          left_on=ckey, right_on="c_customer_sk")
            return set(map(tuple, mm[["c_last_name", "c_first_name", "d_date"]]
                           .drop_duplicates().values))

        a = chan(ss, "ss_sold_date_sk", "ss_customer_sk")
        b = chan(t["catalog_sales"], "cs_sold_date_sk", "cs_bill_customer_sk")
        c = chan(t["web_sales"], "ws_sold_date_sk", "ws_bill_customer_sk")
        n = len(a & b & c) if q == 38 else len(a - b - c)
        return pd.DataFrame({"cnt": [n]})
    if q == 76:
        frames = []
        for fact, pfx, nullcol, label in (
            (ss, "ss", "ss_addr_sk", "store"),
            (t["web_sales"], "ws", "ws_ship_customer_sk", "web"),
            (t["catalog_sales"], "cs", "cs_ship_addr_sk", "catalog"),
        ):
            selr = fact[fact[nullcol].isna()]
            mm = selr.merge(dd[["d_date_sk", "d_year", "d_qoy"]],
                            left_on=f"{pfx}_sold_date_sk", right_on="d_date_sk")
            mm = mm.merge(it[["i_item_sk", "i_category"]],
                          left_on=f"{pfx}_item_sk", right_on="i_item_sk")
            frames.append(pd.DataFrame({
                "channel": label, "col_name": nullcol, "d_year": mm.d_year,
                "d_qoy": mm.d_qoy, "i_category": mm.i_category,
                "ext": mm[f"{pfx}_ext_sales_price"]}))
        u = pd.concat(frames, ignore_index=True)
        g = u.groupby(["channel", "col_name", "d_year", "d_qoy", "i_category"],
                      as_index=False).agg(sales_cnt=("ext", "size"),
                                          sales_amt=("ext", "sum"))
        return g.sort_values(["channel", "col_name", "d_year", "d_qoy",
                              "i_category"]).head(100).reset_index(drop=True)
    if q == 97:
        cs = t["catalog_sales"]
        dsel = dd[(dd.d_month_seq >= 1200) & (dd.d_month_seq <= 1211)][["d_date_sk"]]
        a = ss.merge(dsel, left_on="ss_sold_date_sk", right_on="d_date_sk")[
            ["ss_customer_sk", "ss_item_sk"]].drop_duplicates()
        b = cs.merge(dsel, left_on="cs_sold_date_sk", right_on="d_date_sk")[
            ["cs_bill_customer_sk", "cs_item_sk"]].drop_duplicates()
        j = a.merge(b, left_on=["ss_customer_sk", "ss_item_sk"],
                    right_on=["cs_bill_customer_sk", "cs_item_sk"],
                    how="outer", indicator=True)
        return pd.DataFrame({
            "store_only": [int((j._merge == "left_only").sum())],
            "catalog_only": [int((j._merge == "right_only").sum())],
            "store_and_catalog": [int((j._merge == "both").sum())]})
    if q in (16, 94, 95):
        ca = t["customer_address"]
        if q == 16:
            fact, pfx = t["catalog_sales"], "cs"
            rets, rkey = t["catalog_returns"], "cr_order_number"
            lo, hi = dt.date(2000, 2, 1), dt.date(2000, 4, 2)
            m = fact.merge(dd[(dd.d_date >= lo) & (dd.d_date <= hi)][["d_date_sk"]],
                           left_on="cs_ship_date_sk", right_on="d_date_sk")
            m = m.merge(ca[ca.ca_state == "GA"][["ca_address_sk"]],
                        left_on="cs_ship_addr_sk", right_on="ca_address_sk")
            cc = t["call_center"]
            m = m.merge(cc[cc.cc_county.isin(["Williamson County", "Walker County",
                                              "Ziebach County"])][["cc_call_center_sk"]],
                        left_on="cs_call_center_sk", right_on="cc_call_center_sk")
        else:
            fact, pfx = t["web_sales"], "ws"
            rets, rkey = t["web_returns"], "wr_order_number"
            lo, hi = dt.date(1999, 2, 1), dt.date(1999, 4, 2)
            m = fact.merge(dd[(dd.d_date >= lo) & (dd.d_date <= hi)][["d_date_sk"]],
                           left_on="ws_ship_date_sk", right_on="d_date_sk")
            m = m.merge(ca[ca.ca_state == "TX"][["ca_address_sk"]],
                        left_on="ws_ship_addr_sk", right_on="ca_address_sk")
            web = t["web_site"]
            m = m.merge(web[web.web_company_name == "pri"][["web_site_sk"]],
                        left_on="ws_web_site_sk", right_on="web_site_sk")
        onum, wh = f"{pfx}_order_number", f"{pfx}_warehouse_sk"
        wh_counts = fact.groupby(onum)[wh].nunique()
        multi = set(wh_counts[wh_counts > 1].index)
        returned = set(rets[rkey])
        if q == 95:
            m = m[m[onum].isin(multi) & m[onum].isin(returned & multi)]
        else:
            m = m[m[onum].isin(multi) & ~m[onum].isin(returned)]
        return pd.DataFrame({
            "order_count": [int(m[onum].nunique())],
            "total_shipping_cost": [m[f"{pfx}_ext_ship_cost"].sum() if len(m) else None],
            "total_net_profit": [m[f"{pfx}_net_profit"].sum() if len(m) else None]})
    if q == 28:
        buckets = [
            ((0, 5), (8, 18), (459, 1459), (57, 77)),
            ((6, 10), (90, 100), (2323, 3323), (31, 51)),
            ((11, 15), (142, 152), (12214, 13214), (79, 99)),
            ((16, 20), (135, 145), (6071, 7071), (38, 58)),
            ((21, 25), (122, 132), (836, 1836), (17, 37)),
            ((26, 30), (154, 164), (7326, 8326), (7, 27)),
        ]
        vals = {}
        for i, (qt, lp, cp, wc) in enumerate(buckets, 1):
            b = ss[ss.ss_quantity.between(*qt)
                   & (ss.ss_list_price.between(*lp)
                      | ss.ss_coupon_amt.between(*cp)
                      | ss.ss_wholesale_cost.between(*wc))]
            vals[f"b{i}_lp"] = [b.ss_list_price.mean() if len(b) else None]
            vals[f"b{i}_cnt"] = [int(b.ss_list_price.count())]
            vals[f"b{i}_cntd"] = [int(b.ss_list_price.nunique())]
        return pd.DataFrame(vals)
    if q == 2:
        frames = []
        for fact, pfx in ((t["web_sales"], "ws"), (t["catalog_sales"], "cs")):
            frames.append(pd.DataFrame({
                "sold_date_sk": fact[f"{pfx}_sold_date_sk"],
                "sales_price": fact[f"{pfx}_ext_sales_price"]}))
        u = pd.concat(frames, ignore_index=True)
        m = u.merge(dd[["d_date_sk", "d_week_seq", "d_day_name"]],
                    left_on="sold_date_sk", right_on="d_date_sk")
        days = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday"]
        dcols = ["sun", "mon", "tue", "wed", "thu", "fri", "sat"]
        for day, c in zip(days, dcols):
            m[c] = np.where(m.d_day_name == day, m.sales_price, np.nan)
        wss = m.groupby("d_week_seq", as_index=False)[dcols].sum(min_count=1)

        def leg(year):
            weeks = dd[dd.d_year == year][["d_week_seq"]]
            return wss.merge(weeks, on="d_week_seq")  # per-day dup, like the SQL

        y = leg(1999)
        z = leg(2000).copy()
        z["wk_minus"] = z.d_week_seq - 53
        j = y.merge(z, left_on="d_week_seq", right_on="wk_minus", suffixes=("_1", "_2"))
        out = pd.DataFrame({"d_week_seq1": j.d_week_seq_1,
                            **{f"r_{c}": np.round(j[f"{c}_1"] / j[f"{c}_2"], 2)
                               for c in dcols}})
        return out.sort_values("d_week_seq1").reset_index(drop=True)
    if q == 18:
        cs, cd, cu, ca = (t["catalog_sales"], t["customer_demographics"],
                          t["customer"], t["customer_address"])
        m = cs.merge(dd[dd.d_year == 1998][["d_date_sk"]],
                     left_on="cs_sold_date_sk", right_on="d_date_sk")
        m = m.merge(it[["i_item_sk", "i_item_id"]], left_on="cs_item_sk",
                    right_on="i_item_sk")
        cd1 = cd[(cd.cd_gender == "F") & (cd.cd_education_status == "Unknown")]
        m = m.merge(cd1[["cd_demo_sk", "cd_dep_count"]],
                    left_on="cs_bill_cdemo_sk", right_on="cd_demo_sk")
        m = m.merge(cu[cu.c_birth_month.isin([1, 6, 8, 9, 12, 2])][
            ["c_customer_sk", "c_current_cdemo_sk", "c_current_addr_sk", "c_birth_year"]],
            left_on="cs_bill_customer_sk", right_on="c_customer_sk")
        m = m.merge(cd[["cd_demo_sk"]].rename(columns={"cd_demo_sk": "cd2_sk"}),
                    left_on="c_current_cdemo_sk", right_on="cd2_sk")
        m = m.merge(ca[ca.ca_state.isin(["MT", "CA", "NY"])][
            ["ca_address_sk", "ca_country", "ca_state", "ca_county"]],
            left_on="c_current_addr_sk", right_on="ca_address_sk")
        for src, nm in (("cs_quantity", "agg1"), ("cs_list_price", "agg2"),
                        ("cs_coupon_amt", "agg3"), ("cs_sales_price", "agg4"),
                        ("cs_net_profit", "agg5"), ("c_birth_year", "agg6"),
                        ("cd_dep_count", "agg7")):
            m[nm] = m[src].astype(float)
        cols = ["i_item_id", "ca_country", "ca_state", "ca_county"]
        vals = [f"agg{i}" for i in range(1, 8)]
        out = _rollup(m, cols, vals, "mean").drop(columns=["lochierarchy"])
        out = out[cols + vals]
        return out.sort_values(["ca_country", "ca_state", "ca_county", "i_item_id"],
                               na_position="last").head(100).reset_index(drop=True)
    if q == 27:
        cd, st = t["customer_demographics"], t["store"]
        m = ss.merge(dd[dd.d_year == 2002][["d_date_sk"]],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(it[["i_item_sk", "i_item_id"]], left_on="ss_item_sk",
                    right_on="i_item_sk")
        m = m.merge(st[st.s_state.isin(["TN", "TX", "SD", "IN", "GA", "OH"])][
            ["s_store_sk", "s_state"]], left_on="ss_store_sk", right_on="s_store_sk")
        cdf = cd[(cd.cd_gender == "M") & (cd.cd_marital_status == "S")
                 & (cd.cd_education_status == "College")]
        m = m.merge(cdf[["cd_demo_sk"]], left_on="ss_cdemo_sk", right_on="cd_demo_sk")
        for src, nm in (("ss_quantity", "agg1"), ("ss_list_price", "agg2"),
                        ("ss_coupon_amt", "agg3"), ("ss_sales_price", "agg4")):
            m[nm] = m[src].astype(float)
        vals = [f"agg{i}" for i in range(1, 5)]
        out = _rollup(m, ["i_item_id", "s_state"], vals, "mean")
        out["g_state"] = (out.lochierarchy >= 1).astype(int)
        out = out[["i_item_id", "s_state", "g_state"] + vals]
        return out.sort_values(["i_item_id", "s_state"], na_position="last"
                               ).head(100).reset_index(drop=True)
    if q == 31:
        ca = t["customer_address"]

        def cte(fact, dkey, akey, val, name):
            mm = fact.merge(dd[["d_date_sk", "d_qoy", "d_year"]],
                            left_on=dkey, right_on="d_date_sk")
            mm = mm.merge(ca[["ca_address_sk", "ca_county"]],
                          left_on=akey, right_on="ca_address_sk")
            return mm.groupby(["ca_county", "d_qoy", "d_year"], as_index=False).agg(
                **{name: (val, "sum")})

        sscte = cte(ss, "ss_sold_date_sk", "ss_addr_sk", "ss_ext_sales_price", "store_sales")
        wscte = cte(t["web_sales"], "ws_sold_date_sk", "ws_bill_addr_sk",
                    "ws_ext_sales_price", "web_sales")

        def pick(c, qoy, name):
            sel = c[(c.d_qoy == qoy) & (c.d_year == 2000)][["ca_county", name]]
            return sel.rename(columns={name: f"{name}{qoy}"})

        j = pick(sscte, 1, "store_sales").merge(pick(sscte, 2, "store_sales"), on="ca_county")
        j = j.merge(pick(sscte, 3, "store_sales"), on="ca_county")
        j = j.merge(pick(wscte, 1, "web_sales"), on="ca_county")
        j = j.merge(pick(wscte, 2, "web_sales"), on="ca_county")
        j = j.merge(pick(wscte, 3, "web_sales"), on="ca_county")
        w12 = np.where(j.web_sales1 > 0, j.web_sales2 / j.web_sales1, np.nan)
        s12 = np.where(j.store_sales1 > 0, j.store_sales2 / j.store_sales1, np.nan)
        w23 = np.where(j.web_sales2 > 0, j.web_sales3 / j.web_sales2, np.nan)
        s23 = np.where(j.store_sales2 > 0, j.store_sales3 / j.store_sales2, np.nan)
        j = j[(w12 > s12) & (w23 > s23)]
        out = pd.DataFrame({
            "ca_county": j.ca_county, "d_year": 2000,
            "web_q1_q2_increase": j.web_sales2 / j.web_sales1,
            "store_q1_q2_increase": j.store_sales2 / j.store_sales1,
            "web_q2_q3_increase": j.web_sales3 / j.web_sales2,
            "store_q2_q3_increase": j.store_sales3 / j.store_sales2})
        return out.sort_values("ca_county").reset_index(drop=True)
    if q == 54:
        cu, ca, st = t["customer"], t["customer_address"], t["store"]
        frames = []
        for fact, pfx in ((t["catalog_sales"], "cs"), (t["web_sales"], "ws")):
            frames.append(pd.DataFrame({
                "sold_date_sk": fact[f"{pfx}_sold_date_sk"],
                "customer_sk": fact[f"{pfx}_bill_customer_sk"],
                "item_sk": fact[f"{pfx}_item_sk"]}))
        u = pd.concat(frames, ignore_index=True)
        u = u.merge(dd[(dd.d_moy == 12) & (dd.d_year == 1998)][["d_date_sk"]],
                    left_on="sold_date_sk", right_on="d_date_sk")
        u = u.merge(it[(it.i_category == "Women") & (it.i_class == "class#1")][
            ["i_item_sk"]], left_on="item_sk", right_on="i_item_sk")
        u = u.merge(cu[["c_customer_sk", "c_current_addr_sk"]],
                    left_on="customer_sk", right_on="c_customer_sk")
        my_customers = u[["c_customer_sk", "c_current_addr_sk"]].drop_duplicates()
        base_seq = int(dd[(dd.d_year == 1998) & (dd.d_moy == 12)].d_month_seq.iloc[0])
        dsel = dd[(dd.d_month_seq >= base_seq + 1) & (dd.d_month_seq <= base_seq + 3)][["d_date_sk"]]
        mm = my_customers.merge(ca, left_on="c_current_addr_sk", right_on="ca_address_sk")
        mm = mm.merge(st, left_on=["ca_county", "ca_state"], right_on=["s_county", "s_state"])
        mm = mm.merge(ss, left_on="c_customer_sk", right_on="ss_customer_sk")
        mm = mm.merge(dsel, left_on="ss_sold_date_sk", right_on="d_date_sk")
        rev = mm.groupby("c_customer_sk")["ss_ext_sales_price"].sum()
        seg = (rev / 50).astype(int)
        g = seg.value_counts().sort_index()
        out = pd.DataFrame({"segment": g.index, "num_customers": g.values})
        out["segment_base"] = out.segment * 50
        return out.sort_values(["segment", "num_customers"]).head(100).reset_index(drop=True)
    if q in (56, 60):
        ca = t["customer_address"]
        if q == 56:
            items = set(it[it.i_color.isin(["papaya", "burnished", "smoke"])].i_item_id)
            yr, moy, gmt = 2000, 2, -5
        else:
            items = set(it[it.i_category == "Music"].i_item_id)
            yr, moy, gmt = 1998, 9, -6
        dsel = dd[(dd.d_year == yr) & (dd.d_moy == moy)][["d_date_sk"]]
        casel = ca[ca.ca_gmt_offset == gmt][["ca_address_sk"]]
        frames = []
        for fact, dkey, akey, ikey, val in (
            (ss, "ss_sold_date_sk", "ss_addr_sk", "ss_item_sk", "ss_ext_sales_price"),
            (t["catalog_sales"], "cs_sold_date_sk", "cs_bill_addr_sk", "cs_item_sk", "cs_ext_sales_price"),
            (t["web_sales"], "ws_sold_date_sk", "ws_bill_addr_sk", "ws_item_sk", "ws_ext_sales_price"),
        ):
            mm = fact.merge(dsel, left_on=dkey, right_on="d_date_sk")
            mm = mm.merge(casel, left_on=akey, right_on="ca_address_sk")
            mm = mm.merge(it[["i_item_sk", "i_item_id"]], left_on=ikey, right_on="i_item_sk")
            mm = mm[mm.i_item_id.isin(items)]
            frames.append(mm.groupby("i_item_id", as_index=False).agg(total_sales=(val, "sum")))
        u = pd.concat(frames, ignore_index=True)
        g = u.groupby("i_item_id", as_index=False)["total_sales"].sum()
        order = ["total_sales", "i_item_id"] if q == 56 else ["i_item_id", "total_sales"]
        return g.sort_values(order).head(100).reset_index(drop=True)
    if q == 58:
        wk = int(dd[dd.d_date == dt.date(2000, 1, 3)].d_week_seq.iloc[0])
        dsel = dd[dd.d_week_seq == wk][["d_date_sk"]]

        def chan(fact, ikey, dkey, val, name):
            mm = fact.merge(dsel, left_on=dkey, right_on="d_date_sk")
            mm = mm.merge(it[["i_item_sk", "i_item_id"]], left_on=ikey, right_on="i_item_sk")
            return mm.groupby("i_item_id", as_index=False).agg(**{name: (val, "sum")})

        a = chan(ss, "ss_item_sk", "ss_sold_date_sk", "ss_ext_sales_price", "ss_item_rev")
        b = chan(t["catalog_sales"], "cs_item_sk", "cs_sold_date_sk",
                 "cs_ext_sales_price", "cs_item_rev")
        c = chan(t["web_sales"], "ws_item_sk", "ws_sold_date_sk",
                 "ws_ext_sales_price", "ws_item_rev")
        j = a.merge(b, on="i_item_id").merge(c, on="i_item_id")
        sel = (j.ss_item_rev.between(0.9 * j.cs_item_rev, 1.1 * j.cs_item_rev)
               & j.ss_item_rev.between(0.9 * j.ws_item_rev, 1.1 * j.ws_item_rev)
               & j.cs_item_rev.between(0.9 * j.ss_item_rev, 1.1 * j.ss_item_rev)
               & j.cs_item_rev.between(0.9 * j.ws_item_rev, 1.1 * j.ws_item_rev)
               & j.ws_item_rev.between(0.9 * j.ss_item_rev, 1.1 * j.ss_item_rev)
               & j.ws_item_rev.between(0.9 * j.cs_item_rev, 1.1 * j.cs_item_rev))
        j = j[sel]
        avg3 = (j.ss_item_rev + j.cs_item_rev + j.ws_item_rev) / 3
        out = pd.DataFrame({
            "item_id": j.i_item_id, "ss_item_rev": j.ss_item_rev,
            "ss_dev": j.ss_item_rev / avg3 * 100, "cs_item_rev": j.cs_item_rev,
            "cs_dev": j.cs_item_rev / avg3 * 100, "ws_item_rev": j.ws_item_rev,
            "ws_dev": j.ws_item_rev / avg3 * 100, "average": avg3})
        return out.sort_values(["item_id", "ss_item_rev"]).head(100).reset_index(drop=True)
    if q == 66:
        wh, td, sm = t["warehouse"], t["time_dim"], t["ship_mode"]
        frames = []
        for fact, pfx in ((t["web_sales"], "ws"), (t["catalog_sales"], "cs")):
            mm = fact.merge(dd[dd.d_year == 2001][["d_date_sk", "d_moy"]],
                            left_on=f"{pfx}_sold_date_sk", right_on="d_date_sk")
            mm = mm.merge(td[(td.t_time >= 30838) & (td.t_time <= 30838 + 28800)][
                ["t_time_sk"]], left_on=f"{pfx}_sold_time_sk", right_on="t_time_sk")
            mm = mm.merge(sm[sm.sm_carrier.isin(["CARRIER1", "CARRIER3"])][
                ["sm_ship_mode_sk"]], left_on=f"{pfx}_ship_mode_sk",
                right_on="sm_ship_mode_sk")
            mm = mm.merge(wh, left_on=f"{pfx}_warehouse_sk", right_on="w_warehouse_sk")
            price, net = f"{pfx}_ext_sales_price", f"{pfx}_net_paid"
            qty = f"{pfx}_quantity"
            months = ["jan", "feb", "mar", "apr", "may", "jun", "jul", "aug",
                      "sep", "oct", "nov", "dec"]
            for i, mo in enumerate(months, 1):
                mm[f"{mo}_sales"] = np.where(mm.d_moy == i, mm[price] * mm[qty], 0.0)
                mm[f"{mo}_net"] = np.where(mm.d_moy == i, mm[net] * mm[qty], 0.0)
            keys = ["w_warehouse_name", "w_warehouse_sq_ft", "w_city", "w_county",
                    "w_state", "w_country"]
            cols = [f"{mo}_sales" for mo in months] + [f"{mo}_net" for mo in months]
            g = mm.groupby(keys, as_index=False)[cols].sum()
            g["ship_carriers"] = "CARRIER1,CARRIER3"
            g["year_"] = 2001
            frames.append(g)
        u = pd.concat(frames, ignore_index=True)
        keys = ["w_warehouse_name", "w_warehouse_sq_ft", "w_city", "w_county",
                "w_state", "w_country", "ship_carriers", "year_"]
        months = ["jan", "feb", "mar", "apr", "may", "jun", "jul", "aug",
                  "sep", "oct", "nov", "dec"]
        cols = [f"{mo}_sales" for mo in months] + [f"{mo}_net" for mo in months]
        g = u.groupby(keys, as_index=False)[cols].sum()
        return g[keys + cols].sort_values("w_warehouse_name").head(100).reset_index(drop=True)
    if q == 74:
        cu = t["customer"]

        def yt(fact, ckey, dkey, val, stype):
            mm = fact.merge(dd[dd.d_year.isin([1999, 2000])][["d_date_sk", "d_year"]],
                            left_on=dkey, right_on="d_date_sk")
            mm = mm.merge(cu[["c_customer_sk", "c_customer_id", "c_first_name",
                              "c_last_name"]], left_on=ckey, right_on="c_customer_sk")
            g = mm.groupby(["c_customer_id", "c_first_name", "c_last_name", "d_year"],
                           as_index=False).agg(year_total=(val, "sum"))
            g["sale_type"] = stype
            return g

        u = pd.concat([
            yt(ss, "ss_customer_sk", "ss_sold_date_sk", "ss_net_paid", "s"),
            yt(t["web_sales"], "ws_bill_customer_sk", "ws_sold_date_sk",
               "ws_net_paid", "w")], ignore_index=True)

        def leg(stype, year, name):
            sel = u[(u.sale_type == stype) & (u.d_year == year)]
            return sel[["c_customer_id", "c_first_name", "c_last_name", "year_total"]
                       ].rename(columns={"year_total": name})

        j = leg("s", 1999, "s1").merge(leg("s", 2000, "s2"),
                                       on=["c_customer_id", "c_first_name", "c_last_name"])
        j = j.merge(leg("w", 1999, "w1"), on=["c_customer_id", "c_first_name", "c_last_name"])
        j = j.merge(leg("w", 2000, "w2"), on=["c_customer_id", "c_first_name", "c_last_name"])
        j = j[(j.s1 > 0) & (j.w1 > 0)]
        j = j[np.where(j.w1 > 0, j.w2 / j.w1, np.nan)
              > np.where(j.s1 > 0, j.s2 / j.s1, np.nan)]
        out = j[["c_customer_id", "c_first_name", "c_last_name"]]
        return out.sort_values(list(out.columns)).head(100).reset_index(drop=True)
    if q == 83:
        dates = [dt.date(2000, 6, 30), dt.date(2000, 9, 27), dt.date(2000, 11, 17)]
        wks = set(dd[dd.d_date.isin(dates)].d_week_seq)
        dsel = dd[dd.d_week_seq.isin(wks)][["d_date_sk"]]

        def chan(fact, ikey, dkey, val, name):
            mm = fact.merge(dsel, left_on=dkey, right_on="d_date_sk")
            mm = mm.merge(it[["i_item_sk", "i_item_id"]], left_on=ikey, right_on="i_item_sk")
            return mm.groupby("i_item_id", as_index=False).agg(**{name: (val, "sum")})

        a = chan(t["store_returns"], "sr_item_sk", "sr_returned_date_sk",
                 "sr_return_quantity", "sr_item_qty")
        b = chan(t["catalog_returns"], "cr_item_sk", "cr_returned_date_sk",
                 "cr_return_quantity", "cr_item_qty")
        c = chan(t["web_returns"], "wr_item_sk", "wr_returned_date_sk",
                 "wr_return_quantity", "wr_item_qty")
        j = a.merge(b, on="i_item_id").merge(c, on="i_item_id")
        tot = j.sr_item_qty + j.cr_item_qty + j.wr_item_qty
        out = pd.DataFrame({
            "item_id": j.i_item_id, "sr_item_qty": j.sr_item_qty,
            "sr_dev": j.sr_item_qty / tot / 3.0 * 100, "cr_item_qty": j.cr_item_qty,
            "cr_dev": j.cr_item_qty / tot / 3.0 * 100, "wr_item_qty": j.wr_item_qty,
            "wr_dev": j.wr_item_qty / tot / 3.0 * 100, "average": tot / 3.0})
        return out.sort_values(["item_id", "sr_item_qty"]).head(100).reset_index(drop=True)
    if q == 84:
        cu, ca, cd = t["customer"], t["customer_address"], t["customer_demographics"]
        hd, ib, sr = t["household_demographics"], t["income_band"], t["store_returns"]
        m = cu.merge(ca[ca.ca_city == "Fairview"][["ca_address_sk"]],
                     left_on="c_current_addr_sk", right_on="ca_address_sk")
        m = m.merge(hd[["hd_demo_sk", "hd_income_band_sk"]],
                    left_on="c_current_hdemo_sk", right_on="hd_demo_sk")
        ibf = ib[(ib.ib_lower_bound >= 38128) & (ib.ib_upper_bound <= 38128 + 50000)]
        m = m.merge(ibf[["ib_income_band_sk"]], left_on="hd_income_band_sk",
                    right_on="ib_income_band_sk")
        m = m.merge(cd[["cd_demo_sk"]], left_on="c_current_cdemo_sk", right_on="cd_demo_sk")
        m = m.merge(sr[["sr_cdemo_sk"]], left_on="cd_demo_sk", right_on="sr_cdemo_sk")
        out = pd.DataFrame({
            "customer_id": m.c_customer_id,
            "customername": m.c_last_name + ", " + m.c_first_name})
        return out.sort_values("customer_id").head(100).reset_index(drop=True)
    if q == 85:
        wsx, wr, wp = t["web_sales"], t["web_returns"], t["web_page"]
        cd, ca, rs = t["customer_demographics"], t["customer_address"], t["reason"]
        m = wsx.merge(wr, left_on=["ws_item_sk", "ws_order_number"],
                      right_on=["wr_item_sk", "wr_order_number"])
        m = m.merge(wp[["wp_web_page_sk"]], left_on="ws_web_page_sk",
                    right_on="wp_web_page_sk")
        m = m.merge(dd[dd.d_year == 2000][["d_date_sk"]],
                    left_on="ws_sold_date_sk", right_on="d_date_sk")
        m = m.merge(cd.add_prefix("c1_"), left_on="wr_refunded_cdemo_sk",
                    right_on="c1_cd_demo_sk")
        m = m.merge(cd.add_prefix("c2_"), left_on="wr_returning_cdemo_sk",
                    right_on="c2_cd_demo_sk")
        m = m.merge(ca, left_on="wr_refunded_addr_sk", right_on="ca_address_sk")
        m = m.merge(rs, left_on="wr_reason_sk", right_on="r_reason_sk")
        ms_eq = ((m.c1_cd_marital_status == m.c2_cd_marital_status)
                 & (m.c1_cd_education_status == m.c2_cd_education_status))
        c1 = (ms_eq & (m.c1_cd_marital_status == "M")
              & (m.c1_cd_education_status == "Advanced Degree")
              & m.ws_sales_price.between(100.0, 150.0))
        c2 = (ms_eq & (m.c1_cd_marital_status == "S")
              & (m.c1_cd_education_status == "College")
              & m.ws_sales_price.between(50.0, 100.0))
        c3 = (ms_eq & (m.c1_cd_marital_status == "W")
              & (m.c1_cd_education_status == "2 yr Degree")
              & m.ws_sales_price.between(150.0, 200.0))
        a1 = ((m.ca_country == "United States") & m.ca_state.isin(["IN", "OH", "NJ"])
              & m.ws_net_profit.between(10, 2000))
        a2 = ((m.ca_country == "United States") & m.ca_state.isin(["CA", "TX", "MT"])
              & m.ws_net_profit.between(15, 3000))
        a3 = ((m.ca_country == "United States") & m.ca_state.isin(["GA", "TN", "NY"])
              & m.ws_net_profit.between(5, 2500))
        m = m[(c1 | c2 | c3) & (a1 | a2 | a3)]
        g = m.groupby("r_reason_desc", as_index=False).agg(
            avg_qty=("ws_quantity", "mean"), avg_refund=("wr_refund_cash", "mean"),
            avg_fee=("wr_fee", "mean"))
        g["reason20"] = g.r_reason_desc.str[:20]
        out = g[["reason20", "avg_qty", "avg_refund", "avg_fee"]]
        return out.sort_values(list(out.columns)).head(100).reset_index(drop=True)
    if q in (4, 11):
        cu = t["customer"]
        keys = ["c_customer_id", "c_first_name", "c_last_name",
                "c_preferred_cust_flag", "c_birth_country", "c_login",
                "c_email_address"]

        def yt(fact, ckey, dkey, val_fn, stype):
            mm = fact.merge(dd[["d_date_sk", "d_year"]], left_on=dkey,
                            right_on="d_date_sk")
            mm = mm.merge(cu[["c_customer_sk"] + keys], left_on=ckey,
                          right_on="c_customer_sk")
            mm["v"] = val_fn(mm)
            g = mm.groupby(keys + ["d_year"], as_index=False).agg(year_total=("v", "sum"))
            g["sale_type"] = stype
            return g

        if q == 11:
            legs = [
                yt(ss, "ss_customer_sk", "ss_sold_date_sk",
                   lambda m: m.ss_ext_list_price - m.ss_ext_discount_amt, "s"),
                yt(t["web_sales"], "ws_bill_customer_sk", "ws_sold_date_sk",
                   lambda m: m.ws_ext_list_price - m.ws_ext_discount_amt, "w")]
            types = ["s", "w"]
            sel_col = "c_email_address"
        else:
            legs = [
                yt(ss, "ss_customer_sk", "ss_sold_date_sk",
                   lambda m: ((m.ss_ext_list_price - m.ss_ext_wholesale_cost
                               - m.ss_ext_discount_amt) + m.ss_ext_sales_price) / 2, "s"),
                yt(t["catalog_sales"], "cs_bill_customer_sk", "cs_sold_date_sk",
                   lambda m: ((m.cs_ext_list_price - m.cs_wholesale_cost * m.cs_quantity
                               - m.cs_ext_discount_amt) + m.cs_ext_sales_price) / 2, "c"),
                yt(t["web_sales"], "ws_bill_customer_sk", "ws_sold_date_sk",
                   lambda m: ((m.ws_ext_list_price - m.ws_wholesale_cost * m.ws_quantity
                               - m.ws_ext_discount_amt) + m.ws_ext_sales_price) / 2, "w")]
            types = ["s", "c", "w"]
            sel_col = "c_preferred_cust_flag"
        u = pd.concat(legs, ignore_index=True)

        def leg(stype, year, name):
            sel = u[(u.sale_type == stype) & (u.d_year == year)]
            return sel[keys + ["year_total"]].rename(columns={"year_total": name})

        j = leg("s", 2001, "s1").merge(leg("s", 2002, "s2"), on=keys)
        if q == 4:
            j = j.merge(leg("c", 2001, "c1"), on=keys).merge(leg("c", 2002, "c2"), on=keys)
        j = j.merge(leg("w", 2001, "w1"), on=keys).merge(leg("w", 2002, "w2"), on=keys)
        if q == 11:
            j = j[(j.s1 > 0) & (j.w1 > 0)]
            wr_ = np.where(j.w1 > 0, j.w2 / j.w1, 0.0)
            sr_ = np.where(j.s1 > 0, j.s2 / j.s1, 0.0)
            j = j[wr_ > sr_]
        else:
            j = j[(j.s1 > 0) & (j.c1 > 0) & (j.w1 > 0)]
            cr_ = np.where(j.c1 > 0, j.c2 / j.c1, np.nan)
            sr_ = np.where(j.s1 > 0, j.s2 / j.s1, np.nan)
            wr_ = np.where(j.w1 > 0, j.w2 / j.w1, np.nan)
            j = j[(cr_ > sr_) & (cr_ > wr_)]
        out = j[["c_customer_id", "c_first_name", "c_last_name", sel_col]]
        return out.sort_values(list(out.columns)).head(100).reset_index(drop=True)
    if q == 44:
        base = ss[ss.ss_store_sk == 4]
        nulladdr = base[base.ss_addr_sk.isna()]
        thresh = 0.9 * nulladdr.ss_net_profit.mean()
        g = base.groupby("ss_item_sk", as_index=False).agg(
            rank_col=("ss_net_profit", "mean"))
        g = g[g.rank_col > thresh]
        g["rnk_asc"] = g.rank_col.rank(method="min").astype(int)
        g["rnk_desc"] = g.rank_col.rank(method="min", ascending=False).astype(int)
        asc = g[g.rnk_asc < 11][["ss_item_sk", "rnk_asc"]].rename(
            columns={"rnk_asc": "rnk"})
        desc = g[g.rnk_desc < 11][["ss_item_sk", "rnk_desc"]].rename(
            columns={"rnk_desc": "rnk"})
        j = asc.merge(desc, on="rnk", suffixes=("_a", "_d"))
        j = j.merge(it[["i_item_sk", "i_product_name"]].rename(
            columns={"i_product_name": "best_performing"}),
            left_on="ss_item_sk_a", right_on="i_item_sk")
        j = j.merge(it[["i_item_sk", "i_product_name"]].rename(
            columns={"i_product_name": "worst_performing"}),
            left_on="ss_item_sk_d", right_on="i_item_sk")
        out = j[["rnk", "best_performing", "worst_performing"]]
        return out.sort_values("rnk").head(100).reset_index(drop=True)
    if q == 49:
        frames = []
        for label, fact, rets, skey, rkey, qty, rqty, paid, ramt, prof in (
            ("web", t["web_sales"], t["web_returns"],
             ["ws_order_number", "ws_item_sk"], ["wr_order_number", "wr_item_sk"],
             "ws_quantity", "wr_return_quantity", "ws_net_paid", "wr_return_amt",
             "ws_net_profit"),
            ("catalog", t["catalog_sales"], t["catalog_returns"],
             ["cs_order_number", "cs_item_sk"], ["cr_order_number", "cr_item_sk"],
             "cs_quantity", "cr_return_quantity", "cs_net_paid", "cr_return_amt",
             "cs_net_profit"),
            ("store", ss, t["store_returns"],
             ["ss_ticket_number", "ss_item_sk"], ["sr_ticket_number", "sr_item_sk"],
             "ss_quantity", "sr_return_quantity", "ss_net_paid", "sr_return_amt",
             "ss_net_profit"),
        ):
            dsel = dd[(dd.d_year == 2001) & (dd.d_moy == 12)][["d_date_sk"]]
            mm = fact.merge(rets, left_on=skey, right_on=rkey, how="left")
            mm = mm.merge(dsel, left_on=skey[0].replace("order_number", "sold_date_sk")
                          .replace("ticket_number", "sold_date_sk"), right_on="d_date_sk")
            mm = mm[(mm[ramt] > 100) & (mm[prof] > 1) & (mm[paid] > 0) & (mm[qty] > 0)]
            g = mm.groupby(skey[1], as_index=False).agg(
                rq=(rqty, lambda s: s.fillna(0).sum()),
                sq=(qty, "sum"), ra=(ramt, lambda s: s.fillna(0).sum()),
                np_=(paid, "sum"))
            g["return_ratio"] = g.rq / g.sq
            g["currency_ratio"] = g.ra / g.np_
            g["return_rank"] = g.return_ratio.rank(method="min").astype(int)
            g["currency_rank"] = g.currency_ratio.rank(method="min").astype(int)
            g = g[(g.return_rank <= 10) | (g.currency_rank <= 10)]
            frames.append(pd.DataFrame({
                "channel": label, "item": g[skey[1]],
                "return_ratio": g.return_ratio, "return_rank": g.return_rank,
                "currency_rank": g.currency_rank}))
        u = pd.concat(frames, ignore_index=True).drop_duplicates()
        return u.sort_values(["channel", "return_rank", "currency_rank", "item"]
                             ).head(100).reset_index(drop=True)
    if q == 51:
        dsel = dd[(dd.d_month_seq >= 1200) & (dd.d_month_seq <= 1211)][
            ["d_date_sk", "d_date"]]

        def v1(fact, ikey, dkey, price):
            mm = fact.merge(dsel, left_on=dkey, right_on="d_date_sk")
            g = mm.groupby([ikey, "d_date"], as_index=False).agg(s=(price, "sum"))
            g = g.sort_values([ikey, "d_date"])
            g["cume_sales"] = g.groupby(ikey)["s"].cumsum()
            return g.rename(columns={ikey: "item_sk"})[["item_sk", "d_date", "cume_sales"]]

        web = v1(t["web_sales"], "ws_item_sk", "ws_sold_date_sk", "ws_sales_price")
        store = v1(ss, "ss_item_sk", "ss_sold_date_sk", "ss_sales_price")
        j = web.merge(store, on=["item_sk", "d_date"], how="outer",
                      suffixes=("_w", "_s"))
        j = j.sort_values(["item_sk", "d_date"]).reset_index(drop=True)
        # SQL MAX ignores NULLs over the frame: a side's running max carries
        # through rows where that side is absent (pandas cummax leaves NaN
        # at those positions — forward-fill within the partition)
        j["web_cumulative"] = j.groupby("item_sk")["cume_sales_w"].cummax()
        j["web_cumulative"] = j.groupby("item_sk")["web_cumulative"].ffill()
        j["store_cumulative"] = j.groupby("item_sk")["cume_sales_s"].cummax()
        j["store_cumulative"] = j.groupby("item_sk")["store_cumulative"].ffill()
        j = j[j.web_cumulative > j.store_cumulative]
        out = pd.DataFrame({
            "item_sk": j.item_sk, "d_date": j.d_date,
            "web_sales": j.cume_sales_w, "store_sales": j.cume_sales_s,
            "web_cumulative": j.web_cumulative, "store_cumulative": j.store_cumulative})
        return out.sort_values(["item_sk", "d_date"]).head(100).reset_index(drop=True)
    if q == 5:
        lo, hi = dt.date(2000, 8, 23), dt.date(2000, 9, 6)
        dsel = dd[(dd.d_date >= lo) & (dd.d_date <= hi)][["d_date_sk"]]
        st, cc, web, wr = t["store"], t["call_center"], t["web_site"], t["web_returns"]

        def chan(sales_rows, dim, dim_key, dim_id):
            mm = sales_rows.merge(dsel, left_on="date_sk", right_on="d_date_sk")
            mm = mm.merge(dim[[dim_key, dim_id]], left_on="loc_sk", right_on=dim_key)
            return mm.groupby(dim_id, as_index=False).agg(
                sales=("sales_price", "sum"), profit=("profit", "sum"),
                returns_=("return_amt", "sum"), profit_loss=("net_loss", "sum"))

        def rows(df, loc, date, price=None, prof=None, ramt=None, loss=None):
            return pd.DataFrame({
                "loc_sk": df[loc], "date_sk": df[date],
                "sales_price": df[price] if price else 0.0,
                "profit": df[prof] if prof else 0.0,
                "return_amt": df[ramt] if ramt else 0.0,
                "net_loss": df[loss] if loss else 0.0})

        ssr = chan(pd.concat([
            rows(ss, "ss_store_sk", "ss_sold_date_sk", "ss_ext_sales_price",
                 "ss_net_profit"),
            rows(t["store_returns"], "sr_store_sk", "sr_returned_date_sk",
                 ramt="sr_return_amt", loss="sr_net_loss")], ignore_index=True),
            st, "s_store_sk", "s_store_id")
        csr = chan(pd.concat([
            rows(t["catalog_sales"], "cs_call_center_sk", "cs_sold_date_sk",
                 "cs_ext_sales_price", "cs_net_profit"),
            rows(t["catalog_returns"], "cr_call_center_sk", "cr_returned_date_sk",
                 ramt="cr_return_amt", loss="cr_net_loss")], ignore_index=True),
            cc, "cc_call_center_sk", "cc_call_center_id")
        wrj = wr.merge(t["web_sales"][["ws_item_sk", "ws_order_number", "ws_web_site_sk"]],
                       left_on=["wr_item_sk", "wr_order_number"],
                       right_on=["ws_item_sk", "ws_order_number"], how="left")
        wsr = chan(pd.concat([
            rows(t["web_sales"], "ws_web_site_sk", "ws_sold_date_sk",
                 "ws_ext_sales_price", "ws_net_profit"),
            rows(wrj, "ws_web_site_sk", "wr_returned_date_sk",
                 ramt="wr_return_amt", loss="wr_net_loss")], ignore_index=True),
            web, "web_site_sk", "web_site_id")
        frames = []
        for label, d_, idc in (("store channel", ssr, "s_store_id"),
                               ("catalog channel", csr, "cc_call_center_id"),
                               ("web channel", wsr, "web_site_id")):
            frames.append(pd.DataFrame({
                "channel": label, "id": d_[idc], "sales": d_.sales,
                "returns_": d_.returns_, "profit": d_.profit - d_.profit_loss}))
        u = pd.concat(frames, ignore_index=True)
        out = _rollup(u, ["channel", "id"], ["sales", "returns_", "profit"], "sum")
        out = out.drop(columns=["lochierarchy"])
        return out[["channel", "id", "sales", "returns_", "profit"]].sort_values(
            ["channel", "id"], na_position="last").head(100).reset_index(drop=True)
    if q == 9:
        vals = {}
        for i, ((qlo, qhi), thresh) in enumerate(zip(
                [(1, 20), (21, 40), (41, 60), (61, 80), (81, 100)],
                [3500, 3000, 10000, 2500, 15000]), 1):
            b = ss[ss.ss_quantity.between(qlo, qhi)]
            vals[f"bucket{i}"] = [b.ss_ext_discount_amt.mean() if len(b) > thresh
                                  else b.ss_net_paid.mean()]
        return pd.DataFrame(vals)
    if q == 41:
        i1 = it[it.i_manufact_id.between(70, 110)]
        combos = (
            ("Women", ["papaya", "frosted"], ["Ounce", "Ton"], ["medium", "extra large"]),
            ("Women", ["chiffon", "lace"], ["Pound", "Dram"], ["economy", "small"]),
            ("Men", ["orchid", "peach"], ["Bundle", "Gross"], ["N/A", "large"]),
            ("Men", ["smoke", "dim"], ["Each", "Oz"], ["medium", "petite"]),
        )
        sel = np.zeros(len(it), dtype=bool)
        for cat, colors, units, sizes in combos:
            sel |= ((it.i_category == cat) & it.i_color.isin(colors)
                    & it.i_units.isin(units) & it.i_size.isin(sizes)).values
        good_manufacts = set(it[sel].i_manufact)
        out = i1[i1.i_manufact.isin(good_manufacts)][["i_product_name"]].drop_duplicates()
        return out.sort_values("i_product_name").head(100).reset_index(drop=True)
    if q == 75:
        frames = []
        for fact, rets, ikey, dkey, skey, rkey, qty, rqty, price, ramt in (
            (t["catalog_sales"], t["catalog_returns"], "cs_item_sk", "cs_sold_date_sk",
             ["cs_order_number", "cs_item_sk"], ["cr_order_number", "cr_item_sk"],
             "cs_quantity", "cr_return_quantity", "cs_ext_sales_price", "cr_return_amt"),
            (ss, t["store_returns"], "ss_item_sk", "ss_sold_date_sk",
             ["ss_ticket_number", "ss_item_sk"], ["sr_ticket_number", "sr_item_sk"],
             "ss_quantity", "sr_return_quantity", "ss_ext_sales_price", "sr_return_amt"),
            (t["web_sales"], t["web_returns"], "ws_item_sk", "ws_sold_date_sk",
             ["ws_order_number", "ws_item_sk"], ["wr_order_number", "wr_item_sk"],
             "ws_quantity", "wr_return_quantity", "ws_ext_sales_price", "wr_return_amt"),
        ):
            mm = fact.merge(it[it.i_category == "Books"][
                ["i_item_sk", "i_brand_id", "i_class_id", "i_category_id", "i_manufact_id"]],
                left_on=ikey, right_on="i_item_sk")
            mm = mm.merge(dd[["d_date_sk", "d_year"]], left_on=dkey, right_on="d_date_sk")
            mm = mm.merge(rets, left_on=skey, right_on=rkey, how="left")
            frames.append(pd.DataFrame({
                "d_year": mm.d_year, "i_brand_id": mm.i_brand_id,
                "i_class_id": mm.i_class_id, "i_category_id": mm.i_category_id,
                "i_manufact_id": mm.i_manufact_id,
                "sales_cnt": mm[qty] - mm[rqty].fillna(0),
                "sales_amt": mm[price] - mm[ramt].fillna(0.0)}))
        u = pd.concat(frames, ignore_index=True).drop_duplicates()  # UNION distinct
        g = u.groupby(["d_year", "i_brand_id", "i_class_id", "i_category_id",
                       "i_manufact_id"], as_index=False).agg(
            sales_cnt=("sales_cnt", "sum"), sales_amt=("sales_amt", "sum"))
        keys = ["i_brand_id", "i_class_id", "i_category_id", "i_manufact_id"]
        cur = g[g.d_year == 2002].merge(
            g[g.d_year == 2001], on=keys, suffixes=("_c", "_p"))
        cur = cur[cur.sales_cnt_c / cur.sales_cnt_p < 0.9]
        out = pd.DataFrame({
            "prev_year": 2001, "year_": 2002, "i_brand_id": cur.i_brand_id,
            "i_class_id": cur.i_class_id, "i_category_id": cur.i_category_id,
            "i_manufact_id": cur.i_manufact_id, "prev_yr_cnt": cur.sales_cnt_p,
            "curr_yr_cnt": cur.sales_cnt_c,
            "sales_cnt_diff": cur.sales_cnt_c - cur.sales_cnt_p,
            "sales_amt_diff": cur.sales_amt_c - cur.sales_amt_p})
        return out.sort_values(["sales_cnt_diff", "sales_amt_diff"]
                               ).head(100).reset_index(drop=True)
    if q == 77:
        lo, hi = dt.date(2000, 8, 23), dt.date(2000, 9, 22)
        dsel = dd[(dd.d_date >= lo) & (dd.d_date <= hi)][["d_date_sk"]]

        def agg(fact, dkey, gkey, cols):
            mm = fact.merge(dsel, left_on=dkey, right_on="d_date_sk")
            if gkey is None:
                return pd.DataFrame({k: [mm[v].sum()] for k, v in cols.items()})
            return mm.groupby(gkey, as_index=False).agg(
                **{k: (v, "sum") for k, v in cols.items()})

        ssx = agg(ss, "ss_sold_date_sk", "ss_store_sk",
                  {"sales": "ss_ext_sales_price", "profit": "ss_net_profit"})
        srx = agg(t["store_returns"], "sr_returned_date_sk", "sr_store_sk",
                  {"returns_": "sr_return_amt", "profit_loss": "sr_net_loss"})
        csx = agg(t["catalog_sales"], "cs_sold_date_sk", "cs_call_center_sk",
                  {"sales": "cs_ext_sales_price", "profit": "cs_net_profit"})
        crx = agg(t["catalog_returns"], "cr_returned_date_sk", None,
                  {"returns_": "cr_return_amt", "profit_loss": "cr_net_loss"})
        wsx = agg(t["web_sales"], "ws_sold_date_sk", "ws_web_page_sk",
                  {"sales": "ws_ext_sales_price", "profit": "ws_net_profit"})
        wrx = agg(t["web_returns"], "wr_returned_date_sk", "wr_web_page_sk",
                  {"returns_": "wr_return_amt", "profit_loss": "wr_net_loss"})
        s = ssx.merge(srx, left_on="ss_store_sk", right_on="sr_store_sk", how="left")
        sdf = pd.DataFrame({"channel": "store channel", "id": s.ss_store_sk,
                            "sales": s.sales, "returns_": s.returns_.fillna(0),
                            "profit": s.profit - s.profit_loss.fillna(0)})
        c = csx.assign(returns_=crx.returns_[0], profit_loss=crx.profit_loss[0])
        cdf = pd.DataFrame({"channel": "catalog channel", "id": c.cs_call_center_sk,
                            "sales": c.sales, "returns_": c.returns_,
                            "profit": c.profit - c.profit_loss})
        w = wsx.merge(wrx, left_on="ws_web_page_sk", right_on="wr_web_page_sk", how="left")
        wdf = pd.DataFrame({"channel": "web channel", "id": w.ws_web_page_sk,
                            "sales": w.sales, "returns_": w.returns_.fillna(0),
                            "profit": w.profit - w.profit_loss.fillna(0)})
        u = pd.concat([sdf, cdf, wdf], ignore_index=True)
        out = _rollup(u, ["channel", "id"], ["sales", "returns_", "profit"], "sum")
        out = out.drop(columns=["lochierarchy"])
        return out[["channel", "id", "sales", "returns_", "profit"]].sort_values(
            ["channel", "id"], na_position="last").head(100).reset_index(drop=True)
    if q == 78:
        def yr(fact, rets, skey, rkey, dkey, ikey, ckey, qty, wc, sp, pfx):
            mm = fact.merge(rets[rkey].to_frame().assign(__hit=1),
                            left_on=skey, right_on=rkey, how="left")
            mm = mm[mm.__hit.isna()]
            mm = mm.merge(dd[["d_date_sk", "d_year"]], left_on=dkey, right_on="d_date_sk")
            g = mm.groupby(["d_year", ikey, ckey], as_index=False).agg(
                **{f"{pfx}_qty": (qty, "sum"), f"{pfx}_wc": (wc, "sum"),
                   f"{pfx}_sp": (sp, "sum")})
            return g.rename(columns={"d_year": f"{pfx}_sold_year", ikey: f"{pfx}_item_sk",
                                     ckey: f"{pfx}_customer_sk"})

        # join on the PAIR keys, not a single column (a sale is returned if a
        # return row matches both its order/ticket and item)
        def yr2(fact, rets, skeys, rkeys, dkey, ikey, ckey, qty, wc, sp, pfx):
            rsub = rets[rkeys].drop_duplicates().assign(__hit=1)
            mm = fact.merge(rsub, left_on=skeys, right_on=rkeys, how="left")
            mm = mm[mm.__hit.isna()]
            mm = mm.merge(dd[["d_date_sk", "d_year"]], left_on=dkey, right_on="d_date_sk")
            g = mm.groupby(["d_year", ikey, ckey], as_index=False).agg(
                **{f"{pfx}_qty": (qty, "sum"), f"{pfx}_wc": (wc, "sum"),
                   f"{pfx}_sp": (sp, "sum")})
            return g.rename(columns={"d_year": f"{pfx}_sold_year", ikey: f"{pfx}_item_sk",
                                     ckey: f"{pfx}_customer_sk"})

        wsy = yr2(t["web_sales"], t["web_returns"], ["ws_order_number", "ws_item_sk"],
                  ["wr_order_number", "wr_item_sk"], "ws_sold_date_sk", "ws_item_sk",
                  "ws_bill_customer_sk", "ws_quantity", "ws_wholesale_cost",
                  "ws_sales_price", "ws")
        csy = yr2(t["catalog_sales"], t["catalog_returns"],
                  ["cs_order_number", "cs_item_sk"], ["cr_order_number", "cr_item_sk"],
                  "cs_sold_date_sk", "cs_item_sk", "cs_bill_customer_sk",
                  "cs_quantity", "cs_wholesale_cost", "cs_sales_price", "cs")
        ssy = yr2(ss, t["store_returns"], ["ss_ticket_number", "ss_item_sk"],
                  ["sr_ticket_number", "sr_item_sk"], "ss_sold_date_sk", "ss_item_sk",
                  "ss_customer_sk", "ss_quantity", "ss_wholesale_cost",
                  "ss_sales_price", "ss")
        j = ssy.merge(wsy, left_on=["ss_sold_year", "ss_item_sk", "ss_customer_sk"],
                      right_on=["ws_sold_year", "ws_item_sk", "ws_customer_sk"],
                      how="left")
        j = j.merge(csy, left_on=["ss_sold_year", "ss_item_sk", "ss_customer_sk"],
                    right_on=["cs_sold_year", "cs_item_sk", "cs_customer_sk"],
                    how="left")
        j = j[(j.ws_qty.fillna(0) > 0) | (j.cs_qty.fillna(0) > 0)]
        j = j[j.ss_sold_year == 2000]
        out = pd.DataFrame({
            "ss_sold_year": j.ss_sold_year, "ss_item_sk": j.ss_item_sk,
            "ss_customer_sk": j.ss_customer_sk,
            "ratio": np.round(j.ss_qty / (j.ws_qty.fillna(0) + j.cs_qty.fillna(0)), 2),
            "store_qty": j.ss_qty, "store_wholesale_cost": j.ss_wc,
            "store_sales_price": j.ss_sp,
            "other_chan_qty": j.ws_qty.fillna(0) + j.cs_qty.fillna(0),
            "other_chan_wholesale_cost": j.ws_wc.fillna(0) + j.cs_wc.fillna(0),
            "other_chan_sales_price": j.ws_sp.fillna(0) + j.cs_sp.fillna(0)})
        out = out.sort_values(
            ["ss_sold_year", "ss_item_sk", "ss_customer_sk", "store_qty",
             "store_wholesale_cost", "store_sales_price", "other_chan_qty",
             "other_chan_wholesale_cost", "other_chan_sales_price", "ratio"],
            ascending=[True, True, True, False, False, False, True, True, True, True])
        return out.head(100).reset_index(drop=True)
    if q == 80:
        lo, hi = dt.date(2000, 8, 23), dt.date(2000, 9, 22)
        dsel = dd[(dd.d_date >= lo) & (dd.d_date <= hi)][["d_date_sk"]]
        pr = t["promotion"]

        def chan(fact, rets, skeys, rkeys, dkey, ikey, pkey, lkey, dim, dkey2,
                 idc, price, prof, ramt, loss, label):
            mm = fact.merge(rets[rkeys + [ramt, loss]], left_on=skeys,
                            right_on=rkeys, how="left")
            mm = mm.merge(dsel, left_on=dkey, right_on="d_date_sk")
            mm = mm.merge(it[it.i_current_price > 50][["i_item_sk"]],
                          left_on=ikey, right_on="i_item_sk")
            mm = mm.merge(pr[pr.p_channel_tv == "N"][["p_promo_sk"]],
                          left_on=pkey, right_on="p_promo_sk")
            mm = mm.merge(dim[[dkey2, idc]], left_on=lkey, right_on=dkey2)
            g = mm.groupby(idc, as_index=False).apply(
                lambda x: pd.Series({
                    "sales": x[price].sum(),
                    "returns_": x[ramt].fillna(0).sum(),
                    "profit": (x[prof] - x[loss].fillna(0)).sum()}),
                include_groups=False)
            return pd.DataFrame({"channel": label, "id": g[idc], "sales": g.sales,
                                 "returns_": g.returns_, "profit": g.profit})

        sdf = chan(ss, t["store_returns"], ["ss_item_sk", "ss_ticket_number"],
                   ["sr_item_sk", "sr_ticket_number"], "ss_sold_date_sk",
                   "ss_item_sk", "ss_promo_sk", "ss_store_sk", t["store"],
                   "s_store_sk", "s_store_id", "ss_ext_sales_price",
                   "ss_net_profit", "sr_return_amt", "sr_net_loss", "store channel")
        cdf = chan(t["catalog_sales"], t["catalog_returns"],
                   ["cs_item_sk", "cs_order_number"], ["cr_item_sk", "cr_order_number"],
                   "cs_sold_date_sk", "cs_item_sk", "cs_promo_sk",
                   "cs_call_center_sk", t["call_center"], "cc_call_center_sk",
                   "cc_call_center_id", "cs_ext_sales_price", "cs_net_profit",
                   "cr_return_amt", "cr_net_loss", "catalog channel")
        wdf = chan(t["web_sales"], t["web_returns"], ["ws_item_sk", "ws_order_number"],
                   ["wr_item_sk", "wr_order_number"], "ws_sold_date_sk",
                   "ws_item_sk", "ws_promo_sk", "ws_web_site_sk", t["web_site"],
                   "web_site_sk", "web_site_id", "ws_ext_sales_price",
                   "ws_net_profit", "wr_return_amt", "wr_net_loss", "web channel")
        u = pd.concat([sdf, cdf, wdf], ignore_index=True)
        out = _rollup(u, ["channel", "id"], ["sales", "returns_", "profit"], "sum")
        out = out.drop(columns=["lochierarchy"])
        return out[["channel", "id", "sales", "returns_", "profit"]].sort_values(
            ["channel", "id"], na_position="last").head(100).reset_index(drop=True)
    if q == 14:
        def brand_sets(fact, ikey, dkey):
            mm = fact.merge(dd[(dd.d_year >= 1999) & (dd.d_year <= 2001)][["d_date_sk"]],
                            left_on=dkey, right_on="d_date_sk")
            mm = mm.merge(it[["i_item_sk", "i_brand_id", "i_class_id", "i_category_id"]],
                          left_on=ikey, right_on="i_item_sk")
            return set(map(tuple, mm[["i_brand_id", "i_class_id", "i_category_id"]]
                           .drop_duplicates().values))

        common = (brand_sets(ss, "ss_item_sk", "ss_sold_date_sk")
                  & brand_sets(t["catalog_sales"], "cs_item_sk", "cs_sold_date_sk")
                  & brand_sets(t["web_sales"], "ws_item_sk", "ws_sold_date_sk"))
        trip = it[["i_item_sk", "i_brand_id", "i_class_id", "i_category_id"]].copy()
        cross_items = set(trip[[tuple(r) in common for r in
                                trip[["i_brand_id", "i_class_id", "i_category_id"]].values]]
                          .i_item_sk)
        ql = []
        for fact, qty, lp, dkey in ((ss, "ss_quantity", "ss_list_price", "ss_sold_date_sk"),
                                    (t["catalog_sales"], "cs_quantity", "cs_list_price", "cs_sold_date_sk"),
                                    (t["web_sales"], "ws_quantity", "ws_list_price", "ws_sold_date_sk")):
            mm = fact.merge(dd[(dd.d_year >= 1999) & (dd.d_year <= 2001)][["d_date_sk"]],
                            left_on=dkey, right_on="d_date_sk")
            ql.append(mm[qty] * mm[lp])
        average_sales = pd.concat(ql, ignore_index=True).mean()
        frames = []
        for label, fact, ikey, qty, lp, dkey in (
            ("store", ss, "ss_item_sk", "ss_quantity", "ss_list_price", "ss_sold_date_sk"),
            ("catalog", t["catalog_sales"], "cs_item_sk", "cs_quantity", "cs_list_price", "cs_sold_date_sk"),
            ("web", t["web_sales"], "ws_item_sk", "ws_quantity", "ws_list_price", "ws_sold_date_sk"),
        ):
            mm = fact[fact[ikey].isin(cross_items)]
            mm = mm.merge(dd[(dd.d_year == 2001) & (dd.d_moy == 11)][["d_date_sk"]],
                          left_on=dkey, right_on="d_date_sk")
            mm = mm.merge(it[["i_item_sk", "i_brand_id", "i_class_id", "i_category_id"]],
                          left_on=ikey, right_on="i_item_sk")
            mm["v"] = mm[qty] * mm[lp]
            g = mm.groupby(["i_brand_id", "i_class_id", "i_category_id"],
                           as_index=False).agg(sales=("v", "sum"), number_sales=("v", "size"))
            g = g[g.sales > average_sales]
            g.insert(0, "channel", label)
            frames.append(g)
        u = pd.concat(frames, ignore_index=True)
        out = _rollup(u, ["channel", "i_brand_id", "i_class_id", "i_category_id"],
                      ["sales", "number_sales"], "sum").drop(columns=["lochierarchy"])
        out = out[["channel", "i_brand_id", "i_class_id", "i_category_id",
                   "sales", "number_sales"]]
        return out.sort_values(["channel", "i_brand_id", "i_class_id", "i_category_id"],
                               na_position="last").head(100).reset_index(drop=True)
    if q == 24:
        sr, st, cu, ca = t["store_returns"], t["store"], t["customer"], t["customer_address"]
        m = ss.merge(sr[["sr_ticket_number", "sr_item_sk"]],
                     left_on=["ss_ticket_number", "ss_item_sk"],
                     right_on=["sr_ticket_number", "sr_item_sk"])
        m = m.merge(st[st.s_market_id == 8], left_on="ss_store_sk", right_on="s_store_sk")
        m = m.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
        m = m.merge(cu, left_on="ss_customer_sk", right_on="c_customer_sk")
        m = m.merge(ca, left_on="c_current_addr_sk", right_on="ca_address_sk")
        m = m[(m.c_birth_country != m.ca_country.str.upper()) & (m.s_zip == m.ca_zip)]
        keys = ["c_last_name", "c_first_name", "s_store_name", "ca_state", "s_state",
                "i_color", "i_current_price", "i_manager_id", "i_units", "i_size"]
        ssales = m.groupby(keys, as_index=False).agg(netpaid=("ss_net_paid", "sum"))
        thresh = 0.05 * ssales.netpaid.mean()
        peach = ssales[ssales.i_color == "peach"]
        g = peach.groupby(["c_last_name", "c_first_name", "s_store_name"],
                          as_index=False).agg(paid=("netpaid", "sum"))
        g = g[g.paid > thresh]
        return g.sort_values(["c_last_name", "c_first_name", "s_store_name"]
                             ).reset_index(drop=True)
    if q == 72:
        cs, inv, wh = t["catalog_sales"], t["inventory"], t["warehouse"]
        cd, hd, pr, cr = (t["customer_demographics"], t["household_demographics"],
                          t["promotion"], t["catalog_returns"])
        m = cs.merge(dd[dd.d_year == 1999][["d_date_sk", "d_week_seq", "d_date"]]
                     .rename(columns={"d_date_sk": "d1_sk", "d_week_seq": "wk1",
                                      "d_date": "date1"}),
                     left_on="cs_sold_date_sk", right_on="d1_sk")
        m = m.merge(cd[cd.cd_marital_status == "D"][["cd_demo_sk"]],
                    left_on="cs_bill_cdemo_sk", right_on="cd_demo_sk")
        m = m.merge(hd[hd.hd_buy_potential == ">10000"][["hd_demo_sk"]],
                    left_on="cs_bill_hdemo_sk", right_on="hd_demo_sk")
        m = m.merge(dd[["d_date_sk", "d_date"]].rename(
            columns={"d_date_sk": "d3_sk", "d_date": "date3"}),
            left_on="cs_ship_date_sk", right_on="d3_sk")
        m = m[[d3 > d1 + dt.timedelta(days=5)
               for d1, d3 in zip(m.date1, m.date3)]]
        m = m.merge(inv, left_on="cs_item_sk", right_on="inv_item_sk")
        m = m.merge(dd[["d_date_sk", "d_week_seq"]].rename(
            columns={"d_date_sk": "d2_sk", "d_week_seq": "wk2"}),
            left_on="inv_date_sk", right_on="d2_sk")
        m = m[(m.wk1 == m.wk2) & (m.inv_quantity_on_hand < m.cs_quantity)]
        m = m.merge(wh[["w_warehouse_sk", "w_warehouse_name"]],
                    left_on="inv_warehouse_sk", right_on="w_warehouse_sk")
        m = m.merge(it[["i_item_sk", "i_item_desc"]], left_on="cs_item_sk",
                    right_on="i_item_sk")
        m = m.merge(pr[["p_promo_sk"]], left_on="cs_promo_sk", right_on="p_promo_sk",
                    how="left")
        m = m.merge(cr[["cr_item_sk", "cr_order_number"]],
                    left_on=["cs_item_sk", "cs_order_number"],
                    right_on=["cr_item_sk", "cr_order_number"], how="left")
        g = m.groupby(["i_item_desc", "w_warehouse_name", "wk1"], as_index=False).agg(
            no_promo=("p_promo_sk", lambda s: int(s.isna().sum())),
            promo=("p_promo_sk", lambda s: int(s.notna().sum())),
            total_cnt=("p_promo_sk", "size"))
        out = g.rename(columns={"wk1": "d_week_seq"})
        return out.sort_values(["total_cnt", "i_item_desc", "w_warehouse_name",
                                "d_week_seq"], ascending=[False, True, True, True]
                               ).head(100).reset_index(drop=True)
    if q == 64:
        cs, cr, sr = t["catalog_sales"], t["catalog_returns"], t["store_returns"]
        st, cu, ca = t["store"], t["customer"], t["customer_address"]
        cd, hd, pr, ib = (t["customer_demographics"], t["household_demographics"],
                          t["promotion"], t["income_band"])
        ui = cs.merge(cr, left_on=["cs_item_sk", "cs_order_number"],
                      right_on=["cr_item_sk", "cr_order_number"])
        ui["refund"] = ui.cr_return_amt + ui.cr_net_loss
        g = ui.groupby("cs_item_sk", as_index=False).agg(
            sale=("cs_ext_list_price", "sum"), refund=("refund", "sum"))
        cs_ui_items = set(g[g.sale > 2 * g.refund].cs_item_sk)

        itf = it[(it.i_color.isin(["maroon", "burnished", "dim", "frosted",
                                   "papaya", "peach"]))
                 & (it.i_current_price >= 65) & (it.i_current_price <= 74)]
        m = ss.merge(sr[["sr_item_sk", "sr_ticket_number"]],
                     left_on=["ss_item_sk", "ss_ticket_number"],
                     right_on=["sr_item_sk", "sr_ticket_number"])
        m = m[m.ss_item_sk.isin(cs_ui_items)]
        m = m.merge(itf[["i_item_sk", "i_product_name"]], left_on="ss_item_sk",
                    right_on="i_item_sk")
        m = m.merge(st[["s_store_sk", "s_store_name", "s_zip"]],
                    left_on="ss_store_sk", right_on="s_store_sk")
        m = m.merge(dd[["d_date_sk", "d_year"]].rename(
            columns={"d_date_sk": "d1", "d_year": "syear"}),
            left_on="ss_sold_date_sk", right_on="d1")
        m = m.merge(cu[["c_customer_sk", "c_current_cdemo_sk", "c_current_hdemo_sk",
                        "c_current_addr_sk", "c_first_sales_date_sk",
                        "c_first_shipto_date_sk"]],
                    left_on="ss_customer_sk", right_on="c_customer_sk")
        m = m.merge(cd[["cd_demo_sk", "cd_marital_status"]].add_prefix("x1_"),
                    left_on="ss_cdemo_sk", right_on="x1_cd_demo_sk")
        m = m.merge(cd[["cd_demo_sk", "cd_marital_status"]].add_prefix("x2_"),
                    left_on="c_current_cdemo_sk", right_on="x2_cd_demo_sk")
        m = m[m.x1_cd_marital_status != m.x2_cd_marital_status]
        m = m.merge(hd[["hd_demo_sk", "hd_income_band_sk"]].add_prefix("h1_"),
                    left_on="ss_hdemo_sk", right_on="h1_hd_demo_sk")
        m = m.merge(hd[["hd_demo_sk", "hd_income_band_sk"]].add_prefix("h2_"),
                    left_on="c_current_hdemo_sk", right_on="h2_hd_demo_sk")
        m = m.merge(ib[["ib_income_band_sk"]].add_prefix("b1_"),
                    left_on="h1_hd_income_band_sk", right_on="b1_ib_income_band_sk")
        m = m.merge(ib[["ib_income_band_sk"]].add_prefix("b2_"),
                    left_on="h2_hd_income_band_sk", right_on="b2_ib_income_band_sk")
        m = m.merge(ca.add_prefix("a1_"), left_on="ss_addr_sk",
                    right_on="a1_ca_address_sk")
        m = m.merge(ca.add_prefix("a2_"), left_on="c_current_addr_sk",
                    right_on="a2_ca_address_sk")
        m = m.merge(pr[["p_promo_sk"]], left_on="ss_promo_sk", right_on="p_promo_sk")
        m = m.merge(dd[["d_date_sk", "d_year"]].rename(
            columns={"d_date_sk": "d2", "d_year": "fsyear"}),
            left_on="c_first_sales_date_sk", right_on="d2")
        m = m.merge(dd[["d_date_sk", "d_year"]].rename(
            columns={"d_date_sk": "d3", "d_year": "s2year"}),
            left_on="c_first_shipto_date_sk", right_on="d3")
        keys = ["i_product_name", "ss_item_sk", "s_store_name", "s_zip",
                "a1_ca_street_number", "a1_ca_street_name", "a1_ca_zip",
                "a2_ca_street_number", "a2_ca_street_name", "a2_ca_zip",
                "syear", "fsyear", "s2year"]
        cross = m.groupby(keys, as_index=False).agg(
            cnt=("ss_item_sk", "size"), s1=("ss_wholesale_cost", "sum"),
            s2=("ss_list_price", "sum"), s3=("ss_coupon_amt", "sum"))
        c1 = cross[cross.syear == 1999]
        c2 = cross[cross.syear == 2000]
        j = c1.merge(c2, left_on=["ss_item_sk", "s_store_name", "s_zip"],
                     right_on=["ss_item_sk", "s_store_name", "s_zip"],
                     suffixes=("", "_2"))
        j = j[j.cnt_2 <= j.cnt]
        out = pd.DataFrame({
            "product_name": j.i_product_name, "store_name": j.s_store_name,
            "store_zip": j.s_zip, "b_street_number": j.a1_ca_street_number,
            "b_street_name": j.a1_ca_street_name, "b_zip": j.a1_ca_zip,
            "c_street_number": j.a2_ca_street_number,
            "c_street_name": j.a2_ca_street_name, "c_zip": j.a2_ca_zip,
            "syear": j.syear, "cnt": j.cnt, "s11": j.s1, "s21": j.s2,
            "s31": j.s3, "s12": j.s1_2, "s22": j.s2_2, "s32": j.s3_2,
            "syear2": j.syear_2, "cnt2": j.cnt_2})
        return out.sort_values(["product_name", "store_name", "cnt2", "s11", "s12"]
                               ).head(100).reset_index(drop=True)
    raise ValueError(f"no oracle for q{q}")


# queries whose LIMIT can cut through ties: only the ORDER BY key columns
# are deterministic, so the comparison restricts to them
TIE_KEYS = {73: ["cnt", "c_last_name"]}


def compare_results(engine_table, ref: pd.DataFrame, q: int) -> list[str]:
    """Column-by-column comparison after aligning on a full sort. For
    queries in TIE_KEYS, compares the ORDER BY key multiset only (rows
    beyond the keys are tie-broken arbitrarily by any conforming engine)."""
    problems = []
    out = engine_table.to_pandas()
    if len(out.columns) != len(ref.columns):
        return [f"q{q}: column count {len(out.columns)} != {len(ref.columns)}"]
    if len(out) != len(ref):
        return [f"q{q}: row count {len(out)} != {len(ref)}"]
    if len(ref) == 0:
        return []
    r = ref.copy()
    r.columns = list(out.columns)  # positional: engine aliases win
    if q in TIE_KEYS:
        keys = TIE_KEYS[q]
        out = out[keys]
        r = r[keys]
    o = out.sort_values(list(out.columns), kind="stable").reset_index(drop=True)
    r = r.sort_values(list(r.columns), kind="stable").reset_index(drop=True)
    for c in o.columns:
        sa, sb = o[c], r[c]
        na_a, na_b = pd.isna(sa).values, pd.isna(sb).values
        a, b = sa.values, sb.values
        try:
            if not (na_a == na_b).all():
                ok = False
            elif np.asarray(a).dtype.kind == "f" or np.asarray(b).dtype.kind == "f":
                ok = np.allclose(
                    np.asarray(a, float), np.asarray(b, float),
                    rtol=1e-6, atol=1e-6, equal_nan=True,
                )
            else:
                # nulls already matched positionally; compare the rest
                # (None vs np.nan representations must not differ)
                ok = (a[~na_a] == b[~na_b]).all()
        except (TypeError, ValueError):
            ok = list(a) == list(b)
        if not ok:
            problems.append(f"q{q}: column {c} mismatch")
    return problems
