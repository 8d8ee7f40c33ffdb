"""Seeded synthetic TPC-DS data generator (core retail-sales tables).

Schema-faithful (column names/types the query set references) rebuild of
the reference's tpcds benchmark data leg (benchmarks/src/bin/tpcds.rs uses
externally generated data; zero-egress here, so we generate). Value
distributions are simplified but seeded and referentially intact: every
store_sales foreign key resolves, dates cover 1998-2002 with proper
year/moy/dom breakdowns.

Scale: `scale=1.0` ≈ 300k store_sales rows (tunable; the point is plan
shape + correctness, perf scaling comes from --scale).
"""

from __future__ import annotations

import datetime as dt
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

BRANDS = [f"brand#{i}" for i in range(1, 61)]
CATEGORIES = ["Sports", "Books", "Home", "Electronics", "Jewelry", "Men", "Women",
              "Music", "Children", "Shoes"]
CLASSES = [f"class#{i}" for i in range(1, 31)]
CITIES = ["Midway", "Fairview", "Oak Grove", "Five Points", "Centerville",
          "Liberty", "Pleasant Hill", "Union", "Salem", "Georgetown"]
COUNTIES = [f"{c} County" for c in ("Williamson", "Walker", "Ziebach", "Daviess",
                                    "Barrow", "Franklin", "Luce", "Richland")]
STATES = ["TN", "TX", "SD", "IN", "GA", "OH", "MI", "MT", "CA", "NY"]
BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000", "0-500", "Unknown"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
             "Advanced Degree", "Unknown"]
DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday"]
ITEM_COLORS = ["maroon", "burnished", "dim", "frosted", "papaya", "peach",
               "orchid", "pale", "metallic", "lace", "chiffon", "smoke"]
ITEM_SIZES = ["small", "medium", "large", "extra large", "petite", "N/A"]
ITEM_UNITS = ["Ounce", "Oz", "Bunch", "Ton", "Each", "Pound", "Pallet",
              "Gross", "Cup", "Dram", "Bundle"]
CREDIT_RATINGS = ["Low Risk", "Good", "High Risk", "Unknown"]
STREET_TYPES = ["Street", "Ave", "Blvd", "Court", "Drive", "Lane", "Parkway", "Way"]
LOCATION_TYPES = ["apartment", "condo", "single family"]
# low-cardinality zip pool (spec zips repeat; q8's preferred-customer-count
# per zip is meaningless over unique random zips)
ZIP_POOL = [f"{z:05d}" for z in range(24000, 24600, 10)]


def generate_tpcds(out_dir: str, scale: float = 1.0, seed: int = 17,
                   files_per_table: int = 2) -> None:
    rng = np.random.default_rng(seed)
    n_sales = max(int(300_000 * scale), 1_000)
    n_items = max(int(2_000 * scale**0.5), 200)
    n_customers = max(int(10_000 * scale**0.5), 500)
    n_addresses = max(n_customers // 2, 250)
    n_stores = max(int(12 * scale**0.5), 6)
    n_cd = 1920  # cross of demographics like the spec
    n_hd = 720
    n_promos = 30

    # ---- date_dim: calendar 1998-01-01 .. 2002-12-31 --------------------
    start = dt.date(1998, 1, 1)
    days = (dt.date(2002, 12, 31) - start).days + 1
    dates = [start + dt.timedelta(days=i) for i in range(days)]
    # week_seq/month_seq: sequential like the spec (absolute origin arbitrary
    # but stable — queries only use differences and +/- offsets)
    date_dim = pa.table({
        "d_date_sk": pa.array(range(2450815, 2450815 + days), pa.int64()),
        "d_date": pa.array(dates, pa.date32()),
        "d_year": pa.array([d.year for d in dates], pa.int64()),
        "d_moy": pa.array([d.month for d in dates], pa.int64()),
        "d_dom": pa.array([d.day for d in dates], pa.int64()),
        "d_qoy": pa.array([(d.month - 1) // 3 + 1 for d in dates], pa.int64()),
        "d_dow": pa.array([d.isoweekday() % 7 for d in dates], pa.int64()),  # 0=Sunday
        "d_day_name": pa.array([DAY_NAMES[d.isoweekday() % 7] for d in dates]),
        "d_quarter_name": pa.array([f"{d.year}Q{(d.month - 1) // 3 + 1}" for d in dates]),
        "d_week_seq": pa.array(
            [5270 + ((d - start).days + start.isoweekday() % 7) // 7 for d in dates],
            pa.int64()),
        "d_month_seq": pa.array(
            [1176 + (d.year - 1998) * 12 + d.month - 1 for d in dates], pa.int64()),
    })

    # ---- time_dim --------------------------------------------------------
    secs = np.arange(0, 86400, 60)  # minute granularity keeps it small
    hours = secs // 3600
    meal = np.where(
        (hours >= 6) & (hours <= 8), "breakfast",
        np.where((hours >= 17) & (hours <= 20), "dinner", ""))
    time_dim = pa.table({
        "t_time_sk": pa.array(secs, pa.int64()),
        "t_time": pa.array(secs, pa.int64()),  # seconds since midnight (spec)
        "t_hour": pa.array(hours, pa.int64()),
        "t_minute": pa.array((secs % 3600) // 60, pa.int64()),
        "t_meal_time": pa.array(meal),
    })

    # ---- item ------------------------------------------------------------
    brand_ids = rng.integers(1, 1000, n_items)
    cat_ids = rng.integers(0, len(CATEGORIES), n_items)
    class_ids = rng.integers(0, len(CLASSES), n_items)
    item = pa.table({
        "i_item_sk": pa.array(range(1, n_items + 1), pa.int64()),
        "i_item_id": pa.array([f"AAAAAAAA{i:08d}" for i in range(1, n_items + 1)]),
        "i_item_desc": pa.array([f"item description {i}" for i in range(1, n_items + 1)]),
        "i_brand_id": pa.array(brand_ids, pa.int64()),
        "i_brand": pa.array([BRANDS[b % len(BRANDS)] for b in brand_ids]),
        "i_category_id": pa.array(cat_ids + 1, pa.int64()),
        "i_category": pa.array([CATEGORIES[c] for c in cat_ids]),
        "i_class_id": pa.array(class_ids + 1, pa.int64()),
        "i_class": pa.array([CLASSES[c] for c in class_ids]),
        "i_manufact_id": pa.array(rng.integers(1, 200, n_items), pa.int64()),
        "i_manager_id": pa.array(rng.integers(1, 100, n_items), pa.int64()),
        "i_current_price": pa.array(np.round(rng.uniform(0.5, 300, n_items), 2)),
        "i_wholesale_cost": pa.array(np.round(rng.uniform(0.5, 100, n_items), 2)),
        # attribute columns (separate stream keeps prior draws stable)
        **(lambda r: {
            "i_product_name": pa.array([f"product#{i}" for i in range(1, n_items + 1)]),
            "i_manufact": pa.array([f"manufact#{m}" for m in r.integers(1, 100, n_items)]),
            "i_color": pa.array(r.choice(ITEM_COLORS, n_items)),
            "i_size": pa.array(r.choice(ITEM_SIZES, n_items)),
            "i_units": pa.array(r.choice(ITEM_UNITS, n_items)),
            "i_container": pa.array(["Unknown"] * n_items),
        })(np.random.default_rng(seed + 11)),
    })

    # ---- store -----------------------------------------------------------
    store = pa.table({
        "s_store_sk": pa.array(range(1, n_stores + 1), pa.int64()),
        "s_store_id": pa.array([f"AAAAAAAA{i:04d}BAAA" for i in range(1, n_stores + 1)]),
        "s_store_name": pa.array([f"store {i}" for i in range(1, n_stores + 1)]),
        "s_number_employees": pa.array(rng.integers(200, 300, n_stores), pa.int64()),
        # cyclic assignment: the city/county/offset values the query set
        # filters on must exist at EVERY scale (a random draw of 6 stores
        # can miss 'Williamson County' and silently zero out q34/q73)
        "s_city": pa.array([CITIES[i % len(CITIES)] for i in range(n_stores)]),
        "s_county": pa.array([COUNTIES[i % len(COUNTIES)] for i in range(n_stores)]),
        "s_state": pa.array([STATES[i % len(STATES)] for i in range(n_stores)]),
        "s_zip": pa.array([ZIP_POOL[i * 7 % len(ZIP_POOL)] for i in range(n_stores)]),
        "s_gmt_offset": pa.array([[-5.0, -6.0, -7.0, -8.0][i % 4] for i in range(n_stores)]),
        "s_market_id": pa.array([i % 10 + 1 for i in range(n_stores)], pa.int64()),
        "s_company_id": pa.array([1] * n_stores, pa.int64()),
        "s_company_name": pa.array(["Unknown"] * n_stores),
        "s_street_number": pa.array([str(100 + i) for i in range(n_stores)]),
        "s_street_name": pa.array([f"Commerce {i}" for i in range(n_stores)]),
        "s_street_type": pa.array([STREET_TYPES[i % len(STREET_TYPES)] for i in range(n_stores)]),
        "s_suite_number": pa.array([f"Suite {i}" for i in range(n_stores)]),
    })

    # ---- demographics ----------------------------------------------------
    cd_idx = np.arange(n_cd)
    customer_demographics = pa.table({
        "cd_demo_sk": pa.array(cd_idx + 1, pa.int64()),
        "cd_gender": pa.array(np.where(cd_idx % 2 == 0, "M", "F")),
        "cd_marital_status": pa.array([["M", "S", "D", "W", "U"][i % 5] for i in cd_idx]),
        "cd_education_status": pa.array([EDUCATION[i % len(EDUCATION)] for i in cd_idx]),
        "cd_purchase_estimate": pa.array((cd_idx % 20 + 1) * 500, pa.int64()),
        "cd_credit_rating": pa.array([CREDIT_RATINGS[i % len(CREDIT_RATINGS)] for i in cd_idx]),
        "cd_dep_count": pa.array(cd_idx % 7, pa.int64()),
        "cd_dep_employed_count": pa.array(cd_idx % 5, pa.int64()),
        "cd_dep_college_count": pa.array(cd_idx % 4, pa.int64()),
    })
    hd_idx = np.arange(n_hd)
    household_demographics = pa.table({
        "hd_demo_sk": pa.array(hd_idx + 1, pa.int64()),
        "hd_income_band_sk": pa.array(hd_idx % 20 + 1, pa.int64()),
        "hd_buy_potential": pa.array([BUY_POTENTIAL[i % len(BUY_POTENTIAL)] for i in hd_idx]),
        "hd_dep_count": pa.array(hd_idx % 10, pa.int64()),
        "hd_vehicle_count": pa.array(hd_idx % 5, pa.int64()),
    })

    # ---- customer_address / customer ------------------------------------
    _ra = np.random.default_rng(seed + 12)
    # county/state follow the same cyclic pairing as stores, so the
    # "customer's county has a store" join (q54) is satisfiable
    _ca_idx = rng.integers(0, 10_000, n_addresses)
    customer_address = pa.table({
        "ca_address_sk": pa.array(range(1, n_addresses + 1), pa.int64()),
        "ca_city": pa.array(rng.choice(CITIES, n_addresses)),
        "ca_county": pa.array([COUNTIES[i % len(COUNTIES)] for i in _ca_idx]),
        "ca_state": pa.array([STATES[i % len(STATES)] for i in _ca_idx]),
        "ca_zip": pa.array(rng.choice(ZIP_POOL, n_addresses)),
        "ca_country": pa.array(["United States"] * n_addresses),
        "ca_gmt_offset": pa.array(rng.choice([-5.0, -6.0, -7.0, -8.0], n_addresses)),
        "ca_street_number": pa.array([str(x) for x in _ra.integers(1, 1000, n_addresses)]),
        "ca_street_name": pa.array([f"{a} {b}" for a, b in zip(
            _ra.choice(["Oak", "Main", "Elm", "Pine", "Maple"], n_addresses),
            _ra.choice(["Hill", "Ridge", "Park", "View", "Creek"], n_addresses))]),
        "ca_street_type": pa.array(_ra.choice(STREET_TYPES, n_addresses)),
        "ca_suite_number": pa.array([f"Suite {x}" for x in _ra.integers(0, 100, n_addresses)]),
        "ca_location_type": pa.array(_ra.choice(LOCATION_TYPES, n_addresses)),
    })
    customer = pa.table({
        "c_customer_sk": pa.array(range(1, n_customers + 1), pa.int64()),
        "c_customer_id": pa.array([f"AAAAAAAA{i:08d}" for i in range(1, n_customers + 1)]),
        "c_first_name": pa.array([f"First{i % 997}" for i in range(1, n_customers + 1)]),
        "c_last_name": pa.array([f"Last{i % 499}" for i in range(1, n_customers + 1)]),
        "c_salutation": pa.array([["Mr.", "Ms.", "Dr.", "Miss", "Sir"][i % 5]
                                  for i in range(1, n_customers + 1)]),
        "c_preferred_cust_flag": pa.array([["Y", "N"][i % 2] for i in range(1, n_customers + 1)]),
        "c_current_addr_sk": pa.array(rng.integers(1, n_addresses + 1, n_customers), pa.int64()),
        "c_current_cdemo_sk": pa.array(rng.integers(1, n_cd + 1, n_customers), pa.int64()),
        "c_current_hdemo_sk": pa.array(rng.integers(1, n_hd + 1, n_customers), pa.int64()),
        **(lambda r: {
            # mostly-domestic with a foreign tail: q24's
            # `c_birth_country <> upper(ca_country)` must be satisfiable
            "c_birth_country": pa.array(np.where(
                r.random(n_customers) < 0.9, "UNITED STATES", "CANADA")),
            "c_birth_day": pa.array(r.integers(1, 29, n_customers), pa.int64()),
            "c_birth_month": pa.array(r.integers(1, 13, n_customers), pa.int64()),
            "c_birth_year": pa.array(r.integers(1930, 1993, n_customers), pa.int64()),
            "c_email_address": pa.array(
                [f"c{i}@example.com" for i in range(1, n_customers + 1)]),
            "c_login": pa.array([f"login{i}" for i in range(1, n_customers + 1)]),
            "c_first_sales_date_sk": pa.array(
                r.integers(2450815, 2450815 + 365, n_customers), pa.int64()),
            "c_first_shipto_date_sk": pa.array(
                r.integers(2450815, 2450815 + 730, n_customers), pa.int64()),
        })(np.random.default_rng(seed + 13)),
    })

    # ---- promotion -------------------------------------------------------
    promotion = pa.table({
        "p_promo_sk": pa.array(range(1, n_promos + 1), pa.int64()),
        "p_promo_id": pa.array([f"AAAAAAAA{i:08d}" for i in range(1, n_promos + 1)]),
        "p_promo_name": pa.array([f"promo {i}" for i in range(1, n_promos + 1)]),
        "p_channel_email": pa.array(["N" if i % 3 else "Y" for i in range(n_promos)]),
        "p_channel_event": pa.array(["N" if i % 2 else "Y" for i in range(n_promos)]),
        "p_channel_tv": pa.array(["N" if i % 4 else "Y" for i in range(n_promos)]),
        "p_channel_dmail": pa.array(["N" if (i + 1) % 3 else "Y" for i in range(n_promos)]),
    })

    # ---- store_sales (the fact table) -----------------------------------
    qty = rng.integers(1, 101, n_sales)
    wholesale = np.round(rng.uniform(1, 100, n_sales), 2)
    list_price = np.round(wholesale * rng.uniform(1.0, 2.0, n_sales), 2)
    sales_price = np.round(list_price * rng.uniform(0.3, 1.0, n_sales), 2)
    ext_sales = np.round(sales_price * qty, 2)
    ext_list = np.round(list_price * qty, 2)
    ext_wholesale = np.round(wholesale * qty, 2)
    ext_discount = np.round(ext_list - ext_sales, 2)
    ext_tax = np.round(ext_sales * 0.06, 2)
    coupon = np.where(rng.random(n_sales) < 0.1, np.round(ext_sales * 0.1, 2), 0.0)
    net_paid = np.round(ext_sales - coupon, 2)
    net_profit = np.round(net_paid - ext_wholesale, 2)
    # tickets are BASKETS: every row of a ticket shares the visit's date,
    # time, store, customer, household and address (the ticket-grouping
    # queries — q34/q46/q68/q73/q79 — are meaningless over per-row noise)
    n_tickets = max(n_sales // 8, 100)
    tid = rng.integers(1, n_tickets + 1, n_sales)
    t_cust = rng.integers(1, n_customers + 1, n_tickets + 1)
    t_date = rng.integers(2450815, 2450815 + days, n_tickets + 1)
    t_time = rng.choice(secs, n_tickets + 1)
    t_store = rng.integers(1, n_stores + 1, n_tickets + 1)
    t_hdemo = rng.integers(1, n_hd + 1, n_tickets + 1)
    t_addr = rng.integers(1, n_addresses + 1, n_tickets + 1)
    # item popularity skew + a rotating per-day "deal item" taking ~15% of
    # that day's rows: frequent-item queries (q23/q14) group by (item, day)
    # with HAVING count>k — uniform draws never repeat within a day
    _rskew = np.random.default_rng(seed + 17)
    base_draw = np.minimum(
        (n_items * _rskew.power(3.0, n_sales)).astype(np.int64) + 1, n_items)
    deal_item = t_date[tid] % n_items + 1
    item_draw = np.where(_rskew.random(n_sales) < 0.15, deal_item, base_draw)
    store_sales = pa.table({
        "ss_sold_date_sk": pa.array(t_date[tid], pa.int64()),
        "ss_sold_time_sk": pa.array(t_time[tid], pa.int64()),
        "ss_item_sk": pa.array(item_draw, pa.int64()),
        "ss_customer_sk": pa.array(t_cust[tid], pa.int64()),
        "ss_cdemo_sk": pa.array(rng.integers(1, n_cd + 1, n_sales), pa.int64()),
        "ss_hdemo_sk": pa.array(t_hdemo[tid], pa.int64()),
        "ss_addr_sk": pa.array(t_addr[tid], pa.int64(),
                               mask=_rskew.random(n_sales) < 0.015),
        "ss_store_sk": pa.array(t_store[tid], pa.int64()),
        "ss_promo_sk": pa.array(rng.integers(1, n_promos + 1, n_sales), pa.int64()),
        "ss_ticket_number": pa.array(tid, pa.int64()),
        "ss_quantity": pa.array(qty, pa.int64()),
        "ss_wholesale_cost": pa.array(wholesale),
        "ss_list_price": pa.array(list_price),
        "ss_sales_price": pa.array(sales_price),
        "ss_ext_discount_amt": pa.array(ext_discount),
        "ss_ext_sales_price": pa.array(ext_sales),
        "ss_ext_wholesale_cost": pa.array(ext_wholesale),
        "ss_ext_list_price": pa.array(ext_list),
        "ss_ext_tax": pa.array(ext_tax),
        "ss_coupon_amt": pa.array(coupon),
        "ss_net_paid": pa.array(net_paid),
        "ss_net_profit": pa.array(net_profit),
    })

    # ---- small dims (warehouse / ship_mode / call_center / web_page /
    #      reason / income_band) — tiny static tables many queries join ----
    n_wh = 5
    warehouse = pa.table({
        "w_warehouse_sk": pa.array(range(1, n_wh + 1), pa.int64()),
        "w_warehouse_name": pa.array([f"Warehouse {i}" for i in range(1, n_wh + 1)]),
        "w_warehouse_sq_ft": pa.array(rng.integers(50_000, 1_000_000, n_wh), pa.int64()),
        "w_city": pa.array(rng.choice(CITIES, n_wh)),
        "w_county": pa.array(rng.choice(COUNTIES, n_wh)),
        "w_state": pa.array(rng.choice(STATES, n_wh)),
        "w_country": pa.array(["United States"] * n_wh),
    })
    sm_types = ["EXPRESS", "OVERNIGHT", "REGULAR", "TWO DAY", "LIBRARY"]
    ship_mode = pa.table({
        "sm_ship_mode_sk": pa.array(range(1, 21), pa.int64()),
        "sm_type": pa.array([sm_types[i % len(sm_types)] for i in range(20)]),
        "sm_code": pa.array([f"code{i % 4}" for i in range(20)]),
        "sm_carrier": pa.array([f"CARRIER{i % 6}" for i in range(20)]),
    })
    call_center = pa.table({
        "cc_call_center_sk": pa.array(range(1, 5), pa.int64()),
        "cc_call_center_id": pa.array([f"AAAAAAAA{i:04d}BAAA" for i in range(1, 5)]),
        "cc_name": pa.array([f"call center {i}" for i in range(1, 5)]),
        "cc_county": pa.array(rng.choice(COUNTIES, 4)),
        "cc_manager": pa.array([f"Manager{i}" for i in range(1, 5)]),
    })
    web_site = pa.table({
        "web_site_sk": pa.array(range(1, 7), pa.int64()),
        "web_site_id": pa.array([f"AAAAAAAA{i:04d}CAAA" for i in range(1, 7)]),
        "web_name": pa.array([f"site_{i}" for i in range(6)]),
        "web_company_name": pa.array([["pri", "sec", "third"][i % 3] for i in range(6)]),
    })
    web_page = pa.table({
        "wp_web_page_sk": pa.array(range(1, 41), pa.int64()),
        "wp_char_count": pa.array(rng.integers(100, 8000, 40), pa.int64()),
    })
    reason = pa.table({
        "r_reason_sk": pa.array(range(1, 36), pa.int64()),
        "r_reason_desc": pa.array([f"reason {i}" for i in range(1, 36)]),
    })
    income_band = pa.table({
        "ib_income_band_sk": pa.array(range(1, 21), pa.int64()),
        "ib_lower_bound": pa.array([i * 10_000 for i in range(20)], pa.int64()),
        "ib_upper_bound": pa.array([(i + 1) * 10_000 for i in range(20)], pa.int64()),
    })

    # ---- inventory -------------------------------------------------------
    # weekly snapshots per (warehouse, item) like the spec — the stddev/mean
    # queries (q21/q22/q39) need several observations per (item, wh, month),
    # which random-sparse rows never give
    n_inv_items = min(max(int(200 * scale), 40), n_items)
    week_starts = np.arange(0, days, 7)
    inv_items = np.arange(1, n_inv_items + 1)
    grid_wh, grid_item, grid_week = np.meshgrid(
        np.arange(1, n_wh + 1), inv_items, week_starts, indexing="ij")
    _ri = np.random.default_rng(seed + 14)
    inventory = pa.table({
        "inv_date_sk": pa.array(2450815 + grid_week.ravel(), pa.int64()),
        "inv_item_sk": pa.array(grid_item.ravel(), pa.int64()),
        "inv_warehouse_sk": pa.array(grid_wh.ravel(), pa.int64()),
        "inv_quantity_on_hand": pa.array(
            _ri.integers(0, 1000, grid_week.size), pa.int64()),
    })

    # ---- catalog_sales / web_sales (cross-channel queries) ---------------
    def channel_fact(prefix: str, rows: int, seed_off: int) -> pa.Table:
        r = np.random.default_rng(seed + seed_off)
        cqty = r.integers(1, 101, rows)
        cwhole = np.round(r.uniform(1, 100, rows), 2)
        clist = np.round(cwhole * r.uniform(1.0, 2.0, rows), 2)
        cprice = np.round(clist * r.uniform(0.3, 1.0, rows), 2)
        ext = np.round(cprice * cqty, 2)
        ext_list = np.round(clist * cqty, 2)
        coupon = np.where(r.random(rows) < 0.1, np.round(ext * 0.1, 2), 0.0)
        sold = r.integers(2450815, 2450815 + days, rows)
        cols = {
            f"{prefix}_sold_date_sk": pa.array(sold, pa.int64()),
            f"{prefix}_ship_date_sk": pa.array(sold + r.integers(1, 120, rows), pa.int64()),
            f"{prefix}_sold_time_sk": pa.array(r.choice(secs, rows), pa.int64()),
            f"{prefix}_item_sk": pa.array(r.integers(1, n_items + 1, rows), pa.int64()),
            f"{prefix}_bill_customer_sk": pa.array(r.integers(1, n_customers + 1, rows), pa.int64()),
            f"{prefix}_bill_cdemo_sk": pa.array(r.integers(1, n_cd + 1, rows), pa.int64()),
            f"{prefix}_bill_hdemo_sk": pa.array(r.integers(1, n_hd + 1, rows), pa.int64()),
            f"{prefix}_bill_addr_sk": pa.array(r.integers(1, n_addresses + 1, rows), pa.int64()),
            f"{prefix}_promo_sk": pa.array(r.integers(1, n_promos + 1, rows), pa.int64()),
            f"{prefix}_order_number": pa.array(r.integers(1, rows // 2 + 2, rows), pa.int64()),
            f"{prefix}_warehouse_sk": pa.array(r.integers(1, n_wh + 1, rows), pa.int64()),
            f"{prefix}_ship_mode_sk": pa.array(r.integers(1, 21, rows), pa.int64()),
            f"{prefix}_quantity": pa.array(cqty, pa.int64()),
            f"{prefix}_wholesale_cost": pa.array(cwhole),
            f"{prefix}_list_price": pa.array(clist),
            f"{prefix}_sales_price": pa.array(cprice),
            f"{prefix}_coupon_amt": pa.array(coupon),
            f"{prefix}_ext_sales_price": pa.array(ext),
            f"{prefix}_ext_list_price": pa.array(ext_list),
            f"{prefix}_ext_discount_amt": pa.array(np.round(ext_list - ext, 2)),
            f"{prefix}_ext_ship_cost": pa.array(np.round(ext * r.uniform(0.01, 0.2, rows), 2)),
            f"{prefix}_net_paid": pa.array(np.round(ext - coupon, 2)),
            f"{prefix}_net_profit": pa.array(np.round(ext * r.uniform(-0.2, 0.4, rows), 2)),
        }
        def _with_nulls(vals: np.ndarray, frac: float) -> pa.Array:
            # sparse NULL foreign keys (the spec has them; q76-style queries
            # count them, join queries must drop them consistently)
            mask = r.random(rows) < frac
            return pa.array(vals, pa.int64(), mask=mask)

        if prefix == "cs":
            cols["cs_call_center_sk"] = pa.array(r.integers(1, 5, rows), pa.int64())
            cols["cs_ship_customer_sk"] = pa.array(
                r.integers(1, n_customers + 1, rows), pa.int64())
            cols["cs_ship_addr_sk"] = _with_nulls(
                r.integers(1, n_addresses + 1, rows), 0.02)
        if prefix == "ws":
            cols["ws_web_page_sk"] = pa.array(r.integers(1, 41, rows), pa.int64())
            cols["ws_ship_hdemo_sk"] = pa.array(r.integers(1, n_hd + 1, rows), pa.int64())
            cols["ws_web_site_sk"] = pa.array(r.integers(1, 7, rows), pa.int64())
            cols["ws_ship_addr_sk"] = pa.array(r.integers(1, n_addresses + 1, rows), pa.int64())
            cols["ws_ship_customer_sk"] = _with_nulls(
                r.integers(1, n_customers + 1, rows), 0.02)
        return pa.table(cols)

    catalog_sales = channel_fact("cs", max(n_sales // 2, 500), 101)
    web_sales = channel_fact("ws", max(n_sales // 4, 500), 202)

    # cross-channel correlation: a third of catalog/web purchases come from
    # (customer, item) pairs seen in store_sales — without this, queries
    # that chain store → returns → catalog (q17/q25/q29) or compare a
    # customer's channels (q4/q11) join near-empty sets at test scales
    def _correlate(fact: pa.Table, prefix: str, seed_off: int) -> pa.Table:
        r = np.random.default_rng(seed + seed_off)
        n = fact.num_rows
        src = r.integers(0, n_sales, n)
        take = r.random(n) < 0.33
        cust = np.where(take, t_cust[tid][src], fact.column(f"{prefix}_bill_customer_sk").to_numpy())
        item = np.where(take, store_sales.column("ss_item_sk").to_numpy()[src],
                        fact.column(f"{prefix}_item_sk").to_numpy())
        cols = {c: fact.column(c) for c in fact.column_names}
        cols[f"{prefix}_bill_customer_sk"] = pa.array(cust, pa.int64())
        cols[f"{prefix}_item_sk"] = pa.array(item, pa.int64())
        return pa.table(cols)

    catalog_sales = _correlate(catalog_sales, "cs", 15)
    web_sales = _correlate(web_sales, "ws", 16)

    # ---- returns: seeded subsets of the sales facts ----------------------
    def returns_of(sales: pa.Table, prefix: str, src_prefix: str, frac: float,
                   seed_off: int, extra: dict | None = None) -> pa.Table:
        r = np.random.default_rng(seed + seed_off)
        n = sales.num_rows
        sel = np.sort(r.choice(n, max(int(n * frac), 50), replace=False))
        sub = sales.take(pa.array(sel))
        rq = np.maximum(1, (sub.column(f"{src_prefix}_quantity").to_numpy() *
                            r.uniform(0.1, 1.0, len(sel))).astype(np.int64))
        price = sub.column(f"{src_prefix}_sales_price").to_numpy()
        amt = np.round(price * rq, 2)
        sold = sub.column(f"{src_prefix}_sold_date_sk").to_numpy()
        cols = {
            f"{prefix}_returned_date_sk": pa.array(
                np.minimum(sold + r.integers(1, 90, len(sel)), 2450815 + days - 1), pa.int64()),
            f"{prefix}_item_sk": sub.column(f"{src_prefix}_item_sk"),
            f"{prefix}_return_quantity": pa.array(rq, pa.int64()),
            f"{prefix}_return_amt": pa.array(amt),
            f"{prefix}_net_loss": pa.array(np.round(amt * r.uniform(0.0, 0.5, len(sel)), 2)),
            f"{prefix}_reason_sk": pa.array(r.integers(1, 36, len(sel)), pa.int64()),
        }
        for name, src_col in (extra or {}).items():
            cols[name] = sub.column(src_col)
        return pa.table(cols)

    store_returns = returns_of(store_sales, "sr", "ss", 0.10, 303, {
        "sr_customer_sk": "ss_customer_sk", "sr_ticket_number": "ss_ticket_number",
        "sr_store_sk": "ss_store_sk", "sr_cdemo_sk": "ss_cdemo_sk",
    })
    catalog_returns = returns_of(catalog_sales, "cr", "cs", 0.20, 404, {
        "cr_order_number": "cs_order_number",
        "cr_returning_customer_sk": "cs_bill_customer_sk",
        "cr_returning_addr_sk": "cs_bill_addr_sk",
        "cr_call_center_sk": "cs_call_center_sk",
    })
    web_returns = returns_of(web_sales, "wr", "ws", 0.20, 505, {
        "wr_order_number": "ws_order_number",
        "wr_returning_customer_sk": "ws_bill_customer_sk",
        "wr_returning_cdemo_sk": "ws_bill_cdemo_sk",
        "wr_refunded_cdemo_sk": "ws_bill_cdemo_sk",
        "wr_refunded_addr_sk": "ws_bill_addr_sk",
        "wr_web_page_sk": "ws_web_page_sk",
    })
    _rwr = np.random.default_rng(seed + 18)
    _wr_amt = web_returns.column("wr_return_amt").to_numpy()
    web_returns = web_returns.append_column(
        "wr_fee", pa.array(np.round(_rwr.uniform(0.5, 100.0, len(_wr_amt)), 2)))
    web_returns = web_returns.append_column(
        "wr_refund_cash",
        pa.array(np.round(_wr_amt * _rwr.uniform(0.2, 1.0, len(_wr_amt)), 2)))

    tables = {
        "date_dim": date_dim, "time_dim": time_dim, "item": item, "store": store,
        "customer": customer, "customer_address": customer_address,
        "customer_demographics": customer_demographics,
        "household_demographics": household_demographics,
        "promotion": promotion, "store_sales": store_sales,
        "catalog_sales": catalog_sales, "web_sales": web_sales,
        "store_returns": store_returns, "catalog_returns": catalog_returns,
        "web_returns": web_returns, "inventory": inventory,
        "warehouse": warehouse, "ship_mode": ship_mode, "call_center": call_center,
        "web_page": web_page, "reason": reason, "income_band": income_band,
        "web_site": web_site,
    }
    for name, tbl in tables.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        nfiles = files_per_table if name.endswith("_sales") else 1
        rows_per = (tbl.num_rows + nfiles - 1) // nfiles
        for i in range(nfiles):
            part = tbl.slice(i * rows_per, rows_per)
            pq.write_table(part, os.path.join(d, f"part-{i}.parquet"))


TPCDS_TABLES = [
    "date_dim", "time_dim", "item", "store", "customer", "customer_address",
    "customer_demographics", "household_demographics", "promotion", "store_sales",
    "catalog_sales", "web_sales", "store_returns", "catalog_returns",
    "web_returns", "inventory", "warehouse", "ship_mode", "call_center",
    "web_page", "reason", "income_band", "web_site",
]


def register_tpcds(ctx, data_dir: str) -> None:
    for t in TPCDS_TABLES:
        ctx.register_parquet(t, os.path.join(data_dir, t))
