"""Deterministic TPC-H data generator (dbgen-shaped).

The reference generates benchmark data with tpchgen-cli
(.github/workflows/tpch.yml) and registers parquet tables
(benchmarks/src/bin/tpch.rs). We can't ship dbgen, so this module generates
spec-shaped data directly with numpy/pyarrow:

- exact table cardinalities per scale factor,
- the key relationships queries join on (partsupp's 4-suppliers-per-part
  formula so lineitem (partkey,suppkey) pairs exist in partsupp),
- the value distributions the 22 queries' predicates select on (dates,
  segments, types, brands, containers, ship modes, comment tokens like
  'special requests' / 'Customer Complaints', color-word part names),
- monetary columns as float64 (engine-wide decimal policy for v1; the TPU
  engine re-encodes to int64 cents on device for exact aggregation).

Not a bit-exact dbgen clone: comments/addresses are abbreviated. Expected
query answers are computed by the pandas reference executor in
ballista_tpu_torch.testing.reference, so correctness checks are self-consistent
the same way the reference's "verify expected results" CI leg is.
"""

from __future__ import annotations

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

STARTDATE = np.datetime64("1992-01-01")
ENDDATE = np.datetime64("1998-12-31")
CURRENTDATE = np.datetime64("1995-06-17")

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn", "lemon",
    "light", "lime", "linen", "magenta", "maroon", "medium", "metallic", "midnight",
    "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange", "orchid",
    "pale", "papaya", "peach", "peru", "pink", "plum", "powder", "puff", "purple",
    "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
    "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]
WORDS = (
    "carefully regular instructions sleep blithely final deposits haggle quickly "
    "express packages cajole furiously silent requests boost even ideas nag ironic "
    "accounts wake slyly pending theodolites integrate daringly bold pinto beans "
    "above the unusual foxes detect along platelets across fluffily busy dependencies"
).split()


def _take(choices: list[str], idx: np.ndarray) -> pa.Array:
    return pa.DictionaryArray.from_arrays(
        pa.array(idx.astype(np.int32)), pa.array(choices)
    ).cast(pa.string())


def _comments(rng: np.random.Generator, n: int, nwords: int = 5, inject: str | None = None,
              inject_rate: float = 0.0) -> pa.Array:
    import pyarrow.compute as pc

    cols = [_take(WORDS, rng.integers(0, len(WORDS), n)) for _ in range(nwords)]
    out = pc.binary_join_element_wise(*cols, " ")
    if inject and inject_rate > 0:
        mask = rng.random(n) < inject_rate
        if mask.any():
            injected = pc.binary_join_element_wise(out, pa.scalar(inject), " ")
            out = pc.if_else(pa.array(mask), injected, out)
    return out


def _money(rng: np.random.Generator, n: int, lo: float, hi: float) -> np.ndarray:
    return np.round(rng.uniform(lo, hi, n), 2)


def _dates(rng: np.random.Generator, n: int, lo: np.datetime64, hi: np.datetime64) -> np.ndarray:
    span = (hi - lo).astype("int64")
    return lo + rng.integers(0, span + 1, n).astype("timedelta64[D]")


def _retail_price(pk: np.ndarray) -> np.ndarray:
    return (90000 + ((pk // 10) % 20001) + 100 * (pk % 1000)) / 100.0


def _ps_suppkey(pk: np.ndarray, i: int, s_count: int) -> np.ndarray:
    # dbgen's formula: the i-th (0..3) supplier for part pk
    return (pk + i * (s_count // 4 + (pk - 1) // s_count)) % s_count + 1


def generate_tpch(out_dir: str, scale: float = 0.01, seed: int = 42,
                  files_per_table: int = 1, row_group_rows: int = 256 * 1024) -> dict[str, str]:
    """Generate all 8 tables as parquet under out_dir/<table>/part-*.parquet.

    Returns {table_name: directory}.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    n_supp = max(10, int(10_000 * scale))
    n_part = max(200, int(200_000 * scale))
    n_cust = max(150, int(150_000 * scale))
    n_ord = max(1500, int(1_500_000 * scale))

    paths: dict[str, str] = {}

    def write(name: str, table: pa.Table, nfiles: int = 1) -> None:
        # the files of a table are written in parallel (the parquet writer
        # releases the GIL while it encodes and compresses)
        from concurrent.futures import ThreadPoolExecutor

        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        n = table.num_rows
        nfiles = max(1, min(nfiles, n))
        step = -(-n // nfiles)
        slices = [(i, table.slice(i * step, step)) for i in range(nfiles)]
        slices = [(i, sl) for i, sl in slices if sl.num_rows]
        with ThreadPoolExecutor(min(8, len(slices))) as pool:
            list(pool.map(lambda job: pq.write_table(
                job[1], os.path.join(d, f"part-{job[0]:03d}.parquet"),
                row_group_size=row_group_rows, compression="zstd"), slices))
        paths[name] = d

    # -- region / nation ----------------------------------------------------
    write("region", pa.table({
        "r_regionkey": pa.array(range(5), pa.int64()),
        "r_name": pa.array(REGIONS),
        "r_comment": _comments(rng, 5),
    }))
    write("nation", pa.table({
        "n_nationkey": pa.array(range(25), pa.int64()),
        "n_name": pa.array([n for n, _ in NATIONS]),
        "n_regionkey": pa.array([r for _, r in NATIONS], pa.int64()),
        "n_comment": _comments(rng, 25),
    }))

    # -- supplier -----------------------------------------------------------
    sk = np.arange(1, n_supp + 1, dtype=np.int64)
    write("supplier", pa.table({
        "s_suppkey": sk,
        "s_name": pa.array([f"Supplier#{i:09d}" for i in sk]),
        "s_address": _comments(rng, n_supp, 2),
        "s_nationkey": rng.integers(0, 25, n_supp).astype(np.int64),
        "s_phone": pa.array([f"{10 + i % 25}-{i % 900 + 100}-{i % 900 + 100}-{i % 9000 + 1000}" for i in sk]),
        "s_acctbal": _money(rng, n_supp, -999.99, 9999.99),
        "s_comment": _comments(rng, n_supp, 6, inject="Customer Complaints", inject_rate=0.0005),
    }), files_per_table)

    # -- part ---------------------------------------------------------------
    pk = np.arange(1, n_part + 1, dtype=np.int64)
    import pyarrow.compute as pc
    name_words = [_take(COLORS, rng.integers(0, len(COLORS), n_part)) for _ in range(5)]
    p_name = pc.binary_join_element_wise(*name_words, " ")
    t1 = rng.integers(0, len(TYPE_S1), n_part)
    t2 = rng.integers(0, len(TYPE_S2), n_part)
    t3 = rng.integers(0, len(TYPE_S3), n_part)
    p_type = pc.binary_join_element_wise(_take(TYPE_S1, t1), _take(TYPE_S2, t2), _take(TYPE_S3, t3), " ")
    brand_m = rng.integers(1, 6, n_part)
    brand_n = rng.integers(1, 6, n_part)
    p_brand = pa.array([f"Brand#{m}{n}" for m, n in zip(brand_m, brand_n)])
    cont = pc.binary_join_element_wise(
        _take(CONTAINER_1, rng.integers(0, 5, n_part)),
        _take(CONTAINER_2, rng.integers(0, 8, n_part)), " ")
    write("part", pa.table({
        "p_partkey": pk,
        "p_name": p_name,
        "p_mfgr": pa.array([f"Manufacturer#{m}" for m in brand_m]),
        "p_brand": p_brand,
        "p_type": p_type,
        "p_size": rng.integers(1, 51, n_part).astype(np.int64),
        "p_container": cont,
        "p_retailprice": _retail_price(pk),
        "p_comment": _comments(rng, n_part, 3),
    }), files_per_table)

    # -- partsupp (4 suppliers per part, dbgen formula) ---------------------
    ps_pk = np.repeat(pk, 4)
    ps_sk = np.concatenate([_ps_suppkey(pk, i, n_supp) for i in range(4)])
    # interleave: order by partkey then i
    order = np.argsort(np.concatenate([pk * 4 + i for i in range(4)]), kind="stable")
    ps_sk = ps_sk[order]
    n_ps = len(ps_pk)
    write("partsupp", pa.table({
        "ps_partkey": ps_pk,
        "ps_suppkey": ps_sk.astype(np.int64),
        "ps_availqty": rng.integers(1, 10_000, n_ps).astype(np.int64),
        "ps_supplycost": _money(rng, n_ps, 1.0, 1000.0),
        "ps_comment": _comments(rng, n_ps, 4),
    }), files_per_table)

    # -- customer -----------------------------------------------------------
    ck = np.arange(1, n_cust + 1, dtype=np.int64)
    c_nat = rng.integers(0, 25, n_cust)
    write("customer", pa.table({
        "c_custkey": ck,
        "c_name": pa.array([f"Customer#{i:09d}" for i in ck]),
        "c_address": _comments(rng, n_cust, 2),
        "c_nationkey": c_nat.astype(np.int64),
        "c_phone": pa.array([f"{10 + n}-{int(x) % 900 + 100}-{int(x) % 900 + 100}-{int(x) % 9000 + 1000}"
                             for n, x in zip(c_nat, ck)]),
        "c_acctbal": _money(rng, n_cust, -999.99, 9999.99),
        "c_mktsegment": _take(SEGMENTS, rng.integers(0, 5, n_cust)),
        "c_comment": _comments(rng, n_cust, 6, inject="special requests", inject_rate=0.002),
    }), files_per_table)

    # -- orders -------------------------------------------------------------
    ok = (np.arange(1, n_ord + 1, dtype=np.int64) * 4) - 3  # sparse keys like dbgen
    # only customers with custkey % 3 != 0 place orders (q13/q22 shape)
    eligible = ck[ck % 3 != 0]
    o_ck = eligible[rng.integers(0, len(eligible), n_ord)]
    o_date = _dates(rng, n_ord, STARTDATE, ENDDATE - np.timedelta64(151, "D"))

    # lineitems: 1..7 per order
    lines_per = rng.integers(1, 8, n_ord)
    l_ok = np.repeat(ok, lines_per)
    l_odate = np.repeat(o_date, lines_per)
    n_li = len(l_ok)
    l_pk = rng.integers(1, n_part + 1, n_li).astype(np.int64)
    supp_choice = rng.integers(0, 4, n_li)
    l_sk = _ps_suppkey(l_pk, 0, n_supp)
    for i in (1, 2, 3):
        sel = supp_choice == i
        l_sk[sel] = _ps_suppkey(l_pk[sel], i, n_supp)
    l_qty = rng.integers(1, 51, n_li).astype(np.int64)
    l_price = np.round(l_qty * _retail_price(l_pk), 2)
    l_disc = np.round(rng.integers(0, 11, n_li) / 100.0, 2)
    l_tax = np.round(rng.integers(0, 9, n_li) / 100.0, 2)
    l_ship = l_odate + rng.integers(1, 122, n_li).astype("timedelta64[D]")
    l_commit = l_odate + rng.integers(30, 91, n_li).astype("timedelta64[D]")
    l_receipt = l_ship + rng.integers(1, 31, n_li).astype("timedelta64[D]")
    l_rflag = np.where(
        l_receipt <= CURRENTDATE,
        np.where(rng.random(n_li) < 0.5, "R", "A"),
        "N",
    )
    l_lstatus = np.where(l_ship > CURRENTDATE, "O", "F")

    # order status from line statuses
    any_open = np.zeros(n_ord, dtype=bool)
    all_open = np.ones(n_ord, dtype=bool)
    idx = np.repeat(np.arange(n_ord), lines_per)
    open_line = l_lstatus == "O"
    np.logical_or.at(any_open, idx, open_line)
    np.logical_and.at(all_open, idx, open_line)
    o_status = np.where(all_open, "O", np.where(any_open, "P", "F"))

    o_total = np.zeros(n_ord)
    np.add.at(o_total, idx, l_price * (1 + l_tax) * (1 - l_disc))
    o_total = np.round(o_total, 2)

    write("orders", pa.table({
        "o_orderkey": ok,
        "o_custkey": o_ck,
        "o_orderstatus": pa.array(o_status),
        "o_totalprice": o_total,
        "o_orderdate": pa.array(o_date),
        "o_orderpriority": _take(PRIORITIES, rng.integers(0, 5, n_ord)),
        "o_clerk": pa.array([f"Clerk#{int(c) % max(1, n_ord // 1000) + 1:09d}" for c in rng.integers(0, 1 << 30, n_ord)]),
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
        "o_comment": _comments(rng, n_ord, 5, inject="special requests", inject_rate=0.01),
    }), files_per_table)

    # 1..c within each order, without a Python loop over the orders
    l_linenumber = np.arange(n_li, dtype=np.int64) - np.repeat(
        np.cumsum(lines_per) - lines_per, lines_per) + 1
    write("lineitem", pa.table({
        "l_orderkey": l_ok,
        "l_partkey": l_pk,
        "l_suppkey": l_sk.astype(np.int64),
        "l_linenumber": l_linenumber,
        "l_quantity": l_qty.astype(np.float64),
        "l_extendedprice": l_price,
        "l_discount": l_disc,
        "l_tax": l_tax,
        "l_returnflag": pa.array(l_rflag),
        "l_linestatus": pa.array(l_lstatus),
        "l_shipdate": pa.array(l_ship),
        "l_commitdate": pa.array(l_commit),
        "l_receiptdate": pa.array(l_receipt),
        "l_shipinstruct": _take(INSTRUCTS, rng.integers(0, 4, n_li)),
        "l_shipmode": _take(SHIPMODES, rng.integers(0, 7, n_li)),
        "l_comment": _comments(rng, n_li, 3),
    }), max(files_per_table, files_per_table * 4))

    return paths


TPCH_TABLES = ["region", "nation", "supplier", "part", "partsupp", "customer", "orders", "lineitem"]


def register_tpch(ctx, data_dir: str) -> None:
    """Register all 8 tables on a session context."""
    from ballista_tpu_torch.plan.provider import ParquetTable

    for t in TPCH_TABLES:
        ctx.register_table(t, ParquetTable(os.path.join(data_dir, t)))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--files-per-table", type=int, default=1)
    args = ap.parse_args()
    generate_tpch(args.out_dir, args.scale, args.seed, args.files_per_table)
    print(f"generated TPC-H sf={args.scale} under {args.out_dir}")
