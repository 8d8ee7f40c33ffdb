"""Substitution parameters and stream orders from the seed."""

import datetime as dt

import pytest

from portbench.harness import qgen, spec

QUERIES = {q: spec.load_query(q) for q in ("q1", "q3", "q4", "q5", "q6", "q12")}
SEEDS = [0, 1, 42, 2**31 + 5, 2**40 + 3, -7]


def _d(s):
    return dt.date.fromisoformat(s)


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_statements(seed):
    assert qgen.streams(QUERIES, 3, seed) == qgen.streams(QUERIES, 3, seed)


def test_seeds_differ_and_streams_differ():
    a, b = qgen.streams(QUERIES, 3, 1), qgen.streams(QUERIES, 3, 2)
    assert a != b
    assert [s["query"] for s in a[0]] != [s["query"] for s in a[1]] or \
        [s["sql"] for s in a[0]] != [s["sql"] for s in a[1]]


@pytest.mark.parametrize("seed", range(40))
def test_every_stream_runs_each_query_once_within_tpch_ranges(seed):
    for stmts in qgen.streams(QUERIES, 3, seed):
        assert sorted(s["query"] for s in stmts) == sorted(QUERIES)
        for s in stmts:
            p = s["params"]
            assert "{" not in s["sql"]
            if s["query"] == "q1":
                assert 60 <= int(p["DELTA"]) <= 120
                assert (_d("1998-12-01") - _d(p["SHIPDATE"])).days == int(p["DELTA"])
            elif s["query"] == "q3":
                assert p["SEGMENT"] in ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
                                        "HOUSEHOLD")
                assert _d("1995-03-01") <= _d(p["DATE"]) <= _d("1995-03-31")
            elif s["query"] == "q4":
                d = _d(p["DATE"])
                assert d.day == 1 and _d("1993-01-01") <= d <= _d("1997-10-01")
                e = _d(p["DATE_END"])
                assert (e.year * 12 + e.month) - (d.year * 12 + d.month) == 3 and e.day == 1
            elif s["query"] == "q5":
                assert p["REGION"] in ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
                d = _d(p["DATE"])
                assert (d.month, d.day) == (1, 1) and 1993 <= d.year <= 1997
                assert _d(p["DATE_END"]) == dt.date(d.year + 1, 1, 1)
            elif s["query"] == "q6":
                d = _d(p["DATE"])
                assert (d.month, d.day) == (1, 1) and 1993 <= d.year <= 1997
                disc = round(float(p["DISCOUNT"]) * 100)
                assert 2 <= disc <= 9 and len(p["DISCOUNT"]) == 4
                assert round(float(p["DISCOUNT_LO"]) * 100) == disc - 1
                assert round(float(p["DISCOUNT_HI"]) * 100) == disc + 1
                assert p["QUANTITY"] in ("24", "25")
            elif s["query"] == "q12":
                modes = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
                assert p["SHIPMODE1"] in modes and p["SHIPMODE2"] in modes
                assert p["SHIPMODE1"] != p["SHIPMODE2"]
                d = _d(p["DATE"])
                assert (d.month, d.day) == (1, 1) and 1993 <= d.year <= 1997


def test_draws_cover_the_ranges():
    seen = {"DELTA": set(), "REGION": set(), "YEAR": set()}
    for seed in range(300):
        for stmts in qgen.streams(QUERIES, 3, seed):
            for s in stmts:
                p = s["params"]
                if s["query"] == "q1":
                    seen["DELTA"].add(int(p["DELTA"]))
                if s["query"] == "q5":
                    seen["REGION"].add(p["REGION"])
                    seen["YEAR"].add(p["DATE"][:4])
    assert min(seen["DELTA"]) == 60 and max(seen["DELTA"]) == 120
    assert len(seen["REGION"]) == 5 and len(seen["YEAR"]) == 5


def test_other_kinds():
    rng = qgen.rng_for(9)
    params = [
        {"name": "N", "kind": "int", "lo": 1, "hi": 50},
        {"name": "SIZES", "kind": "choice", "values": [str(i) for i in range(1, 51)],
         "count": 8},
        {"name": "COLOR", "kind": "choice", "values": ["red", "o'range"], "count": 2,
         "quote": True},
        {"name": "M", "kind": "int", "lo": 1, "hi": 5},
        {"name": "BRAND", "kind": "format", "template": "Brand#{M}{N}"},
        {"name": "NATION", "kind": "choice", "values": ["FRANCE", "CHINA"]},
        {"name": "REGION", "kind": "lookup", "from": "NATION",
         "table": {"FRANCE": "EUROPE", "CHINA": "ASIA"}},
        {"name": "FRACTION", "kind": "scale_div", "numerator": "0.0001", "places": 10},
        {"name": "MONTH", "kind": "date", "lo": "1993-02-01", "hi": "1995-01-01", "unit": "month"},
        {"name": "BACK", "kind": "date_add", "from": "MONTH", "years": 1, "sign": -1},
    ]
    p = qgen.draw_params(params, rng, scale=10)
    assert len(set(p["SIZES"].split(", "))) == 8
    assert p["COLOR"] in ("'red', 'o''range'", "'o''range', 'red'")
    assert p["BRAND"] == f"Brand#{p['M']}{p['N']}"
    assert p["REGION"] == {"FRANCE": "EUROPE", "CHINA": "ASIA"}[p["NATION"]]
    assert p["FRACTION"] == "0.0000100000"
    assert _d(p["BACK"]).year == _d(p["MONTH"]).year - 1
    with pytest.raises(KeyError):
        qgen.render("{MISSING}", {})
