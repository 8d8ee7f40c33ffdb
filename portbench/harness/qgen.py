"""Substitution parameters and stream orders drawn from the seed (qgen).

TPC-H fixes the database for a scale factor; its query generator varies
the substitution parameters of each query (clause 2.4 of the
specification) and the order of the queries in each stream. This module
does the same from `--seed`. A query's parameters are a list in its
`<q>.params.json`, each drawn or derived by its `kind`:

- int       {"lo", "hi"}: a whole number in [lo, hi]
- decimal   {"lo", "hi", "places"}: a decimal in [lo, hi] in steps of 10^-places
- choice    {"values", "count"=1, "distinct_from"=[...]}: `count` distinct
            values (joined by ", " as quoted SQL strings when count > 1,
            "quote": true), none equal to the named earlier parameters
- date      {"lo", "hi", "unit": day|month|year}: the first day of a
            random day, month or year in [lo, hi] (dates "YYYY-MM-DD")
- date_add  {"from", "days"|"months"|"years", "sign"=1}: a date moved;
            `from` and the amount may name earlier parameters
- add       {"from", "by", "places"}: a decimal plus a constant
- format    {"template"}: "{NAME}" placeholders filled from earlier parameters
- lookup    {"from", "table"}: the entry of `table` under an earlier value
- scale_div {"numerator", "places"}: numerator / the scale factor

Every value is the text substituted into the query; the reference parses
the same text.
"""

from __future__ import annotations

import datetime as dt
import re
from decimal import Decimal

import numpy as np

_PLACEHOLDER = re.compile(r"\{([A-Z][A-Z0-9_]*)\}")


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    """A generator for `seed` (any integer, reduced mod 2^64) and a salt
    that separates the draws of streams and queries."""
    return np.random.default_rng([int(seed) % (1 << 64), *salt])


def _date(text: str) -> dt.date:
    return dt.date.fromisoformat(text)


def _add_months(d: dt.date, months: int) -> dt.date:
    m = d.month - 1 + months
    return dt.date(d.year + m // 12, m % 12 + 1, d.day)


def _ref(values: dict, x):
    return values[x] if isinstance(x, str) and x in values else x


def draw_params(params: list[dict], rng: np.random.Generator, scale: float = 1.0) -> dict[str, str]:
    """{NAME: text} for one statement of a query."""
    out: dict[str, str] = {}
    for p in params:
        kind, name = p["kind"], p["name"]
        if kind == "int":
            out[name] = str(int(rng.integers(int(p["lo"]), int(p["hi"]) + 1)))
        elif kind == "decimal":
            places = int(p["places"])
            q = Decimal(1).scaleb(-places)
            lo, hi = int(Decimal(p["lo"]) / q), int(Decimal(p["hi"]) / q)
            out[name] = str((Decimal(int(rng.integers(lo, hi + 1))) * q).quantize(q))
        elif kind == "choice":
            banned = {out[n] for n in p.get("distinct_from", [])}
            pool = [v for v in p["values"] if v not in banned]
            count = int(p.get("count", 1))
            picks = [pool[i] for i in rng.choice(len(pool), size=count, replace=False)]
            if p.get("quote"):
                out[name] = ", ".join("'" + v.replace("'", "''") + "'" for v in picks)
            else:
                out[name] = ", ".join(picks)
        elif kind == "date":
            lo, hi, unit = _date(p["lo"]), _date(p["hi"]), p["unit"]
            if unit == "day":
                d = lo + dt.timedelta(days=int(rng.integers(0, (hi - lo).days + 1)))
            elif unit == "month":
                n = (hi.year - lo.year) * 12 + hi.month - lo.month
                d = _add_months(lo.replace(day=1), int(rng.integers(0, n + 1)))
            elif unit == "year":
                d = dt.date(int(rng.integers(lo.year, hi.year + 1)), 1, 1)
            else:
                raise ValueError(f"{name}: unit {unit!r}")
            out[name] = d.isoformat()
        elif kind == "date_add":
            d = _date(_ref(out, p["from"]))
            sign = int(p.get("sign", 1))
            if "days" in p:
                d = d + dt.timedelta(days=sign * int(_ref(out, p["days"])))
            elif "months" in p:
                d = _add_months(d, sign * int(_ref(out, p["months"])))
            else:
                d = _add_months(d, 12 * sign * int(_ref(out, p["years"])))
            out[name] = d.isoformat()
        elif kind == "add":
            places = int(p["places"])
            q = Decimal(1).scaleb(-places)
            out[name] = str((Decimal(_ref(out, p["from"])) + Decimal(p["by"])).quantize(q))
        elif kind == "format":
            out[name] = _PLACEHOLDER.sub(lambda m: out[m.group(1)], p["template"])
        elif kind == "lookup":
            out[name] = str(p["table"][out[p["from"]]])
        elif kind == "scale_div":
            q = Decimal(1).scaleb(-int(p["places"]))
            out[name] = str((Decimal(p["numerator"]) / Decimal(str(scale))).quantize(q))
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
    return out


def render(template: str, values: dict[str, str]) -> str:
    """The query text with every {NAME} replaced; a placeholder without a
    value raises."""
    def sub(m):
        if m.group(1) not in values:
            raise KeyError(f"no value for {{{m.group(1)}}}")
        return values[m.group(1)]
    return _PLACEHOLDER.sub(sub, template)


def streams(queries: dict, n_streams: int, seed: int, scale: float = 1.0) -> list[list[dict]]:
    """Per stream, its statements in the order it runs them: a permutation
    of the query set drawn from the seed, each query with one parameter set
    of its own (a TPC-H throughput stream). Each statement is
    {"query", "params", "sql", "key"}; `key` names it across streams."""
    names = list(queries)
    out = []
    for s in range(n_streams):
        order = rng_for(seed, 1, s).permutation(len(names))
        stmts = []
        for i in order:
            q = queries[names[i]]
            values = draw_params(q.params, rng_for(seed, 2, s, int(i)), scale)
            stmts.append({"query": q.name, "params": values, "sql": render(q.template, values),
                          "key": f"s{s}.{q.name}"})
        out.append(stmts)
    return out
