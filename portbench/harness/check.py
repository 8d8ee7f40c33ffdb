"""How `correct` is decided: every answer the window collected, held to
the plain reference's answer for its statement.

Three numbers are compared, each against its limit:

- `unanswered`: statements of the warm-up or the window that raised or never
  returned. Limit 0.
- `exact_mismatch`: answers whose column names, row count, or any
  integer, date or string cell differ from the reference's, or whose float
  cells are NULL where the reference's are not. Limit 0.
- `float_gap`: the widest relative gap |got - want| / |want| over every
  float cell of every answer that matched exactly otherwise. The
  reference takes NumPy's pairwise float64 sums; the engine sums money as
  exact int64 cents on the card, so the two meet within float64's
  rounding. The limit lies between what sound runs of the program read
  (at most 3.9e-16 over 15 seeds at SF10) and what the reference computed
  in float32 (the control) reads (at least 1.0e-7 over 3 seeds); PERF.md
  gives both.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

LIMITS = {"unanswered": 0, "exact_mismatch": 0, "float_gap": 1e-9}

_TINY = np.finfo(np.float64).tiny


def as_columns(table: pa.Table) -> dict:
    """An Arrow answer in the reference's form: strings as lists, dates as
    int32 days, integers as int64, floats as float64 (NULL as NaN)."""
    out = {}
    for name, col in zip(table.column_names, table.columns):
        t = col.type
        if pa.types.is_floating(t):
            out[name] = col.to_numpy().astype(np.float64)
        elif pa.types.is_date32(t):
            out[name] = col.cast(pa.int32()).to_numpy()
        elif pa.types.is_integer(t):
            out[name] = col.to_numpy().astype(np.int64)
        else:
            out[name] = col.to_pylist()
    return out


def _is_float(values) -> bool:
    return isinstance(values, np.ndarray) and values.dtype.kind == "f"


def compare(got: dict, want: dict) -> tuple[bool, float, str]:
    """(exact parts equal, widest relative float gap, what differs)."""
    if list(got) != list(want):
        return False, 0.0, f"columns {list(got)} != {list(want)}"
    n_got = {len(v) for v in got.values()}
    n_want = {len(v) for v in want.values()}
    if n_got != n_want:
        return False, 0.0, f"rows {sorted(n_got)} != {sorted(n_want)}"
    gap = 0.0
    for name in want:
        a, b = got[name], want[name]
        if _is_float(b) or _is_float(a):
            x = np.asarray(a, dtype=np.float64)
            y = np.asarray(b, dtype=np.float64)
            if not np.array_equal(np.isnan(x), np.isnan(y)):
                return False, gap, f"{name}: NULL where the reference has none, or the reverse"
            ok = ~np.isnan(y)
            if ok.any():
                rel = np.abs(x[ok] - y[ok]) / np.maximum(np.abs(y[ok]), _TINY)
                gap = max(gap, float(rel.max()))
        elif isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                return False, gap, f"{name}: {list(a)[:4]} != {list(b)[:4]}"
        elif list(a) != list(b):
            return False, gap, f"{name}: {list(a)[:4]} != {list(b)[:4]}"
    return True, gap, ""


def readings(answers: list[tuple[str, dict]], references: dict[str, dict],
             unanswered: int) -> tuple[dict, list[str]]:
    """The compared numbers over (statement key, answer) pairs, and up to
    five lines on what differed."""
    mismatch, gap, notes = 0, 0.0, []
    for key, got in answers:
        same, g, why = compare(got, references[key])
        if same:
            gap = max(gap, g)
        else:
            mismatch += 1
            if len(notes) < 5:
                notes.append(f"{key}: {why}")
    return {"unanswered": unanswered, "exact_mismatch": mismatch, "float_gap": gap}, notes


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    return all(values[k] <= limits[k] for k in limits), checks
