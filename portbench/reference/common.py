"""The plain reference's tables and helpers: NumPy over the parquet files.

The reference reads the same files the system under test was handed and
nothing the system made. It imports neither JAX nor the JAX package nor
anything of the port. Each `reference/<q>.py` names the columns it reads
(`COLUMNS`) and gives `answer(db, params)`: the query's answer as
{column: array} in the query's column order and row order.

`Db(dtype=np.float32)` is the same reference one precision lower: every
float column is read as float32 and every sum, product and mean is taken
in float32. It is the control that the comparison has to refuse.
"""

from __future__ import annotations

import datetime as dt
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

EPOCH = dt.date(1970, 1, 1)


class Strings:
    """A string column as dictionary codes and their values."""

    def __init__(self, codes: np.ndarray, values: list[str]):
        self.codes = codes
        self.values = values

    def code(self, value: str) -> int:
        """The code of `value`, or -1 where no row holds it."""
        try:
            return self.values.index(value)
        except ValueError:
            return -1

    def isin(self, values) -> np.ndarray:
        want = np.zeros(len(self.values) + 1, dtype=bool)
        for v in values:
            want[self.code(v)] = True  # -1 lands on the spare last slot
        want[-1] = False
        return want[self.codes]


def _column(col: pa.ChunkedArray):
    t = col.type
    if pa.types.is_dictionary(t):
        col = col.unify_dictionaries()
        values = col.chunk(0).dictionary.to_pylist() if col.num_chunks else []
        codes = np.concatenate([c.indices.to_numpy(zero_copy_only=False).astype(np.int32)
                                for c in col.chunks]) if col.num_chunks else np.zeros(0, np.int32)
        return Strings(codes, values)
    if pa.types.is_date32(t):
        return col.cast(pa.int32()).to_numpy()
    if pa.types.is_integer(t):
        return col.to_numpy().astype(np.int64)
    if pa.types.is_floating(t):
        return col.to_numpy().astype(np.float64)
    raise TypeError(f"column type {t} has no reference form")


class Db:
    """The named columns of the named tables, read once."""

    def __init__(self, data_dir: str, columns: dict[str, list[str]], dtype=np.float64,
                 _raw: dict | None = None):
        self.dtype = np.dtype(dtype)
        self._float: dict = {}
        self.memo: dict = {}  # what a query's answers share, in this precision
        if _raw is not None:
            self._raw = _raw
            return
        self._raw = {}
        for table, cols in columns.items():
            path = os.path.join(data_dir, table)
            schema = pq.read_schema(os.path.join(path, sorted(os.listdir(path))[0]))
            strings = [c for c in cols if pa.types.is_string(schema.field(c).type)
                       or pa.types.is_large_string(schema.field(c).type)]
            t = pq.read_table(path, columns=cols, read_dictionary=strings)
            self._raw[table] = {c: _column(t.column(c)) for c in cols}

    def with_dtype(self, dtype) -> "Db":
        """The same tables, float columns taken in `dtype`."""
        return Db("", {}, dtype=dtype, _raw=self._raw)

    def col(self, table: str, name: str):
        """An integer, date (days since 1970-01-01) or string column."""
        return self._raw[table][name]

    def f(self, table: str, name: str) -> np.ndarray:
        """A float column in this Db's precision."""
        key = (table, name)
        if key not in self._float:
            self._float[key] = self._raw[table][name].astype(self.dtype)
        return self._float[key]

    def num(self, text: str):
        """A decimal literal in this Db's precision."""
        return self.dtype.type(text)


def date(text: str) -> int:
    """Days since 1970-01-01 of an ISO date."""
    return (dt.date.fromisoformat(text) - EPOCH).days


def dense(keys: np.ndarray, values: np.ndarray, fill, dtype=None) -> np.ndarray:
    """An array indexed by key: out[keys[i]] = values[i], `fill` elsewhere."""
    out = np.full(int(keys.max()) + 1 if len(keys) else 1, fill,
                  dtype=dtype or np.asarray(values).dtype)
    out[keys] = values
    return out


def group_sums(gid: np.ndarray, n_groups: int, *vals: np.ndarray) -> list[np.ndarray]:
    """Per group g in [0, n_groups), for a few groups: the sum of each of
    `vals` over the rows with gid == g (rows with gid -1 belong to none),
    NumPy's pairwise sum in the values' own precision."""
    rows = [np.flatnonzero(gid == g) for g in range(n_groups)]
    return [np.array([v[r].sum(dtype=v.dtype) for r in rows], dtype=v.dtype) for v in vals]


def by_key_sums(keys: np.ndarray, vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(distinct keys ascending, the sum of `vals` for each), summed in the
    values' own precision, one key after another."""
    order = np.argsort(keys, kind="stable")
    sk, sv = keys[order], vals[order]
    if not len(sk):
        return sk, sv
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    return sk[starts], np.add.reduceat(sv, starts, dtype=vals.dtype)
