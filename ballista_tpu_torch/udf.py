"""User-defined scalar function registry.

Rebuild of `BallistaFunctionRegistry` (reference: core/src/registry.rs:39):
the registry that lets deserialized plans resolve functions on executors.
Like the reference — where UDFs are code-registered on both sides, not
serialized over the wire — functions ship BY REFERENCE: the client records
the defining module in the session config (`ballista.udf.modules`), and
executors import those modules before running a task; importing a module
re-registers its UDFs process-locally.

    # analytics/udfs.py
    from ballista_tpu_torch import udf
    def double(a: pa.Array) -> pa.Array: ...
    udf.register_udf("double", double, pa.int64())

    ctx.register_udf("double", double, pa.int64())   # local + ships module
    ctx.sql("select double(x) from t")               # works on executors
"""

from __future__ import annotations

import importlib
import logging
import threading
from dataclasses import dataclass
from typing import Callable

import pyarrow as pa

log = logging.getLogger(__name__)

UDF_MODULES = "ballista.udf.modules"  # session config key (comma-separated)


@dataclass(frozen=True)
class ScalarUDF:
    name: str
    fn: Callable  # (*pa.Array) -> pa.Array | pa.Scalar
    return_type: pa.DataType
    module: str | None = None  # importable module that registers this UDF


# analysis: ignore[bounded-cache] registration surface, not a cache: one entry per registered UDF
_REGISTRY: dict[str, ScalarUDF] = {}
_LOCK = threading.Lock()
# analysis: ignore[bounded-cache] load-once marker set; bounded by ballista.udf.modules
_LOADED_MODULES: set[str] = set()


def register_udf(name: str, fn: Callable, return_type: pa.DataType,
                 module: str | None = None) -> ScalarUDF:
    """Register a scalar UDF process-wide. `module` defaults to the
    function's defining module when importable (so remote executors can
    re-register it by import); pass None explicitly for local-only UDFs."""
    if module is None:
        m = getattr(fn, "__module__", None)
        if m and m not in ("__main__", "builtins"):
            module = m
    u = ScalarUDF(name.lower(), fn, return_type, module)
    with _LOCK:
        _REGISTRY[u.name] = u
    return u


def resolve(name: str) -> ScalarUDF | None:
    with _LOCK:
        return _REGISTRY.get(name.lower())


def load_modules(spec: str | None) -> None:
    """Import each module named in a comma-separated spec (executor side:
    re-registers the session's UDFs). Unknown modules log and continue —
    the task then fails with 'unknown scalar function', which names the
    actual problem."""
    if not spec:
        return
    for mod in (m.strip() for m in spec.split(",")):
        if not mod or mod in _LOADED_MODULES:
            continue
        try:
            importlib.import_module(mod)
            _LOADED_MODULES.add(mod)
        except Exception as e:  # noqa: BLE001
            log.warning("cannot import UDF module %s: %s", mod, e)
