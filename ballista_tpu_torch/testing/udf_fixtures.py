"""Importable UDFs used by tests (and as the pattern for user UDF modules):
importing this module registers its functions, which is how executors
re-materialize session UDFs shipped by reference (ballista_tpu_torch/udf.py)."""

import pyarrow as pa
import pyarrow.compute as pc

from ballista_tpu_torch import udf


def double_it(a: pa.Array) -> pa.Array:
    return pc.multiply(pc.cast(a, pa.int64()), 2)


def shout(s: pa.Array) -> pa.Array:
    return pc.binary_join_element_wise(pc.utf8_upper(s), "!", "")


def hard_crash(a: pa.Array) -> pa.Array:
    """Kills the interpreter without cleanup — a stand-in for a segfaulting
    native kernel, used to prove process-isolation crash containment."""
    import os

    os._exit(77)


def slow_identity(a: pa.Array) -> pa.Array:
    """Sleeps long enough for a cancel to land mid-task."""
    import time

    time.sleep(30)
    return pc.cast(a, pa.int64())


udf.register_udf("double_it", double_it, pa.int64())
udf.register_udf("shout", shout, pa.string())
udf.register_udf("hard_crash", hard_crash, pa.int64())
udf.register_udf("slow_identity", slow_identity, pa.int64())
