"""TPC-DS's rollup-rank shapes through the port against the JAX package's
device engine, on the CPU (test_torch_tpcds_parity.py says how): q36,
q67 and q86, a rank over a ROLLUP's levels, whose sort and window stages
the JAX package's tests pin (tests/test_tpcds.py:87). The reference's
first XLA compiles of q67 cost it about 100 s, so these run in a file of
their own.
"""

import pytest

from .test_torch_tpcds_parity import _cpu_engine, check_parity, tpcds_dir  # noqa: F401


@pytest.mark.parametrize("q", [36, 67, 86])
def test_tpcds_rollup_byte_identical_to_jax_engine(q, tpcds_dir):  # noqa: F811
    check_parity(q, tpcds_dir)
