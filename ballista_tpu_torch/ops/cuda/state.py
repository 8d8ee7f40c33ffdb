"""Device state carried in from plain arrays.

A database has no weights: its device state is the encoded table. This
builds the port's DeviceTable from numpy arrays and encode metadata, so
a table encoded elsewhere (for instance by the JAX package, read back with
`np.asarray`) can be run by the port's compiled stages unchanged.
"""

from __future__ import annotations

import numpy as np

from ballista_tpu_torch.ops.cuda.columnar import to_device
from ballista_tpu_torch.ops.cuda.stage_compiler import DeviceTable


def device_table_from_arrays(cols, valids, mask, part_rows, kinds, scales, dicts,
                             device) -> DeviceTable:
    """cols: per column a [P, N] array (its encoded dtype kept); valids: per
    column a bool [P, N] validity plane or None; mask: bool [P, N] row
    validity; part_rows: live rows per partition; kinds/scales/dicts: the
    encoder's per-column metadata (columnar.encode_column)."""
    cols_np = [np.asarray(c) for c in cols]
    valids_np = [None if v is None else np.asarray(v, dtype=bool) for v in valids]
    mask_np = np.asarray(mask, dtype=bool)
    if len(valids_np) != len(cols_np):
        raise ValueError("one validity entry (array or None) per column")
    for a in cols_np + [v for v in valids_np if v is not None]:
        if a.shape != mask_np.shape:
            raise ValueError(f"column shape {a.shape} != mask shape {mask_np.shape}")
    nbytes = (sum(a.nbytes for a in cols_np) + mask_np.nbytes
              + sum(v.nbytes for v in valids_np if v is not None))
    return DeviceTable(
        list(kinds), list(scales), list(dicts),
        [to_device(a, device) for a in cols_np],
        to_device(mask_np, device),
        [int(r) for r in part_rows], nbytes,
        [None if v is None else to_device(v, device) for v in valids_np],
    )
