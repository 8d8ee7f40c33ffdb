"""The control: the plain reference put in the program's place, computed
one precision lower (float32 where the configuration states float64
money), and held to the float64 reference by the run's own comparison.
It has to come out not correct.

    python3 -m portbench.harness.control --workload <cell> --seeds 1 2 3

prints, per seed, the numbers compared and the verdict as one JSON line.
It needs no card and no window: the statements of a run are drawn from the
seed as a run draws them, and every statement is answered once.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from portbench.harness import check, qgen, spec
from portbench.harness.data import ensure
from portbench.harness.main import tables_of
from portbench.reference.common import Db


def readings(cell, data_dir: str, seed: int, root: str, db: Db | None = None) -> dict:
    """The compared numbers of the control against the reference for the
    statements of `seed`, with the verdict under the limits of `check`."""
    db = db or Db(data_dir, tables_of(cell.queries, root))
    low = db.with_dtype(np.float32)
    stmts = [s for st in qgen.streams(cell.queries, int(cell.traffic["streams"]), seed,
                                      scale=float(cell.config["scale_factor"])) for s in st]
    ref, ctl, per_query = {}, [], {}
    for s in stmts:
        mod = spec.reference_module(s["query"], root)
        ref[s["key"]] = mod.answer(db, s["params"])
        got = mod.answer(low, s["params"])
        ctl.append((s["key"], got))
        same, gap, _ = check.compare(got, ref[s["key"]])
        q = per_query.setdefault(s["query"], {"exact_mismatch": 0, "float_gap": 0.0})
        q["exact_mismatch"] += int(not same)
        if same:
            q["float_gap"] = max(q["float_gap"], gap)
    values, notes = check.readings(ctl, ref, 0)
    ok, checks = check.verdict(values, check.LIMITS)
    return {"seed": seed, "correct": ok, "checks": checks, "per_query": per_query, "notes": notes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.harness.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    data_dir, _ = ensure(cell.config, f"{spec.ROOT}/portbench",
                         log=lambda m: print(m, file=sys.stderr))
    t0 = time.time()
    db = Db(data_dir, tables_of(cell.queries, spec.ROOT))
    for seed in args.seeds:
        out = readings(cell, data_dir, seed, spec.ROOT, db)
        out["elapsed_s"] = time.time() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
