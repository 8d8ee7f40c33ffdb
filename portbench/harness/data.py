"""The configuration's tables, generated once in a checkout and reused.

The directory is named from what decides its contents (generator, scale
factor, generator seed, files a table, the columns), so two configurations
that state the same data share it. The manifest is written last: a run cut
during generation leaves no manifest, and the next run generates again.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

from portbench.harness.spec import BENCH_DIR

MANIFEST = "manifest.json"


def data_spec(config: dict) -> dict:
    return {"generator": config["generator"], "scale_factor": config["scale_factor"],
            "generator_seed": config["generator_seed"],
            "files_per_table": config["files_per_table"], "columns": config["columns"]}


def data_dir(config: dict, bench_dir: str = BENCH_DIR) -> str:
    spec = data_spec(config)
    digest = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()[:12]
    name = f"tpch_sf{spec['scale_factor']}_seed{spec['generator_seed']}_{digest}"
    return os.path.join(bench_dir, "data", name)


def ensure(config: dict, bench_dir: str = BENCH_DIR, log=print) -> tuple[str, dict]:
    """(directory, manifest) of the configuration's tables, generating them
    when no complete set is there."""
    d = data_dir(config, bench_dir)
    path = os.path.join(d, MANIFEST)
    if os.path.exists(path):
        with open(path) as f:
            return d, json.load(f)
    if os.path.isdir(d):
        shutil.rmtree(d)  # a cut generation
    from portbench.datagen.tpchgen import generate_tpch

    t0 = time.time()
    spec = data_spec(config)
    tables = generate_tpch(d, scale=float(spec["scale_factor"]), seed=int(spec["generator_seed"]),
                           files_per_table=int(spec["files_per_table"]), columns=spec["columns"])
    nbytes = sum(os.path.getsize(os.path.join(dp, f))
                 for dp, _, fs in os.walk(d) for f in fs)
    manifest = {**spec, "tables": sorted(tables), "bytes": nbytes,
                "generate_s": time.time() - t0}
    with open(path + ".tmp", "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(path + ".tmp", path)
    log(f"generated {sorted(tables)} in {manifest['generate_s']:.1f} s, {nbytes} bytes, under {d}")
    return d, manifest
