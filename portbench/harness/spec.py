"""Find a cell and everything it names, by name, from files of their own.

`BENCHMARK.json` at the checkout's root lists the cells (`workloads`),
configurations and metrics. Each name leads to a file under `portbench/`:

- configs/<config>.json          one deployment (data, front door, settings)
- traffic/<mix>.json             the query set, streams and loop
- queries/<q>.sql, <q>.params.json   a query text and its substitution ranges
- reference/<q>.py               the plain reference for that query
- frontdoors/<front_door>.py     how a configuration reaches the system
- metrics/<metric>.py            one reader per per-layer metric

A later cell, mix, query or metric is new files and new entries; no file
here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: str = ""
    moves: str = ""
    workloads: list[str] | None = None

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    queries: dict[str, "Query"]
    end_to_end: list[Metric]
    per_layer: list[Metric]
    chips: int


@dataclass
class Query:
    name: str
    template: str
    params: list[dict]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import a file by its path (names may hold '.' and '-')."""
    mod_name = "portbench_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_query(name: str, bench_dir: str = BENCH_DIR) -> Query:
    with open(os.path.join(bench_dir, "queries", f"{name}.sql")) as f:
        template = f.read()
    params = load_json(os.path.join(bench_dir, "queries", f"{name}.params.json"))["params"]
    return Query(name, template, params)


def _metrics(entries: list[dict], cell: str) -> list[Metric]:
    out = []
    for e in entries:
        m = Metric(name=e["name"], unit=e["unit"], better=e["better"], source=e["source"],
                   layer=e.get("layer", ""), moves=e.get("moves", ""),
                   workloads=e.get("workloads"))
        if m.applies_to(cell):
            out.append(m)
    return out


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its configuration,
    mix, queries and metrics. Raises KeyError for a name it does not list."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    bench_dir = os.path.join(root, "portbench")
    config = load_json(os.path.join(bench_dir, "configs", f"{w['config']}.json"))
    traffic = load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    queries = {q: load_query(q, bench_dir) for q in traffic["queries"]}
    return Cell(name=name, config=config, traffic=traffic, queries=queries,
                end_to_end=_metrics(bench["end_to_end"], name),
                per_layer=_metrics(bench["per_layer"], name), chips=int(w["chips"]))


def reference_module(query: str, root: str = ROOT):
    return load_module(os.path.join(root, "portbench", "reference", f"{query}.py"),
                       f"reference_{query}")


def front_door(name: str, root: str = ROOT):
    return load_module(os.path.join(root, "portbench", "frontdoors", f"{name}.py"),
                       f"frontdoor_{name}")


def metric_reader(name: str, root: str = ROOT):
    return load_module(os.path.join(root, "portbench", "metrics", f"{name}.py"),
                       f"metric_{name}")
