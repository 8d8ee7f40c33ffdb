"""Fixtures for the benchmark's CPU tests.

`bench_root` is a copy of the benchmark (BENCHMARK.json and portbench/)
whose configurations are cut to TPC-H SF0.01, so a whole run of a cell
fits in a test: the port runs its CPU forms (`runtime.use_cpu()`), the
harness skips its look for a card. `card` skips a test where there is no
card; it decides inside the fixture, never at import.
"""

from __future__ import annotations

import json
import os
import shutil

import pytest

from portbench.harness import spec

TINY_SCALE = 0.01


# the six-report mix has no cell in BENCHMARK.json: with the settings as
# shipped the port does not carry it at SF10 (q4's host semi join, the join
# builds evicting each other). The tests run it as a cell of the tiny copy,
# so that its references and the port's join paths stay held to each other.
MIX6_CELL = {"name": "tpch10_local_mix6", "config": "tpch_sf10_local",
             "traffic": "tpch6_3streams", "chips": 1, "why": "the six-report mix"}


def make_root(path: str, scale: float = TINY_SCALE) -> str:
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append(MIX6_CELL)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    shutil.copytree(spec.BENCH_DIR, os.path.join(path, "portbench"),
                    ignore=shutil.ignore_patterns("data", "__pycache__"))
    for name in os.listdir(os.path.join(path, "portbench", "configs")):
        p = os.path.join(path, "portbench", "configs", name)
        with open(p) as f:
            cfg = json.load(f)
        cfg["scale_factor"] = scale
        with open(p, "w") as f:
            json.dump(cfg, f)
    return path


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory) -> str:
    return make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture
def cpu_port():
    from ballista_tpu_torch.ops.cuda import runtime

    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
