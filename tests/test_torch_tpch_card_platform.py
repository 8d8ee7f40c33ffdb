"""All 22 TPC-H queries with the cost model on the card's platform.

On the CPU the fusion cost model sees `platform="cpu"` and never sends a
stage to the hand-written kernels; on the card it sees `"cuda"` (the
reference `"tpu"`) and sends grouped aggregates and sort stages there. Here
both packages plan and run as they would on their card: the `platform`
attribute of every `CostModel` is pinned to the card's, while the kernels
run in their CPU forms (the port's plain PyTorch forms, the reference's
Pallas kernels in interpret mode). Per query the Arrow answers must be
byte-identical, each kernel wrapper must be called as often as its Pallas
function, and the partial stages' fusion decisions and the sort stages'
decisions (mode and reason) must be equal.
"""

import pytest

from ballista_tpu_torch.ops.cuda import runtime

from .conftest import tpch_query

BASE_CFG = {"ballista.executor.engine": "tpu", "ballista.tpu.min.rows": 0}
KERNELS = ("masked_group_reduce", "hash_probe", "dict_filter", "segmented_sort",
           "topk_select", "segmented_scan")


@pytest.fixture(autouse=True)
def _cpu_engine():
    prev = runtime.cpu_requested()
    runtime.use_cpu()
    yield
    runtime.use_cpu(prev)


def _pin_platform(monkeypatch, fusion_mod, platform: str, sort_decisions: list) -> None:
    """Every CostModel of `fusion_mod` reads `platform`, whatever device its
    stage's tensors live on; each sort decision is appended to
    `sort_decisions`."""
    def pinned(self, name, value):
        object.__setattr__(self, name, platform if name == "platform" else value)

    choose_sort = fusion_mod.CostModel.choose_sort

    def recorded(self, est):
        dec = choose_sort(self, est)
        sort_decisions.append((dec.mode, dec.reason))
        return dec

    monkeypatch.setattr(fusion_mod.CostModel, "__setattr__", pinned)
    monkeypatch.setattr(fusion_mod.CostModel, "choose_sort", recorded)


def _count_calls(monkeypatch, kernels_mod, calls: dict) -> None:
    for name in KERNELS:
        fn = getattr(kernels_mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(kernels_mod, name, counted)


def _run(pkg: str, tpch_dir: str, q: int):
    ctx_mod = __import__(f"{pkg}.client.context", fromlist=["SessionContext"])
    cfg_mod = __import__(f"{pkg}.config", fromlist=["BallistaConfig"])
    gen_mod = __import__(f"{pkg}.testing.tpchgen", fromlist=["register_tpch"])
    ctx = ctx_mod.SessionContext(cfg_mod.BallistaConfig(dict(BASE_CFG)))
    gen_mod.register_tpch(ctx, tpch_dir)
    return ctx.sql(tpch_query(q)).collect()


def _stage_decisions(run_stats) -> list:
    """(fusion_mode, fusion_reason) of every partial stage run, by tag."""
    return sorted((tag, r.get("fusion_mode"), r.get("fusion_reason"))
                  for tag, r in run_stats.stages().items() if "fusion_reason" in r)


@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_on_card_platform_matches_jax(q, tpch_dir, monkeypatch):
    import ballista_tpu.ops.tpu.fusion as jfus
    import ballista_tpu.ops.tpu.pallas_kernels as jpk
    import ballista_tpu.ops.tpu.stage_compiler as jsc
    import ballista_tpu_torch.ops.cuda.cuda_kernels as tck
    import ballista_tpu_torch.ops.cuda.fusion as tfus
    import ballista_tpu_torch.ops.cuda.stage_compiler as tsc

    sides = {}
    for side, pkg, fus, kernels, sc, platform in (
            ("jax", "ballista_tpu", jfus, jpk, jsc, "tpu"),
            ("port", "ballista_tpu_torch", tfus, tck, tsc, "cuda")):
        calls, sorts = {}, []
        _pin_platform(monkeypatch, fus, platform, sorts)
        _count_calls(monkeypatch, kernels, calls)
        # a fresh trace and fresh run records: the reference calls its
        # Pallas functions while it traces a stage
        sc.clear_device_caches()
        sc.RUN_STATS.clear()
        tbl = _run(pkg, tpch_dir, q)
        sides[side] = (tbl, calls, _stage_decisions(sc.RUN_STATS), sorted(sorts))
    (want, jcalls, jstages, jsorts), (got, tcalls, tstages, tsorts) = sides["jax"], sides["port"]
    assert got.schema.equals(want.schema)
    assert got.equals(want)
    assert tcalls == jcalls
    assert tstages == jstages
    assert tsorts == jsorts
    # every partial stage is claimed but q16's and q18's, which decline in
    # both packages at SF0.01 (an empty build side)
    assert bool(tstages) == (q not in (16, 18))
