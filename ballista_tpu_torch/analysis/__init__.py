"""Engine invariant analyzer of the port: static-analysis passes + plan verifier.

Counterpart of the JAX package's analysis/ package. The invariants that
span the whole package are machine-checked: every `ballista.*` knob
registered AND documented, module caches bounded, CPU-side modules never
importing torch or triton at top level, every plan node serde-complete,
RunStats gauges emitted where consumed, no blocking calls on the
scheduler event loop.

- `core`       — the pass framework: shared AST walking, typed `Finding`s,
                 per-line / per-file suppression comments, a checked-in
                 baseline for grandfathered violations (`baseline.json`)
- `passes/`    — the engine-specific passes (see `passes.ALL_PASSES`)
- `plan_check` — the static verifier over staged physical plans and
                 ExecutionGraphs (`verify_stages`, `verify_graph`, the
                 skew-split and lease-band checks) and the postconditions
                 of a grace-split join stage (`verify_grace`)

CLI: `python -m ballista_tpu_torch.analysis` (see `__main__.py`); the
tests are `tests/test_torch_static_analysis.py`.
"""

from ballista_tpu_torch.analysis.core import (  # noqa: F401
    Analyzer,
    AnalysisReport,
    Finding,
    SourceFile,
    load_baseline,
    repo_root,
)
