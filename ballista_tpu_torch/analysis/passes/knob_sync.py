"""knob-sync: config keys and env knobs stay registered AND documented.

Three invariants, each of which has drifted at least once during review:

1. Every `"ballista.*"` string literal used anywhere in the engine is a
   registered `ConfigEntry` (or lives in an open namespace —
   `ballista.catalog.*` / `ballista.udf.*` carry session-shipped
   registrations, not knobs).
2. `docs/configs_torch.md` is exactly what the port's
   `generate_config_docs()` renders — the file is generated
   (`python -m ballista_tpu_torch.analysis.gen_configs`), so any hand edit
   or any registry change without a regen is a finding. This subsumes
   "every registered entry is documented". The port's registry is the JAX
   package's with the import root renamed, and two descriptions name a
   module by that root, so its render is a file of its own beside the JAX
   package's `docs/configs.md`.
3. Every `BALLISTA_*` environment variable the code reads maps to a knob:
   either it is named in a registered entry's description (the env
   escape-hatch convention) or it is a registered `EnvKnob`
   (config.ENV_KNOBS — daemon-only knobs with no session-config
   equivalent, e.g. cache sizing read at import time).
"""

from __future__ import annotations

import ast
import os
import re

from ballista_tpu_torch.analysis.core import AnalysisPass, Analyzer, Finding

_KEY_RE = re.compile(r"^ballista(\.[a-z0-9_]+)+$")
_OPEN_PREFIXES = ("ballista.catalog.", "ballista.udf.")
_ENV_READERS = {"get", "getenv", "_env_bool", "_env_int", "_env_float", "_env_str"}
CONFIG_DOCS_REL = "docs/configs_torch.md"
GEN_CMD = "python -m ballista_tpu_torch.analysis.gen_configs"


def _env_reads(tree: ast.Module):
    """Yields (var_name, lineno) for os.environ / _env_* reads of a
    BALLISTA_* variable. String-literal grep would false-positive on
    constants like BALLISTA_VERSION (a python name, not an env var), so
    only actual read sites count."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = ""
            if isinstance(node.func, ast.Attribute):
                name = node.func.attr
            elif isinstance(node.func, ast.Name):
                name = node.func.id
            if name in _ENV_READERS and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                        and arg.value.startswith("BALLISTA_"):
                    yield arg.value, node.lineno
        elif isinstance(node, ast.Subscript):
            v = node.value
            if isinstance(v, ast.Attribute) and v.attr == "environ":
                s = node.slice
                if isinstance(s, ast.Constant) and isinstance(s.value, str) \
                        and s.value.startswith("BALLISTA_"):
                    yield s.value, node.lineno


class KnobSyncPass(AnalysisPass):
    pass_id = "knob-sync"
    doc = "ballista.* keys registered + documented; BALLISTA_* env reads mapped to knobs"

    def run(self, analyzer: Analyzer) -> list[Finding]:
        from ballista_tpu_torch import config as cfg

        findings: list[Finding] = []
        valid = set(cfg.VALID_ENTRIES)

        # 1. every ballista.* literal is a registered key
        for src in analyzer.collect():
            if src.rel == "ballista_tpu_torch/config.py":  # the registry itself
                continue
            for value, lineno in src.string_literals():
                if not _KEY_RE.match(value):
                    continue
                if value in valid or value.startswith(_OPEN_PREFIXES):
                    continue
                findings.append(Finding(
                    self.pass_id, src.rel, lineno,
                    f'config key "{value}" is not a registered ConfigEntry '
                    f"(register it in config.py or move it under an open namespace)",
                    symbol=value,
                ))

        # 2. the port's config document is exactly the rendered registry
        docs_path = os.path.join(analyzer.root, CONFIG_DOCS_REL)
        expected = cfg.generate_config_docs()
        try:
            with open(docs_path, encoding="utf-8") as f:
                actual = f.read()
        except OSError:
            actual = None
        if actual is None:
            findings.append(Finding(
                self.pass_id, CONFIG_DOCS_REL, 1,
                f"{CONFIG_DOCS_REL} is missing; run `{GEN_CMD}`",
                symbol="<missing>",
            ))
        elif actual != expected:
            findings.append(Finding(
                self.pass_id, CONFIG_DOCS_REL, 1,
                f"{CONFIG_DOCS_REL} is stale vs the config.py registry; "
                f"run `{GEN_CMD}`",
                symbol="<stale>",
            ))

        # 3. every BALLISTA_* env read maps to a knob
        documented_env: set[str] = set()
        for e in cfg.VALID_ENTRIES.values():
            documented_env.update(re.findall(r"BALLISTA_[A-Z0-9_]+", e.description))
        registered_env = set(getattr(cfg, "ENV_KNOBS", {}))
        known = documented_env | registered_env
        seen_reads: set[str] = set()
        for src in analyzer.collect():
            tree = src.tree
            if tree is None:
                continue
            for var, lineno in _env_reads(tree):
                seen_reads.add(var)
                if var in known:
                    continue
                findings.append(Finding(
                    self.pass_id, src.rel, lineno,
                    f"env var {var} is read here but maps to no knob: name it in "
                    f"a ConfigEntry description or register an EnvKnob in config.py",
                    symbol=var,
                ))
        # registered EnvKnobs must correspond to a real read somewhere; the
        # finding sits on the knob's registration, where a suppression can
        # name the reader outside the scan set
        cfg_src = analyzer.file("ballista_tpu_torch/config.py")
        reg_line: dict[str, int] = {}
        if cfg_src is not None:
            for value, lineno in cfg_src.string_literals():
                reg_line.setdefault(value, lineno)
        for var in sorted(registered_env - seen_reads):
            findings.append(Finding(
                self.pass_id,
                cfg_src.rel if cfg_src else "ballista_tpu_torch/config.py",
                reg_line.get(var, 1),
                f"EnvKnob {var} is registered but nothing reads it",
                symbol=f"unused:{var}",
            ))
        return findings
