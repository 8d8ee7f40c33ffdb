"""Regenerate docs/configs_torch.md from the port's config.py registry.

Usage: python -m ballista_tpu_torch.analysis.gen_configs [--check]

--check exits 1 without writing if the committed file is stale (the same
comparison the knob-sync analysis pass runs).
"""

from __future__ import annotations

import os
import sys

from ballista_tpu_torch.analysis.core import repo_root
from ballista_tpu_torch.analysis.passes.knob_sync import CONFIG_DOCS_REL, GEN_CMD
from ballista_tpu_torch.config import generate_config_docs


def main(argv: list[str]) -> int:
    path = os.path.join(repo_root(), CONFIG_DOCS_REL)
    expected = generate_config_docs()
    if "--check" in argv:
        try:
            with open(path, encoding="utf-8") as f:
                actual = f.read()
        except OSError:
            actual = None
        if actual != expected:
            print(f"{path} is stale; run `{GEN_CMD}`", file=sys.stderr)
            return 1
        print(f"{path} is up to date")
        return 0
    with open(path, "w", encoding="utf-8") as f:
        f.write(expected)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
